"""Rank bodies of tests/test_torch_mesh.py.  The mesh's ranks are spawned
processes that import this module by name, so it imports the PyTorch port
and nothing of jax: the parent builds the world and the lanes and hands
them over as arguments."""

from antrea_tpu_torch.parallel import mesh as pm


def _np(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def run(mesh, world, cases):
    """Run each case on this rank's shard -> one result per case.

    world: dict(cps, svc, ft) of the port's compiled tables.  A case is
    (kind, builder keywords, steps): "classify" (make_sharded_classifier;
    a step is the (src_f, dst_f, proto, dport) columns) -> the step
    outputs; "pipeline" (make_sharded_pipeline; a step is (the five tuple
    columns, now)) and "full" (make_sharded_pipeline_full; a step is (the
    five tuple columns, in_port, flags, arp_op, now)) -> (the step
    outputs, this data shard's final state with a leading axis of 1)."""
    res = []
    for kind, kw, steps in cases:
        if kind == "classify":
            fn, _ = pm.make_sharded_classifier(world["cps"], mesh, **kw)
            res.append([_np(fn(*cols)) for cols in steps])
            continue
        if kind == "pipeline":
            step, state, tabs = pm.make_sharded_pipeline(
                world["cps"], world["svc"], mesh, **kw)
        else:
            step, state, tabs = pm.make_sharded_pipeline_full(
                world["cps"], world["svc"], world["ft"], mesh, **kw)
        outs = []
        for *cols, now in steps:
            state, out = step(state, *tabs, *cols, now, 0)
            outs.append(_np(out))
        res.append((outs, pm.gather_state([state])))
    return res
