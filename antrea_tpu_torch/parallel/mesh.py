"""The (data x rule) sharded datapath step on torch.distributed: the port of
the functional layer of antrea_tpu/parallel/mesh.py, one process per shard.

  data axis: the packet-batch axis.  Data shard d steps its contiguous
      slice of the batch against a private flow cache and affinity table.
  rule axis: the rule-word axis.  Rule shard r holds word slice r of every
      incidence table (and of the aggregate level under pruning); its
      first-match indices are global (the kernels add the slice's first
      word, word_idx[0]) and are combined over the rule shards of a data
      row by one all-reduce MIN (_pmin_rule), the hit_combine seam of
      ops/match.classify_batch and models/pipeline.pipeline_step.

Rank d * n_rule + r holds shard (d, r), the row-major layout of the JAX
mesh.  Interval bounds, isolation, actions, service and forwarding tables
are replicated.  Verdicts after the combine are the same on every rule
shard of a row, so the state each of them updates stays replicated over
the rule axis by construction.

A step reads this rank's fallback lanes and round counts back to the host.
Those depend only on the shard's own tables and on the state and lanes,
which the ranks of a row share, except the fallback lanes of the pruned
walk, which are shard-local: no collective runs inside a branch on them.
Every rank of a row runs the same collectives in the same order.

On the card a one-process world uses NCCL; several ranks that share one
card use gloo, which all-reduces CUDA tensors through the host (NCCL
refuses two ranks on one device).  The CPU tests use gloo.  spawn() starts
a group with a file store in a temporary directory, never a fixed port.

The mesh engine (parallel/meshpath.py) holds a whole mesh in one process
on one device instead (LocalMesh): every data replica keeps its own copy of
every rule shard (RuleGrid) and its own state, and the rule shards of a data
row run in n_rule threads that meet at each combine (run_rule_group), which
returns the same elementwise minimum as _pmin_rule.  Each rule shard steps
its own copy of the row's state, so no two threads write one tensor; the
copies stay equal because every shard computes the same writes from the
same combined hits.
"""

from __future__ import annotations

import os
import tempfile
import threading
import traceback
from functools import lru_cache, reduce
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.compile import CompiledPolicySet
from ..compiler.services import ServiceTables
from ..compiler.topology import ForwardingTables
from ..models import forwarding as fw
from ..models import pipeline as pl
from ..ops import match as m

# Shard-affinity hash (the host routing of the multichip traffic path): a
# deterministic, direction-symmetric 5-tuple -> data-shard map, salted apart
# from the cache-slot hash so shard id and slot index stay decorrelated.
SHARD_AFFINITY_SALT = 0x6D657368  # "mesh"
# Consistent-ring salt (elastic resharding): the virtual-point layout.
SHARD_RING_SALT = 0x72696E67  # "ring"
# Virtual points per data shard on the consistent ring.
RING_VNODES = 128

_FNV_PRIME = 16777619
_FNV_BASIS = 0x811C9DC5


def _fnv_mix(words) -> np.ndarray:
    """FNV-1a over u32 word arrays with an xorshift after each word (the
    JAX package's hashing.fnv_mix on numpy) -> u32 hash."""
    with np.errstate(over="ignore"):
        h = None
        for w in words:
            w = np.asarray(w).astype(np.uint32)
            if h is None:
                h = np.full_like(w, _FNV_BASIS, dtype=np.uint32)
            h = (h ^ w) * np.uint32(_FNV_PRIME)
            h = h ^ (h >> np.uint32(15))
    return h


@lru_cache(maxsize=32)
def _ring(n_data: int):
    """The consistent-hash ring of a data-axis size: (points, owners),
    points ascending.  Each shard's RING_VNODES points depend only on
    (shard, vnode), so a resize moves only the keys of the points added or
    removed."""
    ids = np.arange(n_data * RING_VNODES, dtype=np.uint32)
    with np.errstate(over="ignore"):
        # Golden-ratio pre-scramble: FNV over small sequential ints clusters
        # in u32 order.
        pts = _fnv_mix([ids * np.uint32(0x9E3779B9),
                        np.full(ids.shape, SHARD_RING_SALT, np.uint32)])
    order = np.argsort(pts, kind="stable")
    return pts[order], (ids[order] // np.uint32(RING_VNODES)).astype(np.int32)


def _tuple_hash(src_ip, dst_ip, proto, sport, dport):
    """The direction-symmetric 5-tuple key hash behind shard_of_tuples."""
    ea = _fnv_mix([np.asarray(src_ip), np.asarray(sport)])
    eb = _fnv_mix([np.asarray(dst_ip), np.asarray(dport)])
    with np.errstate(over="ignore"):
        return _fnv_mix([np.minimum(ea, eb), np.maximum(ea, eb),
                         np.asarray(proto).astype(np.uint32)
                         ^ np.uint32(SHARD_AFFINITY_SALT)])


def shard_of_tuples(src_ip, dst_ip, proto, sport, dport, n_data: int,
                    topo_gen: int = 0, tenant: int = 0):
    """Host-side (numpy) data-shard assignment of a batch of 5-tuples
    (mesh.py:185): symmetric under direction reversal.  Generation 0 (the
    boot topology) is the dense mod map; a resized topology (topo_gen >= 1)
    elects owners on the consistent ring.  tenant folds the policy world's
    id into the key (0 leaves the hash unchanged)."""
    h = _tuple_hash(src_ip, dst_ip, proto, sport, dport)
    if tenant:
        with np.errstate(over="ignore"):
            h = _fnv_mix([h, np.full(h.shape, np.uint32(int(tenant))
                                     * np.uint32(0x9E3779B9), np.uint32)])
    if topo_gen == 0:
        return (h % np.uint32(n_data)).astype(np.int32)
    pts, owners = _ring(int(n_data))
    i = np.searchsorted(pts, h, side="right") % len(pts)
    return owners[i]


def _shard_placement(shard: np.ndarray, n_data: int):
    """Batch lanes -> mesh slots under the shard-affinity hash
    (meshpath.py:292).

    Every packet whose home shard has free capacity (B / D lanes per
    shard) lands in its home slice; hash-skew overflow packets SPILL into
    other shards' free slots and are flagged (the caller classifies them
    with no_commit, so a foreign shard never caches a stray flow).

    -> (perm, inv, spill): perm maps slot -> packet index, inv maps
    packet -> slot, spill flags slots holding an off-home packet."""
    B = shard.size
    C = B // n_data
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_data)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    perm = np.empty(B, np.int64)
    spill = np.zeros(B, bool)
    leftovers, free = [], []
    for r in range(n_data):
        seg = order[bounds[r]:bounds[r + 1]]
        home = min(seg.size, C)
        perm[r * C:r * C + home] = seg[:home]
        if home < C:
            free.append(np.arange(r * C + home, (r + 1) * C))
        if seg.size > home:
            leftovers.append(seg[home:])
    if leftovers:
        lv = np.concatenate(leftovers)
        fs = np.concatenate(free)[:lv.size]  # conservation: |free| == |left|
        perm[fs] = lv
        spill[fs] = True
    inv = np.empty(B, np.int64)
    inv[perm] = np.arange(B)
    return perm, inv, spill


class Mesh(NamedTuple):
    """This rank's place in an n_data x n_rule mesh."""

    n_data: int
    n_rule: int
    d: int  # data shard (row)
    r: int  # rule shard (column)
    rule_group: object  # the ProcessGroup of row d's n_rule ranks
    device: torch.device


def make_mesh(n_data: int, n_rule: int, device=None) -> Mesh:
    """This rank's mesh facts, in an initialized process group of
    n_data * n_rule ranks (rank d * n_rule + r holds shard (d, r)).  Every
    rank creates every row's rule group, in the same order (new_group is
    collective).  device None means the card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    need = n_data * n_rule
    if dist.get_world_size() != need:
        raise ValueError(f"a {n_data} x {n_rule} mesh needs {need} ranks, "
                         f"the group has {dist.get_world_size()}")
    d, r = divmod(dist.get_rank(), n_rule)
    groups = [dist.new_group([row * n_rule + c for c in range(n_rule)])
              for row in range(n_data)]
    return Mesh(n_data, n_rule, d, r, groups[d], m.resolve_device(device))


def _pmin_rule(group, h: torch.Tensor) -> torch.Tensor:
    """hit_combine over a rule group: the elementwise minimum of h (B, n)
    int32 over the group's ranks, in a new tensor (one all-reduce)."""
    out = h.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


class RuleCombine(NamedTuple):
    """The hit_combine of a rank's rule group (ops/match.classify_batch's
    seam): calling it on a (B, n) int32 tensor gives the elementwise
    minimum over the group (_pmin_rule); w0 = (w0_in, w0_out) is the
    global index of the shard's first word per direction, taken from the
    host tables once, so no step reads it back from the card."""

    group: object
    w0: tuple

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return _pmin_rule(self.group, h)


def rule_combine(mesh: Mesh, w0: tuple) -> RuleCombine:
    """The hit_combine of this rank's rule group, for a shard whose first
    words are w0 (first_words of its host tables)."""
    return RuleCombine(mesh.rule_group, tuple(int(w) for w in w0))


def first_words(drs_np: m.DeviceRuleSet) -> tuple[int, int]:
    """(w0_in, w0_out): the global index of a (host) rule shard's first
    word per direction, word_idx[0]."""
    return (int(drs_np.ingress.word_idx[0]), int(drs_np.egress.word_idx[0]))


# ---- the in-process mesh (the mesh engine) -------------------------------


# The logical device pool of an in-process mesh: one card hosts this many
# virtual devices, as the JAX package's make_mesh falls back to the virtual
# CPU platform on a single-accelerator host (its tests force 8).  A shard's
# device is a logical id in range(DEVICE_POOL); every id lies on the mesh's
# one device.  Resharding names target devices by these ids, and a mesh
# wider than the pool is refused as JAX refuses one wider than its devices.
DEVICE_POOL = 8


class LocalMesh(NamedTuple):
    """An n_data x n_rule mesh held by one process: every shard's tensors
    lie on `device`.  `devices` holds the shards' logical device ids, row
    d the ids of data replica d's rule shards; None stands for the pool's
    first n_data * n_rule ids in row-major order (mesh_devices)."""

    n_data: int
    n_rule: int
    device: torch.device
    devices: Optional[tuple] = None


def mesh_devices(mesh: LocalMesh) -> np.ndarray:
    """The mesh's logical device ids as an (n_data, n_rule) int array."""
    if mesh.devices is None:
        return np.arange(mesh.n_data * mesh.n_rule).reshape(mesh.n_data,
                                                            mesh.n_rule)
    return np.asarray(mesh.devices, np.int64).reshape(mesh.n_data,
                                                      mesh.n_rule)


def local_mesh(n_data: int, n_rule: int, device=None,
               devices=None) -> LocalMesh:
    """The in-process mesh of n_data x n_rule shards on `device` (None: the
    card; raises without CUDA), on the first n_data * n_rule of `devices`
    (logical ids; None: the pool, range(DEVICE_POOL)).  Raises the JAX
    package's make_mesh ValueError when there are too few."""
    if int(n_data) < 1 or int(n_rule) < 1:
        raise ValueError(f"a mesh needs n_data, n_rule >= 1, got "
                         f"({n_data}, {n_rule})")
    n_data, n_rule = int(n_data), int(n_rule)
    need = n_data * n_rule
    pool = (list(range(DEVICE_POOL)) if devices is None
            else [int(x) for x in np.asarray(devices).reshape(-1)])
    if len(pool) < need:
        raise ValueError(f"need {need} devices, have {len(pool)}")
    ids = tuple(tuple(pool[d * n_rule:(d + 1) * n_rule])
                for d in range(n_data))
    if pool[:need] == list(range(need)):
        ids = None  # the canonical form of the pool's prefix
    return LocalMesh(n_data, n_rule, m.resolve_device(device), ids)


class IdentityCombine(NamedTuple):
    """The hit_combine of a one-shard rule axis: the minimum over one shard
    is its own hits.  Passing it (and not None) keeps the mesh step on the
    rule shard's path, as the JAX mesh passes _pmin_rule at n_rule = 1: the
    one-pass step then runs B3's hits-only variant."""

    w0: tuple = (0, 0)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return h


class _RuleGroup:
    """Where the n_rule threads of one data row meet: each combine deposits
    a shard's (B, n) hits, waits for the others, and takes the elementwise
    minimum of all n; a second barrier keeps the slots until every shard
    has read them.  Every shard of a row makes the same combines in the
    same order (the module docstring's rule), so the calls pair up."""

    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n)

    def pmin(self, r: int, h: torch.Tensor) -> torch.Tensor:
        self.slots[r] = h.contiguous()
        self.barrier.wait()
        out = reduce(torch.minimum, self.slots)
        self.barrier.wait()
        return out


class LocalCombine(NamedTuple):
    """The hit_combine of rule shard r of an in-process rule group, with
    the shard's first words w0 (as RuleCombine)."""

    group: _RuleGroup
    r: int
    w0: tuple

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return self.group.pmin(self.r, h)


def run_rule_group(w0s, fn) -> list:
    """fn(r, combine) for each rule shard r of one data row -> the results,
    by shard.  w0s[r] is shard r's first words.  One shard runs in this
    thread with the identity combine; n > 1 shards run in n threads (shard
    0 in this one) joined by a _RuleGroup.  A failing shard breaks the
    group's barrier, so the others stop at their next combine; the first
    failure is raised."""
    n = len(w0s)
    if n == 1:
        return [fn(0, IdentityCombine(tuple(w0s[0])))]
    group = _RuleGroup(n)
    results: list = [None] * n
    errors: list = []

    def body(r):
        try:
            results[r] = fn(r, LocalCombine(group, r, tuple(w0s[r])))
        except BaseException as e:  # raised below, after the join
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(1, n)]
    for t in threads:
        t.start()
    body(0)
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results


class RuleGrid(NamedTuple):
    """The rule tables of an in-process mesh: rows[d][r] is data replica
    d's own copy of rule shard r (a DeviceRuleSet), w0[r] the shard's first
    words (first_words)."""

    rows: tuple
    w0: tuple


def place_rule_grid(drs_np: m.DeviceRuleSet, mesh: LocalMesh) -> RuleGrid:
    """A numpy rule set built with word_multiple = mesh.n_rule -> its
    RuleGrid on mesh.device: each rule shard uploaded once, then copied on
    the device for every further data replica."""
    slices = [rule_slice(drs_np, mesh.n_rule, r) for r in range(mesh.n_rule)]
    first = tuple(m.ruleset_from_numpy(sl, mesh.device) for sl in slices)
    rows = (first,) + tuple(
        tuple(m.tree_map(torch.clone, x) for x in first)
        for _ in range(1, mesh.n_data))
    return RuleGrid(rows, tuple(first_words(sl) for sl in slices))


def rule_join(shards) -> m.DeviceRuleSet:
    """One data replica's rule shards (rule order) -> the whole rule set:
    rule_slice's inverse, the sharded tables concatenated on their trailing
    axis, the replicated ones taken from shard 0."""
    def cat(get):
        return torch.cat([get(s) for s in shards], dim=-1)

    def dim(name, d):
        t = getattr(getattr(shards[0], d), name)
        agg = None if t.agg is None else cat(
            lambda s: getattr(getattr(s, d), name).agg)
        return t._replace(inc=cat(lambda s: getattr(getattr(s, d), name).inc),
                          agg=agg)

    def direction(d):
        return getattr(shards[0], d)._replace(
            at=dim("at", d), peer=dim("peer", d), svc=dim("svc", d),
            word_idx=cat(lambda s: getattr(s, d).word_idx))

    dl = shards[0].ip_delta
    return shards[0]._replace(
        ingress=direction("ingress"), egress=direction("egress"),
        ip_delta=dl._replace(**{f: cat(lambda s, f=f: getattr(s.ip_delta, f))
                                for f in ("at_in", "peer_in", "at_out",
                                          "peer_out")}))


# ---- placement -----------------------------------------------------------


def _cols(a, n: int, i: int):
    """Slice i of n along the trailing axis."""
    w = a.shape[-1]
    if w % n:
        raise ValueError(f"width {w} does not split into {n} rule shards")
    k = w // n
    return a[..., i * k:(i + 1) * k]


def rule_slice(drs_np: m.DeviceRuleSet, n_rule: int, r: int):
    """Rule shard r of a numpy rule set built with word_multiple = n_rule
    (mesh.py:262-306): incidence and aggregate tables split on their
    trailing (word / superblock) axis, word_idx split, the delta slots'
    rule masks split; bounds, isolation, actions and L7 marks replicated.
    Under pruning the width is a multiple of n_rule * AGG_BLOCK words, so
    each slice's superblocks cover exactly its own words."""
    def dim(t):
        return t._replace(inc=_cols(t.inc, n_rule, r),
                          agg=None if t.agg is None
                          else _cols(t.agg, n_rule, r))

    def direction(dd):
        return dd._replace(at=dim(dd.at), peer=dim(dd.peer), svc=dim(dd.svc),
                           word_idx=_cols(dd.word_idx, n_rule, r))

    dl = drs_np.ip_delta
    return drs_np._replace(
        ingress=direction(drs_np.ingress), egress=direction(drs_np.egress),
        ip_delta=dl._replace(**{f: _cols(getattr(dl, f), n_rule, r) for f in
                                ("at_in", "peer_in", "at_out", "peer_out")}))


def host_rule_set(cps: CompiledPolicySet, n_rule: int, prune_budget: int = 0):
    """The whole numpy rule set of an n_rule-wide mesh (to_host with
    word_multiple = n_rule) -> (DeviceRuleSet of numpy, StaticMeta); the
    meta is the whole set's.  rule_slice cuts a rank's share from it."""
    return m.to_host(cps, word_multiple=n_rule, prune_budget=prune_budget)


def _shard_rules(cps: CompiledPolicySet, mesh: Mesh, prune_budget: int):
    """shard_rule_set and the shard's first_words, from one host build."""
    drs_np, meta = host_rule_set(cps, mesh.n_rule, prune_budget)
    sl = rule_slice(drs_np, mesh.n_rule, mesh.r)
    return m.ruleset_from_numpy(sl, mesh.device), meta, first_words(sl)


def shard_rule_set(cps: CompiledPolicySet, mesh: Mesh, prune_budget: int = 0):
    """This rank's rule shard on mesh.device -> (DeviceRuleSet, StaticMeta)."""
    return _shard_rules(cps, mesh, prune_budget)[:2]


def shard_state(state_np, mesh: Mesh) -> pl.PipelineState:
    """Data shard mesh.d's private flow and affinity tables on mesh.device,
    from a numpy state whose leaves have a leading (n_data,) axis (the JAX
    mesh's layout: jax.device_get of its sharded state)."""
    return pl.state_from_numpy(
        m.tree_map(lambda a: np.asarray(a)[mesh.d], state_np), mesh.device)


def gather_state(states) -> pl.PipelineState:
    """Per-data-shard states (data shard order, any device) -> one numpy
    state whose leaves have a leading (n_data,) axis: shard_state's
    inverse."""
    def stack(parts, cls):
        return cls(*(np.stack([p[i].cpu().numpy() for p in parts])
                     for i in range(len(cls._fields))))

    return pl.PipelineState(
        flow=stack([s.flow for s in states], pl.FlowCache),
        aff=stack([s.aff for s in states], pl.AffinityTable))


def _lanes(mesh: Mesh, cols):
    """This rank's contiguous data slice of global (B,) lane columns
    (tensors or numpy), as int32 tensors on mesh.device."""
    out = []
    for c in cols:
        c = torch.as_tensor(c)
        b = c.shape[0]
        if b % mesh.n_data:
            raise ValueError(f"a batch of {b} lanes does not split into "
                             f"{mesh.n_data} data shards")
        k = b // mesh.n_data
        out.append(c[mesh.d * k:(mesh.d + 1) * k].to(
            device=mesh.device, dtype=torch.int32).contiguous())
    return out


# Per-data-shard counters: a scalar per shard becomes a (1,) vector, so
# gather_outputs lays them out as (n_data,) (the histogram (n_data, H)),
# as the JAX mesh's finish() does (mesh.py:458-467).
_COUNTERS = ("n_miss", "n_evict", "n_reclaim", "n_prune_skips", "n_prune_fb",
             "prune_cand_hist")


def _finish(out: dict) -> dict:
    for k in _COUNTERS:
        if k in out:
            out[k] = out[k][None]
    return out


def gather_outputs(outs) -> dict:
    """The outputs of one rank of each data row (data shard order) -> the
    global outputs: lane outputs concatenated to (B,), counters to
    (n_data,) (the candidate histogram to (n_data, H)), as numpy."""
    return {k: np.concatenate([np.asarray(o[k].cpu() if isinstance(
        o[k], torch.Tensor) else o[k]) for o in outs]) for k in outs[0]}


def make_sharded_classifier(cps: CompiledPolicySet, mesh: Mesh,
                            prune_budget: int = 0):
    """Stateless sharded classification -> (fn(src_f, dst_f, proto, dport),
    drs).  fn takes the global (B,) columns (B divisible by n_data) and
    classifies this rank's data slice (classify_batch, unfused, as the JAX
    package's); the combine makes its result the same on every rule shard
    of the row.  prune_budget > 0 runs the pruned walk per shard."""
    drs, meta, w0 = _shard_rules(cps, mesh, prune_budget)
    combine = rule_combine(mesh, w0)

    def fn(src_f, dst_f, proto, dport):
        return m.classify_batch(drs, *_lanes(mesh, (src_f, dst_f, proto,
                                                    dport)),
                                meta=meta, hit_combine=combine)

    return fn, drs


def _build_sharded_step(cps, svc, mesh, ft, flow_slots, aff_slots,
                        ct_timeout_s, miss_chunk, fused=False,
                        prune_budget=0, onepass=False):
    """The shared builder behind make_sharded_pipeline[_full] (mesh.py:428):
    capacity check, placement, meta and this data shard's state."""
    pl.check_rule_capacity(cps)
    drs, match_meta, w0 = _shard_rules(cps, mesh, prune_budget)
    dsvc = pl.svc_to_device(svc, mesh.device)
    dft = None if ft is None else fw.fwd_to_device(ft, mesh.device)
    meta = pl.PipelineMeta(
        match=match_meta, flow_slots=flow_slots, aff_slots=aff_slots,
        ct_timeout_s=ct_timeout_s, miss_chunk=miss_chunk, fused=fused,
        onepass=bool(onepass))
    state = pl.init_state(flow_slots, aff_slots, device=mesh.device)
    combine = rule_combine(mesh, w0)

    if ft is None:
        def step(state, drs, dsvc, src_f, dst_f, proto, sport, dport, now,
                 gen):
            state, out = pl.pipeline_step(
                state, drs, dsvc,
                *_lanes(mesh, (src_f, dst_f, proto, sport, dport)), now, gen,
                meta=meta, hit_combine=combine)
            return state, _finish(out)
    else:
        def step(state, drs, dsvc, dft, src_f, dst_f, proto, sport, dport,
                 in_port, flags, arp_op, now, gen):
            src_f, dst_f, proto, sport, dport, in_port, flags, arp_op = (
                _lanes(mesh, (src_f, dst_f, proto, sport, dport, in_port,
                              flags, arp_op)))
            state, out = fw.pipeline_step_full(
                state, drs, dsvc, dft, src_f, dst_f, proto, sport, dport,
                in_port, now, gen, flags, arp_op, meta=meta,
                hit_combine=combine)
            return state, _finish(out)

    step.meta = meta
    return step, state, drs, dsvc, dft


def make_sharded_pipeline(
    cps: CompiledPolicySet,
    svc: ServiceTables,
    mesh: Mesh,
    *,
    flow_slots: int = 1 << 20,
    aff_slots: int = 1 << 18,
    ct_timeout_s: int = 3600,
    miss_chunk: int = 4096,
    fused: bool = False,
    prune_budget: int = 0,
    onepass: bool = False,
):
    """The stateful datapath step of this rank's shard -> (step, state,
    (drs, dsvc)); step(state, drs, dsvc, src_f, dst_f, proto, sport, dport,
    now, gen) -> (state, out) takes the global (B,) columns and steps this
    data shard's slice against its private state (updated in place), like
    models.pipeline.make_pipeline's step; out holds the slice's outputs and
    the shard's counters as (1,) vectors (gather_outputs joins the rows).

    The slow path runs the staged rounds, as the JAX package's
    make_sharded_pipeline does; onepass=True (with fused and
    prune_budget > 0, else the first step raises ValueError) selects the
    one-pass slow path, B3's hits-only variant on a rule shard, as the JAX
    package's mesh engine does with PipelineMeta.onepass
    (parallel/meshpath.py)."""
    step, state, drs, dsvc, _ = _build_sharded_step(
        cps, svc, mesh, None, flow_slots, aff_slots, ct_timeout_s,
        miss_chunk, fused=fused, prune_budget=prune_budget, onepass=onepass)
    return step, state, (drs, dsvc)


def make_sharded_pipeline_full(
    cps: CompiledPolicySet,
    svc: ServiceTables,
    ft: ForwardingTables,
    mesh: Mesh,
    *,
    flow_slots: int = 1 << 20,
    aff_slots: int = 1 << 18,
    ct_timeout_s: int = 3600,
    miss_chunk: int = 4096,
    fused: bool = False,
    prune_budget: int = 0,
    onepass: bool = False,
):
    """The full per-packet walk (models/forwarding.pipeline_step_full) of
    this rank's shard, the production multi-chip step -> (step, state,
    (drs, dsvc, dft)); step(state, drs, dsvc, dft, src_f, dst_f, proto,
    sport, dport, in_port, flags, arp_op, now, gen) -> (state, out), the
    lane columns global (B,) as in make_sharded_pipeline (flags / arp_op
    zeros where absent).  Forwarding is per packet over replicated tables;
    the rule axis takes part only in the classification's combine.  The
    slow path is staged unless onepass=True, as in make_sharded_pipeline."""
    step, state, drs, dsvc, dft = _build_sharded_step(
        cps, svc, mesh, ft, flow_slots, aff_slots, ct_timeout_s, miss_chunk,
        fused=fused, prune_budget=prune_budget, onepass=onepass)
    return step, state, (drs, dsvc, dft)


# ---- process groups ------------------------------------------------------


def default_backend(device, world_size: int) -> str:
    """gloo on the CPU; on the card NCCL for a one-process world, gloo for
    several ranks (they share the one card, which NCCL refuses)."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and world_size == 1 else "gloo"


def _rank_main(fn, rank, n_data, n_rule, store, backend, device, threads,
               args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=n_data * n_rule, rank=rank)
        try:
            res = fn(make_mesh(n_data, n_rule, device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, res))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


# How long spawn() waits for the next rank's result.
_SPAWN_TIMEOUT_S = 600


def spawn(fn, n_data: int, n_rule: int, args=(), *, device=None,
          threads: Optional[int] = None) -> list:
    """Run fn(mesh, *args) in n_data * n_rule new processes, one per shard,
    joined by a process group over a file store in a temporary directory
    -> the ranks' return values, by rank.  The ranks' tensors lie on
    `device` (None: the card).  fn must be importable by name (a
    module-level function) and its return value picklable.  threads sets
    each rank's torch thread count.  Raises with the rank's traceback if
    any rank fails, and stops every rank it started."""
    import queue

    import torch.multiprocessing as mp

    device = m.resolve_device(device)
    world = n_data * n_rule
    backend = default_backend(device, world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, n_data, n_rule, store, backend, str(device), threads,
            tuple(args), results), daemon=True) for rank in range(world)]
        for p in procs:
            p.start()
        got, err = {}, None
        try:
            while len(got) < world and err is None:
                try:
                    rank, ok, res = results.get(timeout=_SPAWN_TIMEOUT_S)
                except queue.Empty:
                    err = f"no result from the mesh in {_SPAWN_TIMEOUT_S} s"
                    break
                if ok:
                    got[rank] = res
                else:
                    err = f"rank {rank} failed:\n{res}"
        finally:
            for p in procs:
                p.join(timeout=0 if err else 60)
                if p.is_alive():
                    p.terminate()
                    p.join()
        if err:
            raise RuntimeError(err)
    return [got[r] for r in range(world)]
