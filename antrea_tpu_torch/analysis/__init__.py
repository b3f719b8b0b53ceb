"""The port's static-analysis plane: one AST engine, every drift gate, over
antrea_tpu_torch/.

Public surface:

  run(root=REPO, pass_ids=None) -> RunResult   the whole suite (or a
                                               subset), baseline applied
  run_cli(pass_id, argv) -> int                one pass on its own
  PASSES                                       id -> (fn, invariant)

  python -m antrea_tpu_torch.analysis [--pass ID ...] [--json] [--list]
                                      [--root PATH]

Everything is stdlib-only (ast/re/json): importing this subpackage loads
neither torch nor jax nor anything of the JAX package, so every gate runs
on any CI image.  The baseline is BASELINE.analysis_torch.json at the repo
root.  See core.py for the engine contract (SourceCache, Finding,
allowlists, baseline).

Every pass of the JAX package's analysis plane (antrea_tpu/analysis/),
and what the port does with it:

  mesh                adapted: the port has no PartitionSpecs; each field
                      of the rule-set NamedTuples (ops/match.py) is cut by
                      keyword in parallel/mesh.rule_slice, rejoined by
                      rule_join, or declared in MESH_REPLICATED
  metrics             adapted: the metric-name pattern skips the package
                      name antrea_tpu_torch (and its module paths)
  phases              adapted: the chain's consumer is chip_smoke.py,
                      which holds each profile's phases to the chains;
                      bench_profile.py belongs to the JAX benchmark
  events              carried over
  commit-plane        carried over
  audit-plane         carried over
  maintenance         carried over
  reshard             adapted: every field of FlowCache / AffinityTable is
                      per replica (the port has no P(DATA, ...) specs) and
                      needs a RESHARD_MANIFEST row; world fields assigned
                      from the port's state builders need WORLD_MIGRATION
  tenant              carried over
  thread-safety       carried over
  bounded-cache       adapted: a cache retains an executable when it loads
                      a built kernel library, captures a CUDA graph or
                      calls torch.compile
  jit-purity          adapted as host-sync: the port's step is eager, so
                      the class is an undeclared device->host sync in the
                      step's device code (models/, ops/), held against
                      each module's HOST_SYNCS, and on the card by the
                      sync census of chip_smoke.py's phase 21
  donation-safety     left out: the port donates nothing; its steps
                      update their state in place by design
                      (models/pipeline.clone_state), so a read after the
                      step is meant to see the new values, and the JAX
                      rule (tainted until rebound) would flag correct code
  bounded-buffer      carried over
  telemetry-registry  adapted: a kernel site is a quoted "tel_<name>" key
                      or a tel_<name>= keyword
  canonical-shape     carried over: the grids of the hand-written kernels,
                      and any later graph capture, follow the batch shape
"""

from .core import (  # noqa: F401
    BASELINE_NAME,
    Finding,
    PASSES,
    REPO,
    RunResult,
    SourceCache,
    analysis_pass,
    load_baseline,
    run,
    run_cli,
)

# Importing the pass modules registers them (registration order is the
# run order: the JAX package's order, host-sync in jit-purity's place).
from . import (  # noqa: E402,F401
    mesh,
    metrics,
    phases,
    events,
    commit_plane,
    audit_plane,
    maintenance,
    reshard,
    tenant,
    threads,
    caches,
    host_sync,
    bounded_buffer,
    telemetry,
    canonical_shape,
)

__all__ = [
    "BASELINE_NAME", "Finding", "PASSES", "REPO", "RunResult",
    "SourceCache", "analysis_pass", "load_baseline", "run", "run_cli",
]
