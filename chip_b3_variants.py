#!/usr/bin/env python3
"""B3 (antrea_tpu_torch/csrc/onepass.cu) against variants of its source.

    python3 chip_b3_variants.py

Needs one CUDA card and nvcc.  Builds the committed kernel and each variant
in VARIANTS (a text edit of onepass.cu) with the package's nvcc flags, all
at once, then on chip_smoke.py's headline world times each against the
others on the one-pass step's all-miss batch (an empty cache) and its warm
batch (the cache after one step), after holding each bitwise against B3's
plain version.  Prints each build's ptxas registers and spills, then the
device times in turns (the list, then the list reversed).  The all-miss
batch is bound by the miss lanes' chains of dependent loads, so it follows
occupancy; the variants trade registers for loads in flight.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke as smoke

SRC = Path(__file__).resolve().parent / "antrea_tpu_torch" / "csrc"
_SCAN = "candidate_scan::scan<true, 1>("
_BOUNDS = "__launch_bounds__(kThreads) onepass_kernel"
# name -> (text in onepass.cu, its replacement); "committed" is unedited.
VARIANTS = {
    "committed": None,
    "2 candidates in flight": (_SCAN, "candidate_scan::scan<true, 2>("),
    "4 candidates in flight": (_SCAN, "candidate_scan::scan<true, 4>("),
    "at most 48 registers": (
        _BOUNDS, "__launch_bounds__(kThreads, 10) onepass_kernel"),
    "at most 40 registers": (
        _BOUNDS, "__launch_bounds__(kThreads, 12) onepass_kernel"),
}


def build_all(tmp: Path) -> dict:
    """-> {name: the loaded b3_onepass entry point}, printing ptxas lines."""
    from antrea_tpu_torch import _build

    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        d = tmp / f"v{i}"
        shutil.copytree(SRC, d)
        if edit is not None:
            text = (d / "onepass.cu").read_text()
            if edit[0] not in text:
                raise SystemExit(f"variant {name!r}: its text is not in "
                                 f"onepass.cu")
            (d / "onepass.cu").write_text(text.replace(edit[0], edit[1]))
        lib = d / "onepass.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "onepass.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} did not build:\n{log}")
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        smoke.log(f"{name}: {'; '.join(ptxas)}")
        fn = ctypes.CDLL(str(lib)).b3_onepass
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_b3_variants: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.utils.timing import device_time

    dev = torch.device("cuda")
    smoke.log(f"card: {smoke.card_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(Path(tmp))
        cps, svc, tr = smoke.build_world()[:3]
        step, state, (drs, dsvc) = pl.make_pipeline(
            cps, svc, flow_slots=smoke.FLOW_SLOTS,
            miss_chunk=smoke.MISS_CHUNK, fused=True,
            prune_budget=smoke.PRUNE_K, ct_timeout_s=3600, device=dev)
        lanes = smoke.to_lanes(tr, dev)
        cases = [("all-miss", 100, smoke.onepass_inputs(
            step, state, drs, dsvc, lanes, 100))]
        state, _ = step(state, drs, dsvc, *lanes, 100, 0)
        cases.append(("warm", 101, smoke.onepass_inputs(
            step, state, drs, dsvc, lanes, 101)))
        names = list(fns)
        try:
            for what, now, (x, tabs, st, _) in cases:
                want = op.onepass_plain(x, tabs, now, 0, st)
                for name in names + names[::-1]:
                    op._fn = fns[name]
                    got = op.onepass(x, tabs, now, 0, st)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise SystemExit(f"{name} disagrees with the plain "
                                         f"version ({what})")
                    t = device_time(lambda: op.onepass(x, tabs, now, 0, st),
                                    iters=9, inner=5, host_lead_s=5 * 2e-4)
                    smoke.log(f"B3 {what}, {name}: {t * 1e6:.2f} us, "
                              f"bitwise equal to plain")
        finally:
            op._fn = None  # the next call loads the committed build
    return 0


if __name__ == "__main__":
    sys.exit(main())
