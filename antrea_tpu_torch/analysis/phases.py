"""Pass `phases` — phase-mask drift: pipeline PH_* == profile chains ==
the chains' consumer (the JAX package's pass of the same id, adapted).

The churn profiler's honesty rests on three surfaces staying in
lockstep: the PH_* mask bits in antrea_tpu_torch/models/pipeline.py (with
PH_ALL their OR), the cumulative chains in
antrea_tpu_torch/models/profile.py (each chain starts at 0, grows by
exactly one PH_ bit per entry, ends at PH_ALL, unique names), and the
consumer that reports the profiler's phases taking its phase list FROM
the chain, not from a hand-copied name list.

Adapted: the PH_/chain layers carry over unchanged.  The JAX pass's third
layer reads bench_profile.py, which belongs to the JAX package's
benchmark; the port's consumer of the chains is chip_smoke.py, whose
profile phase (14e) imports models/profile and holds each profile's
reported phase names to `prof.PHASE_CHAIN` / `prof.ASYNC_PHASE_CHAIN`.
That layer reads chip_smoke.py."""

from __future__ import annotations

import re

from .core import Finding, SourceCache, analysis_pass

_PH_DEF = re.compile(r"^(PH_[A-Z0-9_]+)\s*=\s*(.+?)\s*(?:#.*)?$", re.M)
_CHAIN = re.compile(
    r"^(PHASE_CHAIN|ASYNC_PHASE_CHAIN|OVERLAP_PHASE_CHAIN"
    r"|MAINT_PHASE_CHAIN|PRUNE_PHASE_CHAIN|FUSED_PHASE_CHAIN)"
    r"\s*:.*?=\s*\((.*?)^\)",
    re.M | re.S,
)
_ENTRY = re.compile(r'\(\s*"([a-z0-9_]+)"\s*,\s*([^)]*?)\s*\)', re.S)

# The repo-root script that consumes the chains.
CONSUMER = "chip_smoke.py"

REQUIRED_CHAINS = ("PHASE_CHAIN", "ASYNC_PHASE_CHAIN", "OVERLAP_PHASE_CHAIN",
                   "MAINT_PHASE_CHAIN", "PRUNE_PHASE_CHAIN",
                   "FUSED_PHASE_CHAIN")


def parse_ph_bits(src: SourceCache) -> dict:
    """PH_* constants from pipeline.py, numerically evaluated in
    definition order (later definitions may reference earlier ones)."""
    text = src.text(src.pkg / "models" / "pipeline.py") or ""
    bits: dict[str, int] = {}
    for name, expr in _PH_DEF.findall(text):
        try:
            bits[name] = eval(expr, {"__builtins__": {}}, dict(bits))
        except Exception:
            continue  # not a constant definition (e.g. inside a function)
    return bits


def parse_chains(src: SourceCache) -> dict:
    """{chain name: [(entry name, mask int), ...]} from profile.py."""
    text = src.text(src.pkg / "models" / "profile.py") or ""
    bits = parse_ph_bits(src)
    chains: dict[str, list] = {}
    for cname, body in _CHAIN.findall(text):
        entries = []
        for ename, expr in _ENTRY.findall(body):
            expr = expr.strip().rstrip(",")
            try:
                mask = eval(expr.replace("pl.", ""), {"__builtins__": {}},
                            dict(bits))
            except Exception:
                entries.append((ename, None))
                continue
            entries.append((ename, mask))
        chains[cname] = entries
    return chains


@analysis_pass("phases", "PH_* mask bits == profile chains == "
                         "chip_smoke.py's checked phase list")
def check(src: SourceCache) -> list[Finding]:
    pipeline_rel = "antrea_tpu_torch/models/pipeline.py"
    profile_rel = "antrea_tpu_torch/models/profile.py"

    def f(reason, obj, path=profile_rel):
        return Finding("phases", path, 0, reason, obj=obj)

    problems: list[Finding] = []
    bits = parse_ph_bits(src)
    phase_bits = {k: v for k, v in bits.items() if k != "PH_ALL"}
    if "PH_ALL" not in bits:
        return [f("pipeline.py defines no PH_ALL", "no-ph-all", pipeline_rel)]
    union = 0
    for v in phase_bits.values():
        union |= v
    if union != bits["PH_ALL"]:
        problems.append(f(
            f"PH_ALL ({bits['PH_ALL']:#x}) != OR of phase bits ({union:#x})",
            "ph-all-mismatch", pipeline_rel))
    for a, va in phase_bits.items():
        if va & (va - 1):
            problems.append(f(f"{a} ({va:#x}) is not a single bit",
                              f"multi-bit:{a}", pipeline_rel))
        for b, vb in phase_bits.items():
            if a < b and va & vb:
                problems.append(f(
                    f"{a} and {b} overlap ({va:#x} & {vb:#x})",
                    f"overlap:{a}:{b}", pipeline_rel))

    chains = parse_chains(src)
    for required in REQUIRED_CHAINS:
        if required not in chains:
            problems.append(f(f"profile.py defines no {required}",
                              f"missing-chain:{required}"))
    seen_names: set[str] = set()
    for cname, entries in chains.items():
        if not entries:
            problems.append(f(f"{cname} parsed empty", f"empty:{cname}"))
            continue
        names = [n for n, _m in entries]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            problems.append(f(f"{cname}: duplicate phase names {sorted(dup)}",
                              f"dup:{cname}"))
        overlap = seen_names & set(names)
        if overlap:
            problems.append(f(
                f"{cname}: phase names {sorted(overlap)} reused across "
                f"chains (bench/profile consumers key on the name)",
                f"reuse:{cname}"))
        seen_names |= set(names)
        prev = None
        for ename, mask in entries:
            if mask is None:
                problems.append(f(f"{cname}.{ename}: unparseable mask",
                                  f"unparseable:{cname}.{ename}"))
                continue
            if prev is None:
                if mask != 0:
                    problems.append(f(f"{cname} must start at mask 0",
                                      f"start:{cname}"))
            else:
                added = mask & ~prev
                if mask & prev != prev:
                    problems.append(f(
                        f"{cname}.{ename}: mask {mask:#x} is not a superset "
                        f"of its predecessor {prev:#x}",
                        f"superset:{cname}.{ename}"))
                if added == 0 or added & (added - 1):
                    problems.append(f(
                        f"{cname}.{ename}: must add exactly one PH_ bit "
                        f"(adds {added:#x})", f"one-bit:{cname}.{ename}"))
            prev = mask
        if prev != bits["PH_ALL"]:
            problems.append(f(
                f"{cname} ends at {prev:#x}, not PH_ALL "
                f"({bits['PH_ALL']:#x}) — a PH_ bit has no phase entry",
                f"end:{cname}"))

    consumer = src.text(src.root / CONSUMER) or ""
    if not re.search(r"from antrea_tpu_torch\.models import (.*\b)?profile"
                     r"\b|from antrea_tpu_torch\.models\.profile import "
                     r".*PHASE_CHAIN", consumer):
        problems.append(f(f"{CONSUMER} does not import models/profile's "
                          f"chains", "consumer-import", CONSUMER))
    if not re.search(r"\bprof(?:ile)?\.PHASE_CHAIN\b", consumer):
        problems.append(f(
            f"{CONSUMER} does not hold its profiles' reported phases to "
            f"profile.PHASE_CHAIN", "consumer-derive", CONSUMER))
    return problems
