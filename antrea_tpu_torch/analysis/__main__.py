"""The port's static-analysis runner: every drift gate, one invocation.

    python -m antrea_tpu_torch.analysis [--pass ID [--pass ID ...]] [--json]
                                        [--list] [--root PATH]

Runs the registered passes over the repo's antrea_tpu_torch/, applies the
BASELINE.analysis_torch.json suppressions, and exits 0 only when every pass
is clean and the baseline is not stale.  `--json` emits one
machine-readable findings report on stdout; `--list` prints the pass
inventory.  Stdlib-only: it runs on images without torch."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import PASSES, REPO, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pass", dest="passes", action="append", metavar="ID",
                    help="run only this pass (repeatable); default: all")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable findings report")
    ap.add_argument("--list", action="store_true",
                    help="print the pass inventory and exit")
    ap.add_argument("--root", type=pathlib.Path, default=REPO,
                    help="tree to analyze (default: this repo)")
    args = ap.parse_args(argv)

    if args.list:
        for pid, (_fn, invariant) in PASSES.items():
            print(f"{pid:18s} {invariant}")
        return 0

    try:
        result = run(args.root, args.passes)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(result.to_json(), indent=1))
        return 0 if result.clean else 1

    for f in result.findings:
        print(f.render())
    for e in result.errors:
        print(f"DRIFT[baseline] {e}")
    if not result.clean:
        print(f"\nanalysis: {len(result.findings)} finding(s), "
              f"{len(result.errors)} baseline error(s) across "
              f"{len(result.pass_ids)} passes")
        return 1
    suppressed = (f" ({len(result.suppressed)} baselined)"
                  if result.suppressed else "")
    print(f"analysis clean: {len(result.pass_ids)} passes{suppressed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
