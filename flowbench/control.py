"""The control of the check, at a cell's own size: the reference with one
stated guarantee broken (reference.datapath's control "slot_hit": a lane
hits whatever entry holds its flow-cache slot, so a packet can take
another flow's cached verdict) in the program's place, judged by the same
comparison as a run.  It needs no program run: the plain replay's answers
stand for a sound program's, and its Service first packets' endpoints
feed the generator's closed loop as a program's would.

    python3 -m flowbench.control --workload <name> --steps <n> --seeds <s>...

prints, per seed, the numbers the check compares for the control; a run's
limits must reject every one of them."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .harness import CHECKED_STEPS, Reservoir, cell_spec, compare, load_bench
from .reference.datapath import Replay
from .stream import Stream
from .world import build_world, plain_world


def control_readings(cfg: dict, mix: dict, seed: int, steps: int,
                     device: str) -> dict:
    """The plain replay over warm-up and `steps` window steps stands for
    the program; the control replay is compared with it as a run is."""
    plain = plain_world(build_world(cfg))
    stream = Stream(mix, plain, seed)
    sound = Replay(plain, device)
    res = Reservoir(seed, CHECKED_STEPS)
    total = stream.warm_steps + steps
    for t in range(stream.warm_steps, total):
        res.offer(t, t)
    keep = set(res.kept)
    n_miss, checked = [], {}
    for t in range(total):
        o = sound.step(sound.lanes(stream.columns(t)), stream.now(t),
                       t in keep or stream.services)
        n_miss.append(o.pop("n_miss"))
        stream.observe(t, o)
        if t in keep:
            checked[t] = o
    rec = dict(plain=plain, stream=stream, total_steps=total, n_miss=n_miss,
               checked=checked)
    return compare(rec, device, replay=Replay(plain, device,
                                              control="slot_hit"))


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="flowbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    root = Path.cwd()
    spec = cell_spec(load_bench(root), a.workload, root)
    for seed in a.seeds:
        t0 = time.perf_counter()
        out = control_readings(spec["config"], spec["mix"], seed, a.steps,
                               "cuda")
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "steps": a.steps, "seconds": time.perf_counter() - t0,
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
