"""Agent process: consumes a serialized watch stream on stdin.

The remote half of dissemination/transport.py — an antrea-agent-shaped
process (ref cmd/antrea-agent: watch -> ruleCache -> reconcile -> datapath)
whose ONLY input is the framed event stream; it holds no reference to the
controller's memory, so everything it enforces provably crossed the
serialization boundary.

Protocol (newline-delimited JSON on stdin; one-line JSON responses on
stdout — only control commands respond):
  {"ev": <serde-encoded WatchEvent>}   apply to the local agent controller
  {"ctl": "resync_begin"/"resync_end"} full re-list window (no response):
                                       events inside are the complete
                                       snapshot; stale local state is
                                       retracted at resync_end
  {"cmd": "sync"}                      reconcile into the datapath
  {"cmd": "step", "now": N, "packets": {...}}  run a batch, return verdicts
  {"cmd": "summary"}                   local PolicySet shape (debugging)
  {"cmd": "exit"}                      clean shutdown
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--node", required=True)
    ap.add_argument("--datapath", default="oracle", choices=["oracle", "tpuflow"])
    ap.add_argument("--flow-slots", type=int, default=1 << 12)
    ap.add_argument("--aff-slots", type=int, default=1 << 8)
    # The tpuflow engine's device: the card unless "cpu" is asked for
    # (without CUDA the engine raises at construction).
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    from ..agent.controller import AgentPolicyController
    from ..datapath import OracleDatapath, TpuflowDatapath
    from ..packet import PacketBatch
    from . import serde

    kw = dict(flow_slots=args.flow_slots, aff_slots=args.aff_slots)
    if args.datapath == "tpuflow":
        dp = TpuflowDatapath(miss_chunk=32, device=args.device, **kw)
    else:
        dp = OracleDatapath(**kw)
    agent = AgentPolicyController(args.node, dp, store=None)

    out = sys.stdout.buffer

    def respond(obj: dict) -> None:
        out.write((json.dumps(obj, separators=(",", ":")) + "\n").encode())
        out.flush()

    for raw in sys.stdin.buffer:
        try:
            msg = json.loads(raw.decode())
        except ValueError as e:
            # Event frames have no reader waiting: responding here would
            # desynchronize the RPC stream (the next readline would eat
            # it).  Log and drop.
            print(f"agent_proc[{args.node}]: bad frame: {e}", file=sys.stderr)
            continue
        if "ev" in msg:
            try:
                agent.handle_event(serde.decode_event(msg["ev"]))
            except Exception as e:  # keep consuming; report out-of-band
                print(
                    f"agent_proc[{args.node}]: event failed: "
                    f"{type(e).__name__}: {e}",
                    file=sys.stderr,
                )
            continue
        if "ctl" in msg:
            # Resync markers are stream framing, not RPCs: no response
            # (responding would desynchronize the request/response pairing).
            if msg["ctl"] == "resync_begin":
                agent.begin_resync()
            elif msg["ctl"] == "resync_end":
                agent.end_resync()
            continue
        cmd = msg.get("cmd")
        try:
            if cmd == "sync":
                agent.sync()
                # Realization report rides the sync response: {policy uid:
                # realized spec generation} — the wire form of the agent's
                # UpdateStatus RPC (status_controller.go:140); the parent
                # relays it into the StatusAggregator.
                respond({
                    "ok": True,
                    "generation": dp.generation,
                    "realized": agent.realized_generations(),
                })
            elif cmd == "step":
                p = msg["packets"]
                batch = PacketBatch(
                    src_ip=np.asarray(p["src_ip"], np.uint32),
                    dst_ip=np.asarray(p["dst_ip"], np.uint32),
                    proto=np.asarray(p["proto"], np.int32),
                    src_port=np.asarray(p["src_port"], np.int32),
                    dst_port=np.asarray(p["dst_port"], np.int32),
                )
                r = dp.step(batch, msg["now"])
                respond({
                    "code": [int(x) for x in r.code],
                    "est": [int(x) for x in r.est],
                    "reply": [int(x) for x in r.reply],
                    "reject_kind": [int(x) for x in r.reject_kind],
                    "snat": [int(x) for x in r.snat],
                    "svc_idx": [int(x) for x in r.svc_idx],
                    "dnat_ip": [int(x) for x in r.dnat_ip],
                    "dnat_port": [int(x) for x in r.dnat_port],
                    "ingress_rule": r.ingress_rule,
                    "egress_rule": r.egress_rule,
                })
            elif cmd == "summary":
                ps = agent.policy_set
                respond({
                    "policies": sorted(p.uid for p in ps.policies),
                    "addressGroups": sorted(ps.address_groups),
                    "appliedToGroups": sorted(ps.applied_to_groups),
                })
            elif cmd == "exit":
                respond({"ok": True})
                return 0
            else:
                respond({"error": f"unknown cmd {cmd!r}"})
        except Exception as e:  # report, don't die: the stream continues
            respond({"error": f"{type(e).__name__}: {e}"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
