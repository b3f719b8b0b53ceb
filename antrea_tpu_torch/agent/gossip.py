"""SWIM gossip over UDP: failure DETECTION feeding the membership ring.

The analog of the reference's hashicorp/memberlist cluster
(pkg/agent/memberlist/cluster.go:180 memberlist.Create,
:227 Join): agents probe each other over the network, a missed direct
probe triggers an indirect probe through another member, unanswered
probes mark the peer SUSPECT and then DEAD, and every transition feeds
the SAME consistent-hash ring (agent/memberlist.py) that elects
Egress/ServiceExternalIP/MC-gateway owners — so failover is driven by
*detected* death, not by an operator calling leave().

Protocol (newline-free JSON datagrams, SWIM's three message kinds plus
join):

    {"t": "ping",     "from": name, "mem": [...]}
    {"t": "ping-req", "from": name, "target": name, "mem": [...]}  (indirect)
    {"t": "ack",      "from": name, "mem": [...]}
    {"t": "join",     "from": name, "addr": [h, p]}

Every message piggybacks the sender's membership view `mem` as
[name, [host, port], incarnation, state] rows (SWIM's gossip dissemination
— there is no separate broadcast channel).  States: 0 alive, 1 suspect,
2 dead.  A node that learns it is suspected refutes by re-announcing
itself with a bumped INCARNATION; higher incarnation always wins, and for
equal incarnations the worse state wins (suspicion spreads, refutation
needs a bump) — the standard SWIM ordering.

Scope: a semantic miniature grown a real wire — timers are configurable
so tests run in hundreds of milliseconds; production deployments would
tune probe_interval_s/suspect_timeout_s like memberlist's defaults.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time

ALIVE, SUSPECT, DEAD = 0, 1, 2


class SwimNode:
    """One agent's SWIM endpoint.  Feeds a MemberlistCluster (join/leave)
    on detected alive/dead transitions."""

    def __init__(self, name: str, cluster=None, *, bind=("127.0.0.1", 0),
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 0.25,
                 suspect_timeout_s: float = 0.8):
        self.name = name
        self.cluster = cluster
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(bind)
        self._sock.settimeout(0.1)
        self.address = self._sock.getsockname()
        self._probe_interval = probe_interval_s
        self._probe_timeout = probe_timeout_s
        self._suspect_timeout = suspect_timeout_s
        self._lock = threading.Lock()
        self._inc = 0  # own incarnation
        # name -> {"addr": (h, p), "inc": int, "state": int, "since": ts}
        self._members: dict[str, dict] = {}
        self._acked: set[str] = set()  # acks seen since the probe started
        self._closing = False
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._prober = threading.Thread(target=self._probe_loop, daemon=True)
        self._rx.start()
        self._prober.start()

    # -- membership table ----------------------------------------------------

    def _my_row(self):
        return [self.name, list(self.address), self._inc, ALIVE]

    def _mem_rows(self):
        rows = [self._my_row()]
        for n, m in self._members.items():
            rows.append([n, list(m["addr"]), m["inc"], m["state"]])
        return rows

    def _merge(self, rows) -> None:
        """Apply a piggybacked membership view (SWIM ordering: higher
        incarnation wins; same incarnation, worse state wins)."""
        with self._lock:
            for name, addr, inc, state in rows:
                if name == self.name:
                    # Refute suspicion about OURSELVES: bump incarnation;
                    # the next piggyback spreads the refutation.
                    if state != ALIVE and inc >= self._inc:
                        self._inc = inc + 1
                    continue
                cur = self._members.get(name)
                if cur is None:
                    self._members[name] = {
                        "addr": tuple(addr), "inc": inc, "state": state,
                        "since": time.monotonic(),
                    }
                    self._on_state(name, state, None)
                    continue
                if inc < cur["inc"]:
                    continue
                if inc == cur["inc"] and state <= cur["state"]:
                    continue
                old = cur["state"]
                cur["inc"], cur["state"] = inc, state
                cur["addr"] = tuple(addr)
                cur["since"] = time.monotonic()
                self._on_state(name, state, old)

    def _on_state(self, name: str, state: int, old) -> None:
        """alive/dead transitions feed the consistent-hash ring — the
        cluster.go node-event channel driving owner reconciles.  SUSPECT
        does not change ring membership (the reference keeps suspects
        until confirmed dead)."""
        if self.cluster is None:
            return
        if state == ALIVE and old != ALIVE:
            self.cluster.join(name)
        elif state == DEAD and old != DEAD:
            self.cluster.leave(name)

    # -- wire ----------------------------------------------------------------

    def _send(self, addr, body: dict) -> None:
        body["from"] = self.name
        body["mem"] = self._mem_rows()
        try:
            self._sock.sendto(json.dumps(body).encode(), tuple(addr))
        except OSError:
            pass

    def join(self, seed_addr) -> None:
        """Announce to a seed (memberlist Join, cluster.go:227): the seed
        learns us from the datagram's source + piggyback and its next
        messages gossip us onward."""
        self._send(tuple(seed_addr), {"t": "join",
                                      "addr": list(self.address)})

    def _recv_loop(self) -> None:
        while not self._closing:
            try:
                data, src = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = json.loads(data.decode())
            except ValueError:
                continue
            self._merge(msg.get("mem", ()))
            t = msg.get("t")
            if t in ("ping", "join"):
                self._send(src, {"t": "ack"})
            elif t == "ping-req":
                # Indirect probe: ping the target on the requester's
                # behalf; the target's ack piggyback will reach the
                # requester through us on the next exchange.
                tgt = msg.get("target")
                with self._lock:
                    m = self._members.get(tgt)
                if m is not None:
                    self._send(m["addr"], {"t": "ping"})
            elif t == "ack":
                self._acked.add(msg.get("from"))

    def _probe_loop(self) -> None:
        while not self._closing:
            time.sleep(self._probe_interval)
            with self._lock:
                candidates = [
                    (n, m) for n, m in self._members.items()
                    if m["state"] != DEAD
                ]
            if not candidates:
                continue
            name, m = random.choice(candidates)
            self._acked.discard(name)
            self._send(m["addr"], {"t": "ping"})
            deadline = time.monotonic() + self._probe_timeout
            while time.monotonic() < deadline and name not in self._acked:
                time.sleep(0.02)
            if name not in self._acked:
                # Indirect probe through one other member (SWIM k=1).
                with self._lock:
                    others = [
                        mm for nn, mm in self._members.items()
                        if nn != name and mm["state"] == ALIVE
                    ]
                if others:
                    self._send(random.choice(others)["addr"],
                               {"t": "ping-req", "target": name})
                    deadline = time.monotonic() + self._probe_timeout
                    while (time.monotonic() < deadline
                           and name not in self._acked):
                        time.sleep(0.02)
            with self._lock:
                cur = self._members.get(name)
                if cur is None:
                    continue
                if name in self._acked:
                    if cur["state"] == SUSPECT:
                        cur["state"] = ALIVE
                        cur["since"] = time.monotonic()
                        self._on_state(name, ALIVE, SUSPECT)
                    continue
                if cur["state"] == ALIVE:
                    cur["state"] = SUSPECT
                    cur["since"] = time.monotonic()
                elif (cur["state"] == SUSPECT
                      and time.monotonic() - cur["since"]
                      > self._suspect_timeout):
                    cur["state"] = DEAD
                    self._on_state(name, DEAD, SUSPECT)

    def members(self) -> dict:
        with self._lock:
            return {n: dict(m) for n, m in self._members.items()}

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass


def main(argv=None) -> None:
    """Subprocess agent: `python -m antrea_tpu_torch.agent.gossip NAME [SEED]`.
    Prints its bound address on stdout (the parent's discovery channel)
    then gossips until killed — the process a failure-detection test
    SIGKILLs to prove death is *detected*, not announced."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    name = args[0]
    node = SwimNode(name)
    print(json.dumps({"addr": list(node.address)}), flush=True)
    if len(args) > 1:
        host, port = args[1].rsplit(":", 1)
        node.join((host, int(port)))
    while True:
        time.sleep(1)


if __name__ == "__main__":
    main()
