"""Process-boundary dissemination: serialized watch stream to agent procs.

The reference's controller->agent plane is a protobuf watch over HTTPS
(docs/design/architecture.md:50-64; per-watcher channel in
pkg/apiserver/storage/ram/store.go:230).  This module realizes the same
architecture with the pieces this build owns: WatchEvents serialized by
dissemination/serde.py (the protobuf analog) stream over an OS pipe to an
agent running in a REAL subprocess (antrea_tpu_torch.dissemination.agent_proc),
which assembles its local PolicySet from the wire alone and drives its own
Datapath.  Control messages on the same framed stream let tests probe the
remote datapath (step/trace) and read back verdicts — the differential
harness crosses the process boundary.

Framing: newline-delimited JSON (serde.event_to_wire).  Event messages are
{"ev": <encoded WatchEvent>}; control messages are {"cmd": ...}; responses
are one JSON line each.  Delivery is pumped from a QUEUED store watcher
(RamStore.watch_queue), so a slow or dead agent never blocks the
controller — pump() moves whatever is buffered, in order.

NOTE: the PRIMARY dissemination transport is the authenticated mTLS
network wire (dissemination/netwire.py — the apiserver.go:97-99 analog),
which the fleet (simulator/fleet.py transport="netwire") and the
end-to-end reachability tests ride.  This pipe transport remains as a
FALLBACK harness for subprocess isolation tests where PKI setup would
add nothing (the framing and serde layers are shared with the wire).
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import tempfile
import time
from typing import Optional

from . import serde
from .store import RamStore, Watcher

# bounded-buffer analysis-pass contract (analysis/bounded_buffer.py): every
# buffer-shaped attribute in this package declares its cap.
BUFFER_CAPS = {
    "SubprocessAgent._rdbuf": "holds at most one partial response line; "
                              "_read_response_line consumes a complete "
                              "line per RPC under the RPC deadline",
}


class AgentDiedError(RuntimeError):
    """The agent subprocess is gone (crashed, killed, or wedged past the
    RPC deadline).  Carries what the operator needs to diagnose it without
    attaching a debugger: the child's exit code and its stderr tail."""

    def __init__(self, node: str, exit_code: Optional[int],
                 stderr_tail: str, context: str = ""):
        self.node = node
        self.exit_code = exit_code
        self.stderr_tail = stderr_tail
        detail = f"agent {node} died (exit code {exit_code})"
        if context:
            detail += f" {context}"
        if stderr_tail:
            detail += f"; stderr tail:\n{stderr_tail}"
        super().__init__(detail)


class SubprocessAgent:
    """Parent-side handle: one agent process consuming one node's stream.

    Failure model: a dead or wedged child surfaces as AgentDiedError (with
    exit code + stderr tail) from send_event/pump/_rpc instead of a bare
    BrokenPipeError or an indefinite readline block; _rpc enforces a read
    deadline (rpc_timeout) and kills a wedged child rather than hanging
    the controller."""

    def __init__(
        self,
        node: str,
        store: Optional[RamStore] = None,
        *,
        datapath_type: str = "oracle",
        flow_slots: int = 1 << 12,
        aff_slots: int = 1 << 8,
        rpc_timeout: float = 60.0,
        watcher_max_pending: Optional[int] = None,
        device: Optional[str] = None,
    ):
        self.node = node
        self._rpc_timeout = rpc_timeout
        # The child's stderr lands in a temp file (not a pipe we would
        # have to drain) so AgentDiedError can carry its tail.
        self._stderr = tempfile.TemporaryFile()
        self._rdbuf = b""
        env = dict(os.environ)
        # The tpuflow engine's device: the card unless the caller asks for
        # the CPU.  Resolved here, so that a parent without CUDA raises
        # before a child is spawned.
        if datapath_type == "tpuflow":
            from ..ops.match import resolve_device

            device = str(resolve_device(device))
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
        self._proc = subprocess.Popen(
            [
                sys.executable, "-m",
                "antrea_tpu_torch.dissemination.agent_proc",
                "--node", node,
                "--datapath", datapath_type,
                "--flow-slots", str(flow_slots),
                "--aff-slots", str(aff_slots),
            ] + (["--device", device] if device is not None else []),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr,
            cwd=repo_root,
            env=env,
        )
        self._store = store
        self._watcher: Optional[Watcher] = None
        if store is not None:
            self._watcher = store.watch_queue(
                node, max_pending=watcher_max_pending)

    # -- death diagnostics ---------------------------------------------------

    def _stderr_tail(self, limit: int = 4096) -> str:
        try:
            self._stderr.flush()
            size = self._stderr.seek(0, os.SEEK_END)
            self._stderr.seek(max(0, size - limit))
            return self._stderr.read().decode(errors="replace").strip()
        except (OSError, ValueError):
            return ""

    def _died(self, context: str) -> AgentDiedError:
        """Reap the (dead or dying) child -> typed error with its exit
        code and stderr tail.  Never blocks long: a pipe already broke or
        we decided to kill, so the wait is bounded."""
        if self._proc.poll() is None:
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
        return AgentDiedError(self.node, self._proc.poll(),
                             self._stderr_tail(), context)

    # -- stream pump ---------------------------------------------------------

    def pump(self) -> int:
        """Ship everything buffered on the store watcher to the agent;
        returns the number of events sent.  A watcher that overflowed its
        bounded queue is served a full resync bracketed in ctl markers
        (the same re-list protocol the netwire server speaks)."""
        if self._watcher is None:
            return 0
        if self._watcher.needs_resync:
            self._send_frame({"ctl": "resync_begin"})
            events = list(self._store.resync(self._watcher))
            for ev in events:
                self.send_event(ev)
            self._send_frame({"ctl": "resync_end"})
            return len(events)
        events = self._watcher.drain()
        for ev in events:
            self.send_event(ev)
        return len(events)

    def _send_frame(self, frame: dict) -> None:
        line = json.dumps(frame, separators=(",", ":")) + "\n"
        try:
            self._proc.stdin.write(line.encode())
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            # The child died between frames (kill mid-stream): reap it and
            # raise the typed error instead of a bare BrokenPipeError.
            raise self._died(f"writing frame: {e}") from e

    def send_event(self, ev) -> None:
        self._send_frame({"ev": serde.encode_event(ev)})

    # -- control RPCs --------------------------------------------------------

    def _read_response_line(self) -> bytes:
        """One newline-framed response from the child's stdout, under the
        RPC deadline.  Reads the raw fd (os.read + own buffer — a buffered
        readline could block past the deadline on a partial line); a
        wedged child is killed and surfaced as AgentDiedError."""
        fd = self._proc.stdout.fileno()
        deadline = time.monotonic() + self._rpc_timeout
        while b"\n" not in self._rdbuf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._proc.kill()
                raise self._died(
                    f"wedged: no RPC response within {self._rpc_timeout}s")
            r, _, _ = select.select([fd], [], [], min(remaining, 0.25))
            if not r:
                if self._proc.poll() is not None:
                    raise self._died("while awaiting RPC response")
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                raise self._died("stdout closed awaiting RPC response")
            self._rdbuf += chunk
        line, self._rdbuf = self._rdbuf.split(b"\n", 1)
        return line

    def _rpc(self, msg: dict) -> dict:
        self._send_frame(msg)
        resp = json.loads(self._read_response_line().decode())
        if "error" in resp:
            raise RuntimeError(f"agent {self.node}: {resp['error']}")
        return resp

    def sync(self) -> dict:
        """Reconcile received state into the agent's datapath.  The response
        carries "realized" ({policy uid: realized spec generation}) — relay
        it to a StatusAggregator via update_node_statuses(node, realized)
        to close the realization-status loop across the process boundary."""
        return self._rpc({"cmd": "sync"})

    def step(self, batch, now: int) -> dict:
        """Run a packet batch through the agent's datapath; verdict lists."""
        return self._rpc({
            "cmd": "step",
            "now": now,
            "packets": {
                "src_ip": [int(x) for x in batch.src_ip],
                "dst_ip": [int(x) for x in batch.dst_ip],
                "proto": [int(x) for x in batch.proto],
                "src_port": [int(x) for x in batch.src_port],
                "dst_port": [int(x) for x in batch.dst_port],
            },
        })

    def state_summary(self) -> dict:
        return self._rpc({"cmd": "summary"})

    def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()
        if self._proc.poll() is None:
            try:
                self._rpc({"cmd": "exit"})
            except (RuntimeError, OSError, ValueError):
                pass  # child already dead/closed: fall through to reap
            try:
                self._proc.stdin.close()
            except OSError:
                pass
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=10)
        # Pipes close even when the child was ALREADY dead (the
        # AgentDiedError path skips the branch above): a controller
        # respawning agents must not leak two fds per death.
        for pipe in (self._proc.stdin, self._proc.stdout):
            try:
                pipe.close()
            except OSError:
                pass
        try:
            self._stderr.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
