"""PacketCapture: CRD-driven first-N packet capture at the datapath tap.

The analog of pkg/agent/packetcapture (2,015 LoC;
packetcapture_controller.go:30-32,237): the PacketCapture CRD names a
source/destination (pod or IP), an optional protocol/port filter, a
first-N packet budget and a timeout; the agent captures matching packets
(gopacket/pcapng in the reference), marks the CRD done, and uploads the
file (sftp in the reference — here a pluggable `uploader`).

The capture point differs by construction: the reference sniffs the pod
interface; here the tap is the datapath step boundary, which additionally
sees the VERDICT and forwarding disposition for every captured packet —
the capture record is a decoded pcapng frame + the per-packet pipeline
observations (closer to `antctl packetcapture` + Traceflow combined)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..utils import ip as iputil


@dataclass
class CaptureSpec:
    """crd PacketCapture subset (source/destination/packet filter +
    firstN + timeout)."""

    name: str
    src_cidr: str = ""  # "" = any
    dst_cidr: str = ""
    protocol: Optional[int] = None
    dst_port: Optional[int] = None
    first_n: int = 100
    timeout_s: int = 60


@dataclass
class _CaptureState:
    spec: CaptureSpec
    started: int = 0
    records: list = field(default_factory=list)
    done: bool = False
    reason: str = ""


class PacketCaptureController:
    def __init__(self, uploader: Optional[Callable] = None):
        # uploader(name, records) — the sftp-upload seam.
        self._uploader = uploader
        self._captures: dict[str, _CaptureState] = {}

    def start(self, spec: CaptureSpec, now: int) -> None:
        self._captures[spec.name] = _CaptureState(spec=spec, started=now)

    def stop(self, name: str) -> Optional[list]:
        st = self._captures.pop(name, None)
        return None if st is None else st.records

    def status(self, name: str) -> Optional[dict]:
        st = self._captures.get(name)
        if st is None:
            return None
        return {
            "name": st.spec.name,
            "captured": len(st.records),
            "firstN": st.spec.first_n,
            "done": st.done,
            "reason": st.reason,
        }

    def observe(self, batch, result, now: int) -> int:
        """Feed one stepped batch through all active captures; -> records
        appended.  Completion (budget reached or timeout) finalizes the
        capture and fires the uploader, like the controller marking the CRD
        PacketCaptureSucceeded and uploading the pcapng."""
        n = 0
        for st in self._captures.values():
            if st.done:
                continue
            if now - st.started > st.spec.timeout_s:
                self._finish(st, "timeout")
                continue
            idx = self._match(st.spec, batch)
            for i in idx:
                if len(st.records) >= st.spec.first_n:
                    break
                st.records.append(self._record(batch, result, int(i), now))
                n += 1
            if len(st.records) >= st.spec.first_n:
                self._finish(st, "firstNCaptured")
        return n

    def _finish(self, st: _CaptureState, reason: str) -> None:
        st.done = True
        st.reason = reason
        if self._uploader is not None:
            self._uploader(st.spec.name, list(st.records))

    @staticmethod
    def _match(spec: CaptureSpec, batch) -> np.ndarray:
        m = np.ones(batch.size, dtype=bool)
        # Half-open [lo, hi) narrowed via inclusive hi-1 — hi itself can be
        # 2**32 (e.g. a /0 or the top /32), which overflows uint32.
        if spec.src_cidr:
            lo, hi = iputil.cidr_to_range_v4(spec.src_cidr)
            m &= (batch.src_ip >= np.uint32(lo)) & (batch.src_ip <= np.uint32(hi - 1))
        if spec.dst_cidr:
            lo, hi = iputil.cidr_to_range_v4(spec.dst_cidr)
            m &= (batch.dst_ip >= np.uint32(lo)) & (batch.dst_ip <= np.uint32(hi - 1))
        if spec.protocol is not None:
            m &= batch.proto == spec.protocol
        if spec.dst_port is not None:
            m &= batch.dst_port == spec.dst_port
        return np.nonzero(m)[0]

    @staticmethod
    def _record(batch, result, i: int, now: int) -> dict:
        rec = {
            "ts": now,
            "src": iputil.u32_to_ip(int(batch.src_ip[i])),
            "dst": iputil.u32_to_ip(int(batch.dst_ip[i])),
            "proto": int(batch.proto[i]),
            "sport": int(batch.src_port[i]),
            "dport": int(batch.dst_port[i]),
            "verdict": int(result.code[i]),
        }
        if result.fwd_kind is not None:
            rec["fwd_kind"] = int(result.fwd_kind[i])
            rec["out_port"] = int(result.out_port[i])
        return rec


def write_capture_file(path: str, name: str, records: list) -> str:
    """Serialize a finished capture (the pcapng-file analog; JSON lines so
    antctl and the support bundle can carry it)."""
    with open(path, "w") as f:
        f.write(json.dumps({"capture": name, "records": len(records)}) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path
