"""Pod lifecycle: the CNI server + IPAM + interface store analog.

The reference's pod path (pkg/agent/cniserver — gRPC Cni
service, server.go:430 CmdAdd: IPAM allocate -> veth + OVS port ->
InstallPodFlows; pkg/agent/cniserver/ipam host-local delegation;
pkg/agent/interfacestore — in-memory port cache rebuilt from OVSDB
external-IDs on restart, agent.go:279) re-expressed for this runtime:

  * HostLocalIPAM: per-node podCIDR allocator (host-local semantics:
    smallest free address, gateway/.0/broadcast reserved, idempotent by
    container id, release returns the address).
  * InterfaceStore: the authoritative pod-interface table, persisted as
    external-IDs rows in the NATIVE transactional config store
    (native/ovsdb_lite — exactly how the reference survives restarts by
    rebuilding from OVSDB).
  * CniServer: CmdAdd/CmdDel/CmdCheck orchestration — allocate, record,
    and feed the pod into the central controller (which fans policy out to
    datapaths); the veth/netns syscall layer has no analog on TPU.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import json
from dataclasses import dataclass
from typing import Optional

from ..apis.crd import Pod
from ..native import ConfigStore

_IFACE_PREFIX = "iface/"


class IPAMError(Exception):
    pass


class HostLocalIPAM:
    """host-local range allocator over one podCIDR (ref
    pkg/agent/cniserver/ipam host-local delegation semantics)."""

    def __init__(self, pod_cidr: str):
        self.net = ipaddress.ip_network(pod_cidr)
        # .0 = network, .1 = gateway (antrea-gw0), last = broadcast.
        self.gateway = str(self.net.network_address + 1)
        self._first = int(self.net.network_address) + 2
        self._last = int(self.net.broadcast_address) - 1
        self._by_id: dict[str, str] = {}
        self._used: set[int] = set()
        # Rolling cursor (host-local's last-allocated-ip behavior): the
        # common allocation is O(1); a wrap-around scan reclaims released
        # addresses only once the range end is reached.
        self._cursor = self._first

    def allocate(self, container_id: str) -> str:
        ip = self._by_id.get(container_id)
        if ip is not None:
            return ip  # idempotent retry (CNI ADD may be re-delivered)
        n = self._last - self._first + 1
        for _ in range(n):
            if self._cursor > self._last:
                self._cursor = self._first  # wrap: pick up released addrs
            cand = self._cursor
            self._cursor += 1
            if cand not in self._used:
                self._used.add(cand)
                ip = str(ipaddress.ip_address(cand))
                self._by_id[container_id] = ip
                return ip
        raise IPAMError(f"podCIDR {self.net} exhausted")

    def release(self, container_id: str) -> Optional[str]:
        ip = self._by_id.pop(container_id, None)
        if ip is not None:
            self._used.discard(int(ipaddress.ip_address(ip)))
        return ip

    def mark_used(self, container_id: str, ip: str) -> None:
        """Restart path: re-claim an address recorded in the interface
        store (the reference re-learns host-local state the same way)."""
        self._by_id[container_id] = ip
        self._used.add(int(ipaddress.ip_address(ip)))


@dataclass
class InterfaceConfig:
    """One pod interface (ref interfacestore.InterfaceConfig).  Labels are
    persisted too so restart recovery re-notifies the controller with the
    pod's REAL selector-relevant labels (an empty-label upsert would evict
    the pod from every selector group)."""

    container_id: str
    pod_namespace: str
    pod_name: str
    ip: str
    ofport: int
    labels: dict = None

    def __post_init__(self):
        if self.labels is None:
            self.labels = {}

    def key(self) -> str:
        return self.container_id


class InterfaceStore:
    """Pod-interface table persisted in the native config store as
    external-IDs rows — a restarted agent rebuilds from it (agent.go:279;
    interface store from OVSDB external-IDs)."""

    def __init__(self, store: ConfigStore):
        self._store = store
        self._ifaces: dict[str, InterfaceConfig] = {}
        for key in store.keys():
            if not key.startswith(_IFACE_PREFIX):
                continue
            d = json.loads(store.get(key))
            ic = InterfaceConfig(**d)
            self._ifaces[ic.container_id] = ic

    def add(self, ic: InterfaceConfig) -> None:
        self._ifaces[ic.container_id] = ic
        # asdict keeps the persisted row in lockstep with the dataclass
        # (the load path is InterfaceConfig(**row)).
        self._store.set(
            _IFACE_PREFIX + ic.container_id,
            json.dumps(dataclasses.asdict(ic)).encode(),
        )
        self._store.commit()

    def delete(self, container_id: str) -> None:
        self._ifaces.pop(container_id, None)
        self._store.delete(_IFACE_PREFIX + container_id)
        self._store.commit()

    def get(self, container_id: str) -> Optional[InterfaceConfig]:
        return self._ifaces.get(container_id)

    def all(self) -> list[InterfaceConfig]:
        return sorted(self._ifaces.values(), key=lambda i: i.container_id)


class CniServer:
    """CmdAdd/CmdDel/CmdCheck orchestration (ref cniserver/server.go:430).

    controller: a NetworkPolicyController (or None) receiving pod upserts —
    the reference's equivalent is the pod informer seeing the kubelet-
    created pod; feeding it from CmdAdd keeps the single-process test
    topology deterministic.
    """

    def __init__(self, node: str, pod_cidr: str, store: ConfigStore,
                 controller=None):
        self.node = node
        self.ipam = HostLocalIPAM(pod_cidr)
        self.ifaces = InterfaceStore(store)
        self.controller = controller
        self._next_ofport = 10
        # Restart recovery: re-claim addresses + ofports from the store.
        for ic in self.ifaces.all():
            self.ipam.mark_used(ic.container_id, ic.ip)
            self._next_ofport = max(self._next_ofport, ic.ofport + 1)
            self._notify(ic)

    def _notify(self, ic: InterfaceConfig) -> None:
        if self.controller is not None:
            self.controller.upsert_pod(Pod(
                namespace=ic.pod_namespace, name=ic.pod_name,
                ip=ic.ip, node=self.node, labels=dict(ic.labels),
            ))

    def cmd_add(self, container_id: str, pod_namespace: str, pod_name: str,
                labels: Optional[dict] = None) -> InterfaceConfig:
        existing = self.ifaces.get(container_id)
        if existing is not None:
            return existing  # idempotent ADD (server.go re-delivery path)
        ip = self.ipam.allocate(container_id)
        ic = InterfaceConfig(
            container_id=container_id, pod_namespace=pod_namespace,
            pod_name=pod_name, ip=ip, ofport=self._next_ofport,
            labels=dict(labels or {}),
        )
        self._next_ofport += 1
        self.ifaces.add(ic)
        self._notify(ic)
        return ic

    def cmd_del(self, container_id: str) -> bool:
        ic = self.ifaces.get(container_id)
        if ic is None:
            return False  # DEL of unknown container succeeds per CNI spec
        self.ifaces.delete(container_id)
        self.ipam.release(container_id)
        if self.controller is not None:
            # A late/duplicated DEL for an old sandbox must not remove a
            # RECREATED pod: only delete when no other interface for the
            # same namespace/name remains (the CNI spec allows stale DELs).
            same_pod_lives = any(
                o.pod_namespace == ic.pod_namespace
                and o.pod_name == ic.pod_name
                for o in self.ifaces.all()
            )
            if not same_pod_lives:
                self.controller.delete_pod(
                    f"{ic.pod_namespace}/{ic.pod_name}"
                )
        return True

    def cmd_check(self, container_id: str) -> bool:
        return self.ifaces.get(container_id) is not None


# -- unix-socket wire ---------------------------------------------------------


CNI_WIRE_VERSION = "1.0"


class CniSocketServer:
    """The kubelet->agent seam over a unix-domain socket — the transport
    shape of the reference's Cni gRPC service
    (pkg/apis/cni/v1beta1/cni.proto:67-75; server
    pkg/agent/cniserver/server.go:430 listening on a unix socket).

    Framing: newline-delimited JSON requests
    {"version": "1.0", "cmd": "add"|"del"|"check", ...} with one JSON
    response line each.  Concurrent clients each get a handler thread
    (kubelet issues parallel CNI calls for distinct sandboxes); a
    version the server doesn't speak gets a structured error, the
    versioned-request contract of the proto."""

    def __init__(self, server: CniServer, sock_path: str):
        import os as _os
        import socket as _socket
        import threading as _threading

        self._server = server
        self.sock_path = sock_path
        try:
            _os.unlink(sock_path)
        except FileNotFoundError:
            pass
        self._lsock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        self._lsock.bind(sock_path)
        self._lsock.listen(16)
        self._closing = False
        # CmdAdd/CmdDel mutate IPAM + interface store: serialize them (the
        # reference's server also serializes per-container operations).
        self._mu = _threading.Lock()
        self._acceptor = _threading.Thread(target=self._accept_loop,
                                           daemon=True)
        self._acceptor.start()

    def _accept_loop(self) -> None:
        import threading as _threading
        import time as _time

        while not self._closing:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                if self._closing:
                    return
                # Transient accept errors (ECONNABORTED, EMFILE pressure)
                # must not kill a live server; back off and keep serving.
                _time.sleep(0.05)
                continue
            _threading.Thread(target=self._serve, args=(conn,),
                              daemon=True).start()

    def _serve(self, conn) -> None:
        from ..dissemination.netwire import iter_json_lines

        try:
            try:
                for req in iter_json_lines(conn):
                    resp = self._handle(req)
                    conn.sendall(json.dumps(resp).encode() + b"\n")
            except ValueError as e:
                # Malformed JSON / oversized frame: one structured error,
                # then drop the (unrecoverable) stream.
                conn.sendall(json.dumps(
                    {"ok": False, "error": f"malformed request: {e}"}
                ).encode() + b"\n")
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, req) -> dict:
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON object"}
        if req.get("version") != CNI_WIRE_VERSION:
            return {"ok": False,
                    "error": f"unsupported version {req.get('version')!r}"}
        cmd = req.get("cmd")
        try:
            with self._mu:
                if cmd == "add":
                    ic = self._server.cmd_add(
                        req["containerId"], req.get("podNamespace", ""),
                        req.get("podName", ""), req.get("labels") or {},
                    )
                    return {"ok": True, "ip": ic.ip, "ofport": ic.ofport,
                            "gateway": self._server.ipam.gateway}
                if cmd == "del":
                    return {"ok": True,
                            "released": self._server.cmd_del(
                                req["containerId"])}
                if cmd == "check":
                    return {"ok": True,
                            "exists": self._server.cmd_check(
                                req["containerId"])}
        except Exception as e:  # noqa: BLE001 — handler boundary: the
            # kubelet gets a structured error, never a dead socket.
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def close(self) -> None:
        import os as _os

        self._closing = True
        try:
            self._lsock.close()
        except OSError:
            pass
        try:
            _os.unlink(self.sock_path)
        except OSError:
            pass


class CniClient:
    """Framed unix-socket client (the kubelet side of the seam)."""

    def __init__(self, sock_path: str):
        import socket as _socket

        self._sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        self._sock.connect(sock_path)
        self._buf = b""

    def _rpc(self, body: dict) -> dict:
        from ..dissemination.netwire import recv_one_json

        body.setdefault("version", CNI_WIRE_VERSION)
        self._sock.sendall(json.dumps(body).encode() + b"\n")
        obj, self._buf = recv_one_json(self._sock, self._buf)
        return obj

    def add(self, container_id: str, pod_namespace: str = "",
            pod_name: str = "", labels=None) -> dict:
        return self._rpc({"cmd": "add", "containerId": container_id,
                          "podNamespace": pod_namespace,
                          "podName": pod_name, "labels": labels or {}})

    def delete(self, container_id: str) -> dict:
        return self._rpc({"cmd": "del", "containerId": container_id})

    def check(self, container_id: str) -> dict:
        return self._rpc({"cmd": "check", "containerId": container_id})

    def close(self) -> None:
        self._sock.close()
