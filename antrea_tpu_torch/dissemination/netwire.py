"""Network dissemination wire: the controller<->agent channel over REAL
mutual-TLS TCP sockets.

The reference's control plane is a protobuf watch over HTTPS with CA-signed
certificates on both ends (pkg/apiserver/apiserver.go:97-99,
pkg/apiserver/certificate/; agents authenticate and verify the server).
This module materializes that wire for the TPU build:

  * X.509 PKI (make_ca / issue_cert, real certificates via `cryptography`)
    — the wire-level counterpart of the semantic CSR flow in
    controller/certificates.py;
  * DisseminationServer: accepts mTLS connections (client certs REQUIRED
    and verified against the CA), registers a queued span watcher per
    agent and streams serde-encoded WatchEvents (newline-JSON — the
    protobuf-role codec of dissemination/serde.py);
  * the SAME connection carries the agent's realization-status reports
    upstream ({"status": {...}} frames -> StatusAggregator), the
    UpdateStatus RPC of status_controller.go:140;
  * NetAgent: the agent-side client feeding an AgentPolicyController.

Delivery is explicitly pumped (server.pump() / agent.pump()) so tests are
deterministic; the sockets, handshakes and certificate verification are
real.  A client without a CA-signed certificate cannot connect; an agent
refusing the server certificate cannot be fed.
"""

from __future__ import annotations

import datetime
import ipaddress
import json
import os
import random
import select
import socket
import ssl
import subprocess
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Optional

from . import serde
from ..observability.flightrec import emit_into
from .store import RamStore, ResyncCursor, Watcher

# bounded-buffer analysis-pass contract (analysis/bounded_buffer.py): every
# buffer-shaped attribute in this package declares its cap here.
BUFFER_CAPS = {
    "_LineConn._buf": "holds at most one partial frame; the framing loops "
                      "bound a line at 64KiB (hello) / 1MiB (iter_json_"
                      "lines) and recv_ready drains complete lines "
                      "immediately",
}


def _min_opt(*vals: Optional[int]) -> Optional[int]:
    """Smallest non-None bound (None = unbounded)."""
    present = [v for v in vals if v is not None]
    return min(present) if present else None


# -- PKI ---------------------------------------------------------------------
#
# Primary backend: the `cryptography` package.  Fallback: the openssl CLI —
# some deployment images ship libssl (so the stdlib `ssl` module works) but
# not the Python cryptography wheel; the PKI must not take the whole
# dissemination plane down with an ImportError there.  Both backends emit
# the same PEM artifacts, so everything downstream (SSLContext loading,
# peer-CN verification) is backend-blind.


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _openssl(*args: str, cwd: Optional[str] = None) -> None:
    subprocess.run(
        ["openssl", *args], cwd=cwd, check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )


def _make_ca_openssl(dirpath: str, cn: str) -> None:
    _openssl("ecparam", "-name", "prime256v1", "-genkey", "-noout",
             "-out", os.path.join(dirpath, "ca.key"))
    _openssl("req", "-new", "-x509", "-key", os.path.join(dirpath, "ca.key"),
             "-out", os.path.join(dirpath, "ca.crt"),
             "-days", "365", "-subj", f"/CN={cn}")


def _issue_cert_openssl(dirpath: str, cn: str, server: bool,
                        cp: str, kp: str) -> None:
    csr = os.path.join(dirpath, f"{cn}.csr")
    ext = os.path.join(dirpath, f"{cn}.ext")
    try:
        _openssl("ecparam", "-name", "prime256v1", "-genkey", "-noout",
                 "-out", kp)
        _openssl("req", "-new", "-key", kp, "-subj", f"/CN={cn}",
                 "-out", csr)
        sign = ["x509", "-req", "-in", csr,
                "-CA", os.path.join(dirpath, "ca.crt"),
                "-CAkey", os.path.join(dirpath, "ca.key"),
                "-CAcreateserial", "-days", "30", "-out", cp]
        if server:
            _write(ext, b"subjectAltName=DNS:localhost,IP:127.0.0.1\n")
            sign += ["-extfile", ext]
        _openssl(*sign)
    finally:
        for p in (csr, ext):
            try:
                os.unlink(p)
            except OSError:
                pass


def make_ca(dirpath: str, cn: str = "antrea-tpu-ca") -> None:
    """Create ca.crt/ca.key under dirpath (idempotent)."""
    os.makedirs(dirpath, exist_ok=True)
    if os.path.exists(os.path.join(dirpath, "ca.crt")):
        return
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        _make_ca_openssl(dirpath, cn)
        return
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    _write(os.path.join(dirpath, "ca.key"), key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    _write(os.path.join(dirpath, "ca.crt"),
           cert.public_bytes(serialization.Encoding.PEM))


def _cert_usable(cp: str, margin_s: int = 86400) -> bool:
    """True when the cached cert still outlives the margin.  Leaf certs
    are valid 30 days: reusing one past expiry would make every reconnect
    handshake fail forever (the reconnect loop would re-dial an identity
    the server must reject) — an expiring cert re-mints instead."""
    try:
        from cryptography import x509
    except ImportError:
        try:
            _openssl("x509", "-checkend", str(margin_s), "-noout", "-in", cp)
            return True
        except (subprocess.SubprocessError, OSError):
            return False
    try:
        with open(cp, "rb") as f:
            cert = x509.load_pem_x509_certificate(f.read())
    except (OSError, ValueError):
        return False
    exp = getattr(cert, "not_valid_after_utc", None)
    if exp is None:  # older cryptography: naive UTC datetime
        exp = cert.not_valid_after.replace(tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    return exp - now > datetime.timedelta(seconds=margin_s)


def issue_cert(dirpath: str, cn: str, *, server: bool = False) -> tuple[str, str]:
    """CA-sign a cert for cn -> (cert path, key path).  Server certs get
    the 127.0.0.1/localhost SANs the client verifies against.  An already
    issued, still-valid (cert, key) pair for this CN is reused — a
    reconnecting agent re-handshakes with its existing identity instead
    of re-running key generation on every backoff attempt; an expiring
    one is re-minted (see _cert_usable)."""
    cp = os.path.join(dirpath, f"{cn}.crt")
    kp = os.path.join(dirpath, f"{cn}.key")
    if os.path.exists(cp) and os.path.exists(kp) and _cert_usable(cp):
        return cp, kp
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        _issue_cert_openssl(dirpath, cn, server, cp, kp)
        return cp, kp

    with open(os.path.join(dirpath, "ca.key"), "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), None)
    with open(os.path.join(dirpath, "ca.crt"), "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    b = (
        x509.CertificateBuilder()
        .subject_name(x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=30))
    )
    if server:
        b = b.add_extension(x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
        ]), critical=False)
    cert = b.sign(ca_key, hashes.SHA256())
    _write(kp, key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    _write(cp, cert.public_bytes(serialization.Encoding.PEM))
    return cp, kp


# -- framing -----------------------------------------------------------------


class Backoff:
    """Capped exponential backoff with jitter — the reconnect discipline
    of the reference's client-go watch retry (wait.Backoff).

    Two jitter layers keep a fleet that lost one controller from
    re-handshaking in lockstep: a per-attempt random factor, and a
    DETERMINISTIC per-node factor derived from the node name — so even
    clients constructed with identical (or identically-seeded) rngs
    spread out.  After a controller restart, 10k agents redial on 10k
    distinct schedules, each still bounded by `cap`."""

    def __init__(self, base: float = 0.05, cap: float = 2.0, rng=None,
                 node: Optional[str] = None):
        self.base = base
        self.cap = cap
        self._rng = rng if rng is not None else random.Random()
        # Node-name hash -> factor in [0.6, 1.0]: scales EVERY delay (cap
        # included, so delays never exceed cap) and differs node-to-node.
        if node:
            h = zlib.crc32(node.encode())
            self.node_factor = 0.6 + 0.4 * ((h % 4096) / 4095.0)
        else:
            self.node_factor = 1.0
        self.attempt = 0

    def next_delay(self) -> float:
        # Clamp the exponent: attempt grows without bound across a long
        # outage, and 2**~1030 overflows float — the cap wins long before.
        d = min(self.cap, self.base * (2 ** min(self.attempt, 30)))
        self.attempt += 1
        return d * self.node_factor * (0.5 + 0.5 * self._rng.random())

    def reset(self) -> None:
        self.attempt = 0


# The reconnect-policy name used by docs/tests; Backoff is the
# implementation class.
BackoffPolicy = Backoff


class _LineConn:
    """Newline-JSON framing over a (TLS) socket, nonblocking reads."""

    def __init__(self, sock):
        self.sock = sock
        self._buf = b""
        # Orderly EOF observed on recv: the peer is gone — callers use
        # this to trigger reconnect instead of pumping a dead socket.
        self.closed = False

    def send(self, obj: dict) -> None:
        self.sock.sendall(
            (json.dumps(obj, separators=(",", ":")) + "\n").encode())

    def recv_ready(self, first_wait: float = 0.0) -> list[dict]:
        """Drain whatever is available -> decoded frames.  first_wait
        bounds the wait for the FIRST chunk (loopback TLS records can land
        an instant after the peer's sendall returns); subsequent reads
        never block."""
        out = []
        wait = first_wait
        while True:
            r, _, _ = select.select([self.sock], [], [], wait)
            wait = 0.0
            if not r:
                # TLS may hold decrypted bytes even when the raw socket is
                # quiet; poll the SSL buffer too.
                if getattr(self.sock, "pending", lambda: 0)() == 0:
                    break
            try:
                chunk = self.sock.recv(65536)
            except ssl.SSLWantReadError:
                break
            if not chunk:
                self.closed = True  # peer closed
                break
            self._buf += chunk
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            if line:
                out.append(json.loads(line.decode()))
        return out


def iter_json_lines(sock, max_line: int = 1 << 20):
    """Yield decoded JSON objects from newline-framed lines on a BLOCKING
    socket until EOF — the one blocking-side framing loop (the
    non-blocking twin is _LineConn.recv_ready; the 64KiB hello bound in
    _handshake_inner is this same discipline).  Malformed JSON yields a
    ValueError to the caller; an oversized line raises."""
    buf = b""
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            return
        buf += chunk
        if len(buf) > max_line:
            raise ValueError(f"frame exceeds {max_line} bytes")
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line:
                yield json.loads(line.decode())


def recv_one_json(sock, buf: bytes, max_line: int = 1 << 20):
    """Blocking read of ONE newline-framed JSON object -> (obj, rest) —
    the client-side half of iter_json_lines' framing."""
    while b"\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed the socket")
        buf += chunk
        if len(buf) > max_line:
            raise ValueError(f"frame exceeds {max_line} bytes")
    line, rest = buf.split(b"\n", 1)
    return json.loads(line.decode()), rest


# -- server ------------------------------------------------------------------


@dataclass
class _ConnState:
    """One registered agent connection.  fresh=True until the first resync
    completes (bracketed in resync markers so the agent can retract state
    a previous connection left behind); cursor holds the in-flight
    chunked resync, if any."""

    conn: _LineConn
    watcher: Watcher
    seq: int
    fresh: bool = True
    cursor: Optional[ResyncCursor] = None


class DisseminationServer:
    """mTLS dissemination endpoint in front of a RamStore.

    Failure model: an agent connection that dies is pruned (its events
    stay in the store); on re-handshake the server REPLAYS the node's
    span-filtered snapshot between {"ctl": "resync_begin"}/{"ctl":
    "resync_end"} markers — the reference's watch re-list semantics — so
    the agent can reconcile away anything stale.  Per-agent watcher queues
    are bounded by watcher_max_pending: a consumer that falls behind the
    cap costs one resync, never unbounded controller memory.

    Storm disciplines (all opt-in; None = the permissive legacy behavior):
      * resync_chunk — a resync ships at most this many events per pump
        round, via a resumable ResyncCursor, interleaved with other
        agents' live drains (no head-of-line blocking behind a big
        snapshot).  Live churn arriving mid-resync lands in the watcher's
        coalescing queue and ships inside the SAME resync window.
      * resync_concurrency — at most this many watchers mid-resync at
        once; the rest are shed to later rounds (their gated queues hold
        no memory while parked), so a fleet-wide overflow storm becomes a
        metered trickle of re-lists, never a replay storm.
      * drain_max / send_budget — per-watcher and per-round send bounds so
        one hot agent cannot dominate a round (the 2s send timeout +
        identity-aware prune stays the backstop for wedged peers)."""

    def __init__(self, store: RamStore, certdir: str, *,
                 host: str = "127.0.0.1", port: int = 0,
                 status_aggregator=None,
                 watcher_max_pending: Optional[int] = None,
                 resync_chunk: Optional[int] = None,
                 resync_concurrency: Optional[int] = None,
                 drain_max: Optional[int] = None,
                 send_budget: Optional[int] = None,
                 flightrec=None):
        self._store = store
        self._status = status_aggregator
        self._watcher_max_pending = watcher_max_pending
        self._resync_chunk = resync_chunk
        self._resync_concurrency = resync_concurrency
        self._drain_max = drain_max
        self._send_budget = send_budget
        self._flightrec = flightrec
        # Dissemination-health counters (scraped by
        # observability.metrics.render_dissemination_metrics).
        self.resyncs_total = 0      # completed resyncs (incl. hellos)
        self.reconnects_total = 0   # re-handshakes replacing a live node
        self.resync_chunks_total = 0   # non-empty cursor chunks shipped
        self.resyncs_shed_total = 0    # admission-gate deferrals
        # Coalesce counts of retired watchers (stop/replace) fold in here
        # so dissemination_stats' total survives reconnect churn.
        self._coalesced_retired = 0
        # Round-robin rotation so budget exhaustion starves fairly.
        self._rr = 0
        cert, key = issue_cert(certdir, "controller", server=True)
        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.load_cert_chain(cert, key)
        self._ctx.load_verify_locations(os.path.join(certdir, "ca.crt"))
        self._ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
        self._lsock = socket.create_server((host, port))
        self.address = self._lsock.getsockname()
        # node -> _ConnState; handshakes land here from the acceptor.
        # seq is the ACCEPT order: concurrent handshake threads may finish
        # out of order, and a stale connection finishing last must never
        # evict the agent's newer live one.
        self._conns: dict[str, _ConnState] = {}
        self._lock = threading.Lock()
        self._closing = False
        self._accept_seq = 0
        # Any peer that can reach the listener gets a handshake thread
        # BEFORE authenticating; bound them so a raw-TCP flood cannot
        # accumulate threads without limit.
        self._handshakes = threading.Semaphore(32)
        # TLS handshakes are inherently concurrent with the client's
        # connect, so accept+handshake+hello run on a daemon thread (the
        # reference's apiserver accepts concurrently too); event delivery
        # and status consumption stay on the explicit pump() for
        # deterministic tests.
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                raw, _ = self._lsock.accept()
            except OSError:
                return  # listener closed
            # A slow or malicious peer (even certless) must not stall
            # registration of every other agent for its 5s timeout:
            # handshake+hello run on a short-lived per-connection thread;
            # only registration takes the lock.
            if not self._handshakes.acquire(blocking=False):
                raw.close()  # at capacity: shed before spending a thread
                continue
            self._accept_seq += 1
            threading.Thread(
                target=self._handshake, args=(raw, self._accept_seq),
                daemon=True,
            ).start()

    def _handshake(self, raw, seq: int) -> None:
        try:
            self._handshake_inner(raw, seq)
        finally:
            self._handshakes.release()

    def _handshake_inner(self, raw, seq: int) -> None:
        try:
            raw.settimeout(5.0)
            tls = self._ctx.wrap_socket(raw, server_side=True)
        except (ssl.SSLError, OSError):
            raw.close()  # unauthenticated peer: handshake rejected
            return
        try:
            buf = b""
            while b"\n" not in buf:
                if len(buf) > 65536:
                    # A certified peer streaming newline-less bytes must
                    # not grow the hello buffer without bound (each recv
                    # resets the per-op timeout): reject.
                    raise ValueError("hello line exceeds 64KiB")
                chunk = tls.recv(4096)
                if not chunk:
                    break
                buf += chunk
            if not buf:
                tls.close()
                return
            line, rest = buf.split(b"\n", 1)
            hello = json.loads(line.decode())
            node = hello["hello"]
            # Bind the VERIFIED certificate identity to the claimed
            # node: a CA-signed cert for agent-X must not register as
            # node Y (the mutual-TLS authentication contract — antrea's
            # apiserver authenticates agents by identity, not just by
            # holding any cluster cert).
            cert = tls.getpeercert()
            cns = [v for rdn in cert.get("subject", ())
                   for k, v in rdn if k == "commonName"]
            if cns != [f"agent-{node}"]:
                raise ValueError(
                    f"cert identity {cns} does not match node {node!r}"
                )
        except (ssl.SSLError, OSError, ValueError, KeyError, TypeError):
            # Malformed/stalled hello (TypeError: valid JSON that is not
            # an object): close the HANDSHAKEN socket (its fd moved out
            # of `raw` at wrap time).
            tls.close()
            return
        tls.settimeout(None)
        tls.setblocking(False)
        conn = _LineConn(tls)
        # Frames coalesced into the hello's TLS record (e.g. an eager
        # status report) must not be dropped.
        conn._buf = rest
        with self._lock:
            if self._closing:
                # close() already snapshotted _conns: registering now
                # would leak an un-stopped watcher that buffers store
                # events forever plus an open TLS socket.
                tls.close()
                return
            old = self._conns.get(node)
            if old is not None and old.seq > seq:
                # A NEWER connection for this node already registered
                # (this thread's hello was slower): this one is stale —
                # evicting the live registration would stream to a socket
                # the agent abandoned.
                tls.close()
                return
            w = self._store.watch_queue(
                # replay=False: fresh=True already forces a full resync on
                # the first pump — buffering the snapshot here would be
                # discarded work and could spuriously count an overflow.
                node, max_pending=self._watcher_max_pending, replay=False)
            w._flightrec = self._flightrec
            self._conns[node] = _ConnState(conn, w, seq)
            if old is not None:
                self.reconnects_total += 1
                self._coalesced_retired += old.watcher.coalesced
        if old is not None:
            # Reconnect: retire the previous registration — an
            # un-stopped watcher would buffer events forever.
            old.watcher.stop()
            try:
                old.conn.sock.close()
            except OSError:
                pass

    def wait_connected(self, n: int, timeout: float = 5.0) -> None:
        """Block until n agents have completed handshake+hello (the
        acceptor thread registers them asynchronously)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._conns) >= n:
                    return
            time.sleep(0.01)
        raise TimeoutError(f"{n} agents not connected within {timeout}s")

    def _emit(self, kind: str, **fields) -> None:
        emit_into(self, kind, **fields)

    def pump(self) -> int:
        """Stream queued events, consume status reports -> events shipped.

        A fresh connection (hello or reconnect) and a watcher whose
        bounded queue overflowed are served a RESYNC: the node's
        span-filtered snapshot bracketed in resync markers, bypassing the
        queue (so a snapshot larger than the cap still converges).  With
        resync_chunk set, the snapshot ships cursor-chunked across rounds,
        interleaved with other agents' live traffic; resync_concurrency
        bounds how many such cursors run at once; drain_max/send_budget
        bound per-watcher and per-round send work (class docstring)."""
        shipped = 0
        budget = self._send_budget
        with self._lock:
            conns = list(self._conns.items())
        inflight = sum(1 for _n, st in conns if st.cursor is not None)
        if conns:
            # Rotate the serving order so a budget that runs out mid-round
            # starves a DIFFERENT tail next round.
            self._rr = (self._rr + 1) % len(conns)
            conns = conns[self._rr:] + conns[:self._rr]
        dead: list[tuple[str, _LineConn]] = []
        live = []
        for node, st in conns:
            conn = st.conn
            if budget is not None and shipped >= budget:
                live.append((node, conn))  # still select it for statuses
                continue
            try:
                # Bounded send: an agent that stopped reading (full TCP
                # buffer) must not block the pump forever — a timed-out
                # sendall raises and the agent is pruned as dead.
                conn.sock.settimeout(2.0)
                if st.cursor is None and (st.fresh
                                          or st.watcher.needs_resync):
                    if (self._resync_concurrency is not None
                            and inflight >= self._resync_concurrency):
                        # Admission gate: defer this re-list to a later
                        # round.  The parked watcher stays gated
                        # (needs_resync drops live events), so waiting
                        # costs no memory.
                        self.resyncs_shed_total += 1
                        self._emit("resync-shed", node=node,
                                   inflight=inflight)
                        conn.sock.setblocking(False)
                        live.append((node, conn))
                        continue
                    st.cursor = self._store.resync(st.watcher)
                    inflight += 1
                    conn.send({"ctl": "resync_begin"})
                    self._emit("resync-begin", node=node,
                               objects=st.cursor.total)
                elif st.cursor is not None and st.watcher.needs_resync:
                    # The coalescing queue overflowed AGAIN mid-resync
                    # (distinct-key churn past the cap): restart the
                    # cursor inside the same window — a repeated begin
                    # marker resets the consumer's seen-set.
                    st.cursor = self._store.resync(st.watcher)
                    conn.send({"ctl": "resync_begin"})
                    self._emit("resync-begin", node=node,
                               objects=st.cursor.total, restart=True)
                if st.cursor is not None:
                    room = None if budget is None else budget - shipped
                    chunk = st.cursor.take(
                        _min_opt(self._resync_chunk, room))
                    for ev in chunk:
                        conn.send({"ev": serde.encode_event(ev)})
                        shipped += 1
                    if chunk:
                        self.resync_chunks_total += 1
                    # Live churn that landed mid-resync ships INSIDE the
                    # open window (the consumer's resync seen-set covers
                    # it), under the same drain bound as healthy traffic.
                    room = None if budget is None else budget - shipped
                    for ev in st.watcher.drain(
                            _min_opt(self._drain_max, room)):
                        conn.send({"ev": serde.encode_event(ev)})
                        shipped += 1
                    if st.cursor.done and not st.watcher.needs_resync:
                        conn.send({"ctl": "resync_end"})
                        self._emit("resync-end", node=node,
                                   chunks=st.cursor.chunks,
                                   events=st.cursor.sent)
                        st.cursor = None
                        st.fresh = False
                        inflight -= 1
                        with self._lock:
                            self.resyncs_total += 1
                else:
                    room = None if budget is None else budget - shipped
                    for ev in st.watcher.drain(
                            _min_opt(self._drain_max, room)):
                        conn.send({"ev": serde.encode_event(ev)})
                        shipped += 1
                conn.sock.setblocking(False)
                live.append((node, conn))
            except (OSError, ssl.SSLError, ValueError):
                # One dead agent must not halt dissemination to the rest:
                # prune it (its events stay in the STORE's history; a
                # reconnect replays).
                dead.append((node, conn))
        # ONE bounded select across every agent socket (not 50ms per idle
        # connection serially), then drain only the ready/buffered ones.
        if live:
            try:
                ready, _, _ = select.select([c.sock for _n, c in live],
                                            [], [], 0.05)
            except (OSError, ValueError):
                ready = [c.sock for _n, c in live]  # sort out per-conn below
            ready_ids = {id(s) for s in ready}
            for node, conn in live:
                try:
                    if (id(conn.sock) in ready_ids or conn._buf
                            or conn.sock.pending()):
                        for frame in conn.recv_ready():
                            if "status" in frame and self._status is not None:
                                self._status.update_node_statuses(
                                    node, frame["status"])
                except (OSError, ssl.SSLError, ValueError):
                    dead.append((node, conn))
        for node, failed_conn in dead:
            with self._lock:
                entry = self._conns.get(node)
                # Identity-aware prune: if the node RECONNECTED between
                # our snapshot and now, the registered entry is a fresh
                # healthy connection — tearing it down by name would
                # disconnect a live agent.
                if entry is None or entry.conn is not failed_conn:
                    entry = None
                else:
                    del self._conns[node]
                    self._coalesced_retired += entry.watcher.coalesced
            if entry is not None:
                entry.watcher.stop()
                try:
                    entry.conn.sock.close()
                except OSError:
                    pass
            else:
                try:
                    failed_conn.sock.close()
                except OSError:
                    pass
        return shipped

    def dissemination_stats(self) -> dict:
        """Health snapshot for the metrics surface: per-node watcher depth
        / overflow / coalesce / resync-pending state plus the server
        counters (chunks shipped, resyncs in flight, admission shedding)."""
        with self._lock:
            return {
                "watchers": {
                    node: {
                        "pending": st.watcher.pending(),
                        "overflows": st.watcher.overflows,
                        "coalesced": st.watcher.coalesced,
                        "needs_resync": bool(
                            st.fresh or st.watcher.needs_resync
                            or st.cursor is not None),
                    }
                    for node, st in self._conns.items()
                },
                "resyncs_total": self.resyncs_total,
                "reconnects_total": self.reconnects_total,
                "resync_chunks_total": self.resync_chunks_total,
                "resyncs_inflight": sum(
                    1 for st in self._conns.values()
                    if st.cursor is not None),
                "resyncs_shed_total": self.resyncs_shed_total,
                "coalesced_total": self._coalesced_retired + sum(
                    st.watcher.coalesced for st in self._conns.values()),
            }

    def close(self) -> None:
        with self._lock:
            # Flag + snapshot under ONE lock hold: any in-flight
            # _handshake thread either registered before this (and is in
            # the snapshot) or will observe _closing and self-close.
            self._closing = True
            conns = list(self._conns.values())
        for st in conns:
            st.watcher.stop()
            st.conn.sock.close()
        # shutdown() BEFORE close(): closing an fd does not wake a thread
        # blocked in accept() — the acceptor would stay parked on the
        # stale fd number, and once the kernel reuses it for a NEW
        # server's listener, the dead server's acceptor steals that
        # server's connections and answers with the wrong certificate.
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never-connected listener on some platforms
        self._lsock.close()
        self._acceptor.join(timeout=2)


# -- agent client ------------------------------------------------------------


def connect_client(node: str, address, certdir: str,
                   client_cn: Optional[str] = None):
    """The ONE agent-side mTLS bring-up (cert issue, TLS connect, hello,
    non-blocking socket) shared by NetAgent and the fleet's watch-only
    clients — client-side wire changes live here exactly once.
    -> (tls socket, _LineConn)."""
    cert, key = issue_cert(certdir, client_cn or f"agent-{node}")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cert, key)
    ctx.load_verify_locations(os.path.join(certdir, "ca.crt"))
    raw = socket.create_connection(tuple(address))
    sock = ctx.wrap_socket(raw, server_hostname="localhost")
    conn = _LineConn(sock)
    conn.send({"hello": node})
    sock.setblocking(False)
    return sock, conn


class ReconnectingClient:
    """The ONE agent-side wire lifecycle, shared by every client flavor
    (NetAgent here, the fleet's NetFakeAgent): dial via connect_client,
    detect a dead socket, re-dial with capped exponential backoff +
    jitter.  Subclasses call _init_wire() from __init__ and consume
    self._sock/self._conn; _mark_dead() schedules the backoff,
    _try_reconnect() honors it.  The FIRST connect still raises to the
    caller — a misconfigured CA should fail loudly, not spin in
    backoff."""

    def _init_wire(self, node: str, address, certdir: str, *,
                   client_cn: Optional[str] = None, reconnect: bool = True,
                   backoff: Optional[Backoff] = None, clock=time.monotonic,
                   fault_wrap=None) -> None:
        self.node = node
        self._address = tuple(address)
        self._certdir = certdir
        self._client_cn = client_cn
        self._reconnect_enabled = reconnect
        # Default backoff carries the node's deterministic jitter factor so
        # a herd of default-constructed clients never redials in lockstep.
        self._backoff = backoff if backoff is not None else Backoff(node=node)
        self._clock = clock
        self._fault_wrap = fault_wrap
        self._next_attempt = 0.0
        self.reconnects_total = 0
        self._sock = None
        self._conn = None
        self._connect()

    def _connect(self) -> None:
        sock, conn = connect_client(self.node, self._address, self._certdir,
                                    self._client_cn)
        if self._fault_wrap is not None:
            # Chaos harness hook (dissemination/faults.py): interpose a
            # fault-injecting wrapper AFTER the authenticated handshake so
            # injected resets/partial writes exercise the steady state.
            sock = self._fault_wrap(sock)
            conn.sock = sock
        self._sock, self._conn = sock, conn

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _mark_dead(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._conn = None
        if self._reconnect_enabled:
            self._next_attempt = self._clock() + self._backoff.next_delay()

    def _try_reconnect(self) -> bool:
        """One re-dial attempt if the backoff window has elapsed."""
        if not self._reconnect_enabled:
            return False
        if self._clock() < self._next_attempt:
            return False
        try:
            self._connect()
        except (OSError, ssl.SSLError, ConnectionError):
            self._next_attempt = self._clock() + self._backoff.next_delay()
            return False
        self._backoff.reset()
        self.reconnects_total += 1
        return True

    def close(self) -> None:
        self._reconnect_enabled = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # Cleared like _mark_dead: a closed client must answer
        # connected=False and never re-enter a fleet select set.
        self._sock = None
        self._conn = None


class NetAgent(ReconnectingClient):
    """Agent-side client: TLS-verified event stream into an
    AgentPolicyController + upstream realization reports.

    Failure model: a dead socket (reset, orderly close, send failure) is
    detected on the next pump/report, the connection is torn down, and the
    agent re-dials per ReconnectingClient.  The server replays the node's
    snapshot on re-handshake between resync markers; the local
    AgentPolicyController reconciles that snapshot so objects deleted
    while disconnected are retracted."""

    def __init__(self, node: str, address, certdir: str, datapath,
                 client_cn: Optional[str] = None, *,
                 reconnect: bool = True, backoff: Optional[Backoff] = None,
                 clock=time.monotonic, fault_wrap=None):
        from ..agent.controller import AgentPolicyController

        self.resyncs_total = 0
        self.agent = AgentPolicyController(node, datapath)
        self._init_wire(node, address, certdir, client_cn=client_cn,
                        reconnect=reconnect, backoff=backoff, clock=clock,
                        fault_wrap=fault_wrap)

    def pump(self, wait: float = 0.5) -> int:
        if self._sock is None and not self._try_reconnect():
            return 0
        n = 0
        try:
            frames = self._conn.recv_ready(first_wait=wait)
        except (OSError, ssl.SSLError, ValueError):
            self._mark_dead()
            return 0
        for frame in frames:
            if "ev" in frame:
                self.agent.handle_event(serde.decode_event(frame["ev"]))
                n += 1
            elif frame.get("ctl") == "resync_begin":
                self.agent.begin_resync()
            elif frame.get("ctl") == "resync_end":
                self.agent.end_resync()
                self.resyncs_total += 1
        if self._conn.closed:
            self._mark_dead()
        return n

    def sync_and_report(self) -> dict:
        """Reconcile into the datapath, then send the realization report
        upstream (the UpdateStatus RPC over the same mTLS channel).  The
        datapath sync happens regardless of wire health; a failed report
        send just marks the connection dead for the reconnect path."""
        self.agent.sync()
        realized = self.agent.realized_generations()
        if self._sock is None and not self._try_reconnect():
            return realized
        try:
            self._sock.setblocking(True)
            self._conn.send({"status": realized})
            self._sock.setblocking(False)
        except (OSError, ssl.SSLError):
            self._mark_dead()
        return realized
