"""WireGuard tunnel-encryption: per-node key + peer table management.

The analog of pkg/agent/wireguard (957 LoC,
client_linux.go): with trafficEncryptionMode=wireGuard the agent creates
the antrea-wg0 device, generates/persists a private key, publishes the
public key on its Node annotation, and maintains one WireGuard PEER per
remote node — endpoint = node IP:port, allowedIPs = that node's pod CIDR(s)
— updated from the node-route controller's node events.

The cipher itself is the kernel's WireGuard implementation even in the
reference (the agent only drives wgctrl netlink); what the agent owns —
and what this module rebuilds — is key lifecycle + the peer/allowed-IP
reconciliation.  Key material is REAL X25519 (wgtypes.GeneratePrivateKey
analog): the private key is a curve scalar, the public half is X25519
scalar-mult via `cryptography`, and shared_secret() computes the
Diffie-Hellman both peers agree on — the primitive the kernel's Noise
handshake consumes."""

from __future__ import annotations

import base64
import os
from dataclasses import dataclass
from typing import Optional

# Primary backend: the `cryptography` package.  Fallback: a pure-Python
# RFC 7748 Montgomery ladder — some deployment images ship without the
# cryptography wheel (the same gap netwire.py's PKI covers with the
# openssl CLI), and a missing optional cipher backend must not take the
# whole agent package down with an ImportError.  Both backends are
# checked against the RFC 7748 known-answer vectors in
# tests/test_aux_agents.py.
try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
except ImportError:
    X25519PrivateKey = X25519PublicKey = None

DEFAULT_PORT = 51820  # ref: pkg/agent/config WireGuardListenPort default

_KEY_ROW = "wireguard/private_key"

_P = 2**255 - 19
_A24 = 121665
_BASE_U = (9).to_bytes(32, "little")


def _x25519(k: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 X25519(k, u): scalar mult on Curve25519, constant
    shape (the swap-based Montgomery ladder as specified)."""
    kb = bytearray(k)
    kb[0] &= 248
    kb[31] &= 127
    kb[31] |= 64
    scalar = int.from_bytes(kb, "little")
    ub = bytearray(u)
    ub[31] &= 127  # mask the unused high bit per RFC 7748 §5
    x1 = int.from_bytes(ub, "little")
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (scalar >> t) & 1
        swap ^= kt
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


def _derive_public(private_b64: str) -> str:
    """X25519 public key of a base64 private scalar (wgtypes
    Key.PublicKey) — interop-checked against RFC 7748 vectors in
    tests/test_aux_agents.py."""
    raw = base64.b64decode(private_b64)
    if X25519PrivateKey is None:
        return base64.b64encode(_x25519(raw, _BASE_U)).decode()
    priv = X25519PrivateKey.from_private_bytes(raw)
    return base64.b64encode(priv.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )).decode()


def shared_secret(private_b64: str, peer_public_b64: str) -> str:
    """X25519 DH: both directions derive the same 32-byte secret — the
    handshake primitive (kernel Noise IK consumes exactly this)."""
    raw_priv = base64.b64decode(private_b64)
    raw_pub = base64.b64decode(peer_public_b64)
    if X25519PrivateKey is None:
        out = _x25519(raw_priv, raw_pub)
        if not any(out):
            # Low-order peer point -> null secret: the cryptography
            # backend raises here (RFC 7748 §6.1 all-zero check); the
            # fallback must reject identically, not hand an attacker a
            # forceable key.
            raise ValueError("low-order peer public key (null shared secret)")
        return base64.b64encode(out).decode()
    priv = X25519PrivateKey.from_private_bytes(raw_priv)
    pub = X25519PublicKey.from_public_bytes(raw_pub)
    return base64.b64encode(priv.exchange(pub)).decode()


@dataclass
class WireGuardPeer:
    node: str
    public_key: str
    endpoint_ip: str
    endpoint_port: int
    allowed_ips: tuple  # pod CIDRs routed through this peer


class WireGuardClient:
    def __init__(self, node: str, store=None, port: int = DEFAULT_PORT):
        self._node = node
        self._port = port
        self._store = store
        self._peers: dict[str, WireGuardPeer] = {}
        # Private key persists (client_linux.go loads the existing key on
        # restart so the published public key stays stable).
        priv = store.get(_KEY_ROW) if store is not None else None
        if priv is not None:
            self._private = priv.decode()
        else:
            self._private = base64.b64encode(os.urandom(32)).decode()
            if store is not None:
                store.set(_KEY_ROW, self._private.encode())
                store.commit()

    @property
    def public_key(self) -> str:
        """Published via the node annotation
        (node.antrea.io/wireguard-public-key in the reference)."""
        return _derive_public(self._private)

    @property
    def listen_port(self) -> int:
        return self._port

    def shared_with(self, peer_public_b64: str) -> str:
        """X25519 DH with a peer's published public key — both ends
        derive the same secret (the handshake-shaped key schedule)."""
        return shared_secret(self._private, peer_public_b64)

    # -- peer reconciliation (client_linux.go UpdatePeer/DeletePeer) ---------

    def upsert_peer(
        self,
        node: str,
        public_key: str,
        endpoint_ip: str,
        pod_cidrs,
        endpoint_port: int = DEFAULT_PORT,
    ) -> bool:
        """-> True when the device config changed.  Self-peers are refused
        (the reference never peers a node with itself)."""
        if node == self._node:
            return False
        peer = WireGuardPeer(
            node=node, public_key=public_key, endpoint_ip=endpoint_ip,
            endpoint_port=endpoint_port, allowed_ips=tuple(sorted(pod_cidrs)),
        )
        if self._peers.get(node) == peer:
            return False
        self._peers[node] = peer
        return True

    def delete_peer(self, node: str) -> bool:
        return self._peers.pop(node, None) is not None

    def peers(self) -> list[WireGuardPeer]:
        return [self._peers[k] for k in sorted(self._peers)]

    def peer_for_ip(self, ip_u32: int) -> Optional[WireGuardPeer]:
        """Which peer's allowedIPs route this destination — LONGEST-prefix
        match, the kernel's cryptokey-routing semantics (a /16 peer beats a
        /8 peer for addresses in both)."""
        from ..utils import ip as iputil

        best: Optional[WireGuardPeer] = None
        best_len = -1
        for p in self.peers():
            for cidr in p.allowed_ips:
                lo, hi = iputil.cidr_to_range_v4(cidr)
                if lo <= ip_u32 < hi:
                    plen = 32 - (hi - lo).bit_length() + 1
                    if plen > best_len:
                        best, best_len = p, plen
        return best
