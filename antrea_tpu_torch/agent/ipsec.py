"""Agent IPsec certificate lifecycle: request, persist, rotate.

The analog of pkg/agent/controller/ipseccertificate
(988 LoC): with trafficEncryptionMode=ipsec the agent generates a key
pair, submits a CSR named after its node through the K8s CSR API, waits
for the antrea-controller's approval+signature, writes the certificate
where strongSwan reads it, and ROTATES before expiry (the controller's
rotation check re-submits when the remaining validity drops under a
threshold).

Keys are opaque strings here (see controller/certificates.py for the
trust-plane stance); persistence rides the native config store so a
restarted agent keeps its certificate until rotation is actually due."""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

from ..controller.certificates import Csr

# Rotate when less than half the validity remains (the reference rotates
# at a fraction of the cert lifetime).
ROTATE_FRACTION = 0.5

_CERT_ROW = "ipsec/certificate"
_KEY_ROW = "ipsec/private_key"
_SEQ_ROW = "ipsec/csr_seq"


class IpsecCertificateController:
    def __init__(self, node: str, csr_controller, store=None):
        self._node = node
        self._csrs = csr_controller
        self._store = store
        self._cert: Optional[dict] = None
        self._pending: Optional[str] = None  # CSR awaiting manual approval
        self._seq = 0
        priv = store.get(_KEY_ROW) if store is not None else None
        if priv is not None:
            self._private = priv.decode()
        else:
            self._private = base64.b64encode(os.urandom(32)).decode()
            if store is not None:
                store.set(_KEY_ROW, self._private.encode())
                store.commit()
        if store is not None:
            raw = store.get(_CERT_ROW)
            if raw is not None:
                self._cert = json.loads(raw)
            seq = store.get(_SEQ_ROW)
            if seq is not None:
                # CSR names must stay unique across restarts — a reused
                # name would hit the controller's idempotent-resubmit path
                # and hand back the OLD certificate instead of rotating.
                self._seq = int.from_bytes(seq, "little")

    @property
    def certificate(self) -> Optional[dict]:
        return self._cert

    def _public_key(self) -> str:
        # Opaque derivation (trust-plane stance, certificates.py docstring).
        import hashlib

        return hashlib.sha256(
            b"antrea-tpu-ipsec-pub:" + self._private.encode()
        ).hexdigest()

    def sync(self, now: int) -> bool:
        """Ensure a valid, not-rotation-due certificate exists; -> True
        when a (re)issue happened.  A CSR awaiting manual approval is
        POLLED on later syncs (never abandoned for a fresh name — the
        admin must be able to approve the one they can see)."""
        if self._pending is not None:
            csr = self._csrs.get(self._pending)
            if csr is not None and csr.certificate is not None:
                self._adopt(csr.certificate)
                self._pending = None
                return True
            if csr is not None and not csr.denied:
                return False  # still awaiting approval — keep polling
            self._pending = None  # denied or vanished: submit anew below
        if self._cert is not None and not self._rotation_due(now):
            return False
        self._seq += 1
        if self._store is not None:
            self._store.set(_SEQ_ROW, self._seq.to_bytes(8, "little"))
            self._store.commit()
        csr = self._csrs.submit(
            Csr(name=f"{self._node}-ipsec-{self._seq}", node=self._node,
                public_key=self._public_key()),
            requestor=self._node,
            now=now,
        )
        if csr.certificate is None:
            self._pending = csr.name
            return False  # awaiting manual approval
        self._adopt(csr.certificate)
        return True

    def _adopt(self, cert: dict) -> None:
        self._cert = cert
        if self._store is not None:
            self._store.set(_CERT_ROW, json.dumps(cert).encode())
            self._store.commit()

    def _rotation_due(self, now: int) -> bool:
        nb = self._cert["notBefore"]
        na = self._cert["notAfter"]
        return now >= nb + (na - nb) * ROTATE_FRACTION
