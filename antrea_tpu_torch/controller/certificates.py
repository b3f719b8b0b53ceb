"""CSR signing/approval: the IPsec certificate trust plane.

The analog of pkg/controller/certificatesigningrequest
(1,902 LoC): agents needing IPsec authentication submit
CertificateSigningRequests with signerName antrea.io/antrea-agent-ipsec-
tunnel; the antrea-controller APPROVES requests whose subject matches the
requesting node's identity (approver.go checks) and SIGNS them against a
self-managed CA (certificate.go), publishing the CA bundle.

X.509 math is out of scope here (the reference itself delegates the
plumbing to the K8s CSR API and consumes the result in strongSwan):
certificates are canonical-JSON payloads bound by an HMAC over the CA
secret — same trust topology (central secret, verifiable bearer
documents, expiry windows, identity-checked approval), substitutable wire
format.  The CA secret is minted once in the native config store."""

from __future__ import annotations

import hashlib
import hmac
import json
import os
from dataclasses import dataclass, field
from typing import Optional

SIGNER_IPSEC = "antrea.io/antrea-agent-ipsec-tunnel"
DEFAULT_TTL_S = 10 * 24 * 3600  # certificate.go: ~10 day default validity

_CA_KEY = "ca/secret"


@dataclass
class Csr:
    name: str
    node: str  # requesting identity (subject CN in the reference)
    public_key: str
    signer: str = SIGNER_IPSEC
    # Filled by the controller:
    approved: bool = False
    denied: bool = False
    certificate: Optional[dict] = None


def _canon(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


class CertificateAuthority:
    def __init__(self, store):
        raw = store.get(_CA_KEY)
        if raw is None:
            raw = os.urandom(32)
            store.set(_CA_KEY, raw)
            store.commit()
        self._secret = raw

    def sign(self, subject: str, public_key: str, now: int,
             ttl_s: int = DEFAULT_TTL_S) -> dict:
        payload = {
            "subject": subject,
            "publicKey": public_key,
            "notBefore": now,
            "notAfter": now + ttl_s,
        }
        sig = hmac.new(self._secret, _canon(payload), hashlib.sha256)
        return {**payload, "signature": sig.hexdigest()}

    def verify(self, cert: dict, now: int) -> bool:
        payload = {k: v for k, v in cert.items() if k != "signature"}
        sig = hmac.new(self._secret, _canon(payload), hashlib.sha256)
        return (
            hmac.compare_digest(sig.hexdigest(), cert.get("signature", ""))
            and payload.get("notBefore", 0) <= now < payload.get("notAfter", 0)
        )


class CsrController:
    """Approval + signing loop (approver.go + signer in one sync path).

    Auto-approval policy matches the reference: an IPsec-signer CSR is
    approved iff the claimed subject equals the requesting node identity
    (`requestor`); anything else waits for manual approve()/deny()."""

    def __init__(self, ca: CertificateAuthority):
        self._ca = ca
        self._csrs: dict[str, Csr] = {}

    def submit(self, csr: Csr, requestor: str, now: int) -> Csr:
        existing = self._csrs.get(csr.name)
        if existing is not None:
            # A name resubmit is idempotent ONLY for identical content;
            # anything else is refused — replacing a pending CSR's key
            # material (or resurrecting a denied one) under a name an admin
            # may be about to approve would bind the subject's identity to
            # an attacker's key (K8s CSR objects are likewise immutable).
            if (existing.node, existing.public_key, existing.signer) != (
                csr.node, csr.public_key, csr.signer
            ):
                raise ValueError(
                    f"csr {csr.name} exists with different content"
                )
            return existing
        self._csrs[csr.name] = csr
        if csr.signer == SIGNER_IPSEC and csr.node == requestor:
            self.approve(csr.name, now)
        return csr

    def approve(self, name: str, now: int) -> Csr:
        csr = self._csrs[name]
        if csr.denied:
            raise ValueError(f"csr {name} was denied")
        csr.approved = True
        csr.certificate = self._ca.sign(csr.node, csr.public_key, now)
        return csr

    def deny(self, name: str) -> None:
        csr = self._csrs[name]
        if csr.approved:
            raise ValueError(f"csr {name} already approved")
        csr.denied = True

    def get(self, name: str) -> Optional[Csr]:
        return self._csrs.get(name)
