"""Connection identity (the port's copy of ``fluvio_tpu/auth/identity.py``).

Capability parity: fluvio-auth/src/x509/identity.rs `X509Identity
{principal, scopes}` — extracted from the TLS client certificate's
subject (CN = principal, O entries = scopes/roles). Local plaintext
clusters (the reference's default local install) fall back to whatever
the transport can attest: an authenticator callback, or the anonymous
default.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Identity:
    principal: str = ""
    scopes: List[str] = field(default_factory=list)

    @classmethod
    def anonymous(cls) -> "Identity":
        return cls(principal="anonymous", scopes=[])

    @classmethod
    def from_peer_cert(cls, cert: Optional[dict]) -> "Identity":
        """x509 identity from an ssl `getpeercert()` dict.

        Parity: x509/identity.rs — subject CN becomes the principal,
        subject O (organization) entries become the scopes.
        """
        if not cert:
            return cls.anonymous()
        principal = ""
        scopes: List[str] = []
        for rdn in cert.get("subject", ()):  # tuple of RDN tuples
            for key, value in rdn:
                if key == "commonName" and not principal:
                    principal = value
                elif key == "organizationName":
                    scopes.append(value)
        if not principal:
            return cls.anonymous()
        return cls(principal=principal, scopes=scopes)

    @classmethod
    def from_socket(cls, socket) -> "Identity":
        """Identity attested by a transport socket (TLS client cert when
        present, anonymous otherwise)."""
        peer_cert = getattr(socket, "peer_cert", None)
        return cls.from_peer_cert(peer_cert() if callable(peer_cert) else None)
