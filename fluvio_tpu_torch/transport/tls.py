"""TLS for the client<->broker fabric.

The port's copy of ``fluvio_tpu/transport/tls.py``. Capability parity:
fluvio/src/config/tls.rs (client TlsPolicy:
disabled / anonymous / verified with cert paths) and the reference's
SPU-side TLS proxy (fluvio-spu/src/start.rs:97-118). Design difference:
the reference terminates TLS in a sidecar proxy in front of the
plaintext endpoint; here the asyncio endpoints speak TLS directly —
same wire security, one fewer hop, and the server socket can attest the
client certificate for x509 identity (fluvio-auth/src/x509/).
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional, Tuple


def client_ssl(policy) -> Tuple[Optional[ssl.SSLContext], Optional[str]]:
    """(ssl context, SNI/verification name) for a client `TlsPolicy`.

    ``anonymous`` encrypts without verifying the server (the reference's
    TlsPolicy::Anonymous); ``verified`` pins the CA and presents the
    client certificate when configured.
    """
    if policy is None or getattr(policy, "mode", "disabled") == "disabled":
        return None, None
    ctx = ssl.create_default_context(ssl.Purpose.SERVER_AUTH)
    if policy.mode == "anonymous":
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    else:  # verified
        if policy.ca_cert:
            ctx.load_verify_locations(policy.ca_cert)
        if policy.client_cert:
            ctx.load_cert_chain(policy.client_cert, policy.client_key or None)
    return ctx, (policy.domain or None)


@dataclass
class ServerTlsConfig:
    """Endpoint TLS: server cert/key, plus optional client-cert auth."""

    enabled: bool = False
    server_cert: str = ""
    server_key: str = ""
    ca_cert: str = ""  # verify client certificates against this when set
    require_client_cert: bool = False

def server_ssl(cfg: Optional[ServerTlsConfig]) -> Optional[ssl.SSLContext]:
    if cfg is None or not cfg.enabled:
        return None
    if cfg.require_client_cert and not cfg.ca_cert:
        # never downgrade silently: mTLS without a CA to verify against
        # would accept every client as anonymous
        raise ValueError("tls.require_client_cert needs tls.ca_cert")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.server_cert, cfg.server_key)
    if cfg.ca_cert:
        ctx.load_verify_locations(cfg.ca_cert)
        ctx.verify_mode = (
            ssl.CERT_REQUIRED if cfg.require_client_cert else ssl.CERT_OPTIONAL
        )
    return ctx
