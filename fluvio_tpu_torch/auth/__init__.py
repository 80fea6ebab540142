"""Authorization layer of the SC's admin API (the port's copy of
``fluvio_tpu/auth``; parity: the `fluvio-auth` crate + fluvio-sc auth).

- :mod:`policy` — `TypeAction`/`InstanceAction`/`ObjectType`, the
  `AuthContext`/`Authorization` interfaces, and the built-in Root /
  ReadOnly policies (fluvio-auth/src/policy.rs).
- :mod:`basic` — role-based policy evaluated against identity scopes,
  loadable from a JSON policy file (fluvio-sc/src/services/auth/basic.rs).
- :mod:`identity` — connection identity (`X509Identity` analog,
  fluvio-auth/src/x509/identity.rs).
"""

from fluvio_tpu_torch.auth.policy import (  # noqa: F401
    AuthContext,
    Authorization,
    InstanceAction,
    ObjectType,
    ReadOnlyAuthorization,
    RootAuthorization,
    TypeAction,
)
from fluvio_tpu_torch.auth.basic import BasicAuthorization, BasicRbacPolicy  # noqa: F401
from fluvio_tpu_torch.auth.identity import Identity  # noqa: F401
