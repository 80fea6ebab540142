"""Authorization of the SC's admin API (the port's copy of the part of
``fluvio_tpu/auth`` the SC's public service checks; parity: the
`fluvio-auth` crate). Only `RootAuthorization`, which allows every
action, is ported: the read-only and role-based policies are not."""

from fluvio_tpu_torch.auth.policy import (  # noqa: F401
    InstanceAction,
    ObjectType,
    RootAuthorization,
    TypeAction,
)
