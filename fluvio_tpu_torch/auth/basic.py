"""Role-based authorization from a policy file (the port's copy of
``fluvio_tpu/auth/basic.py``).

Capability parity: fluvio-sc/src/services/auth/basic.rs — a
`BasicRbacPolicy` mapping role -> object type -> allowed actions
(`Create/Read/Update/Delete/All`), evaluated against the connection
identity's scopes; loadable from a JSON policy file; defaulting to a
Root-only allow-all policy.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from fluvio_tpu_torch.auth.identity import Identity
from fluvio_tpu_torch.auth.policy import (
    AuthContext,
    Authorization,
    InstanceAction,
    ObjectType,
    TypeAction,
)

ALL_ACTION = "All"

_TYPE_ACTION_NAME = {TypeAction.CREATE: "Create", TypeAction.READ: "Read"}
_INSTANCE_ACTION_NAME = {InstanceAction.DELETE: "Delete"}


@dataclass
class BasicRbacPolicy:
    """role -> object type name -> action names (basic.rs BasicRbacPolicy)."""

    roles: Dict[str, Dict[str, List[str]]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "BasicRbacPolicy":
        with open(path) as f:
            return cls(roles=json.load(f))

    @classmethod
    def default_root(cls) -> "BasicRbacPolicy":
        """Root role gets All on every object type (basic.rs Default)."""
        return cls(
            roles={"Root": {ty.value: [ALL_ACTION] for ty in ObjectType}}
        )

    def evaluate(self, action_name: str, ty: ObjectType, identity: Identity) -> bool:
        for scope in identity.scopes:
            objects = self.roles.get(scope)
            if not objects:
                continue
            actions = objects.get(ty.value)
            if actions and (action_name in actions or ALL_ACTION in actions):
                return True
        return False


class BasicAuthContext(AuthContext):
    def __init__(self, identity: Identity, policy: BasicRbacPolicy):
        self.identity = identity
        self.policy = policy

    def allow_type_action(self, ty: ObjectType, action: TypeAction) -> bool:
        return self.policy.evaluate(_TYPE_ACTION_NAME[action], ty, self.identity)

    def allow_instance_action(
        self, ty: ObjectType, action: InstanceAction, key: str
    ) -> bool:
        return self.policy.evaluate(
            _INSTANCE_ACTION_NAME[action], ty, self.identity
        )


class BasicAuthorization(Authorization):
    """Scope-evaluated policy; identity from an authenticator callback.

    The reference extracts identity from the TLS client cert
    (X509Identity::create_from_connection); plaintext transports pass an
    ``authenticator`` that attests the peer (defaulting to anonymous).
    """

    def __init__(
        self,
        policy: Optional[BasicRbacPolicy] = None,
        authenticator: Optional[Callable[[object], Identity]] = None,
    ):
        self.policy = policy or BasicRbacPolicy.default_root()
        self.authenticator = authenticator

    def create_auth_context(self, socket) -> BasicAuthContext:
        if self.authenticator is not None:
            identity = self.authenticator(socket)
        else:
            identity = Identity.anonymous()
        return BasicAuthContext(identity, self.policy)
