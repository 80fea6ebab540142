"""Authorization interfaces and built-in policies (the port's copy of
``fluvio_tpu/auth/policy.py``).

Capability parity: fluvio-auth/src/policy.rs — `TypeAction{Create,Read}`,
`InstanceAction{Delete}`, `AuthContext::{allow_type_action,
allow_instance_action}`, `Authorization::create_auth_context(socket)` —
plus the SC's built-in Root (allow-all) and ReadOnly authorizators
(fluvio-sc/src/services/auth/mod.rs).
"""

from __future__ import annotations

import enum


class TypeAction(enum.Enum):
    CREATE = "Create"
    READ = "Read"


class InstanceAction(enum.Enum):
    DELETE = "Delete"


class ObjectType(enum.Enum):
    """Admin-visible object classes (controlplane-metadata/src/lib.rs:24)."""

    SPU = "Spu"
    CUSTOM_SPU = "CustomSpu"
    SPU_GROUP = "SpuGroup"
    TOPIC = "Topic"
    PARTITION = "Partition"
    SMARTMODULE = "SmartModule"
    TABLE_FORMAT = "TableFormat"

    @classmethod
    def from_kind(cls, kind: str) -> "ObjectType":
        """Map an admin API object kind string to its auth class."""
        return _KIND_MAP[kind]


_KIND_MAP = {
    "spu": ObjectType.SPU,
    "custom-spu": ObjectType.CUSTOM_SPU,
    "spugroup": ObjectType.SPU_GROUP,  # SpuGroupSpec.KIND wire string
    "spu-group": ObjectType.SPU_GROUP,
    "spg": ObjectType.SPU_GROUP,
    "topic": ObjectType.TOPIC,
    "partition": ObjectType.PARTITION,
    "smartmodule": ObjectType.SMARTMODULE,
    "tableformat": ObjectType.TABLE_FORMAT,
}


class AuthContext:
    """Per-connection authorization decisions."""

    def allow_type_action(self, ty: ObjectType, action: TypeAction) -> bool:
        raise NotImplementedError

    def allow_instance_action(
        self, ty: ObjectType, action: InstanceAction, key: str
    ) -> bool:
        raise NotImplementedError


class Authorization:
    """Factory: one AuthContext per accepted connection."""

    def create_auth_context(self, socket) -> AuthContext:
        raise NotImplementedError


class RootAuthContext(AuthContext):
    """Allow everything (parity: the SC's `RootAuthorization`)."""

    def allow_type_action(self, ty, action) -> bool:
        return True

    def allow_instance_action(self, ty, action, key) -> bool:
        return True


class RootAuthorization(Authorization):
    def create_auth_context(self, socket) -> RootAuthContext:
        return RootAuthContext()


class ReadOnlyAuthContext(AuthContext):
    """Allow reads only (parity: the SC's `ReadOnlyAuthorization`, used
    by the read-only run mode)."""

    def allow_type_action(self, ty, action) -> bool:
        return action == TypeAction.READ

    def allow_instance_action(self, ty, action, key) -> bool:
        return False


class ReadOnlyAuthorization(Authorization):
    def create_auth_context(self, socket) -> ReadOnlyAuthContext:
        return ReadOnlyAuthContext()
