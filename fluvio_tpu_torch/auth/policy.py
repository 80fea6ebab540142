"""Authorization interfaces and the allow-all policy.

The port's copy of the parts of ``fluvio_tpu/auth/policy.py`` the SC uses
(parity: fluvio-auth/src/policy.rs): `TypeAction{Create,Read}`,
`InstanceAction{Delete}`, the object classes and the SC's built-in
`RootAuthorization`, whose per-connection context answers
`allow_type_action` / `allow_instance_action` with yes.
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


class RootAuthContext:
    """Allow everything (parity: the SC's `RootAuthorization`)."""

    def allow_type_action(self, ty, action) -> bool:
        return True

    def allow_instance_action(self, ty, action, key) -> bool:
        return True


class RootAuthorization:
    """One `RootAuthContext` per accepted connection."""

    def create_auth_context(self, socket) -> RootAuthContext:
        return RootAuthContext()
