"""SC admin (public) API wire schema.

Capability parity: `fluvio-sc-schema` — `AdminPublicApiKey{Create=1001,
Delete=1002, List=1003, Watch=1004}` (apis.rs:19-25) and the generic
`AdminSpec` object framework (objects/{create,delete,list,watch,metadata}.rs).
Where the reference dynamically dispatches binary-encoded per-spec types,
we carry specs/statuses as their canonical dict form (JSON bytes) inside
the same versioned framing: the admin path is cold, and the encoding is
byte-equal to the JAX package's, so the clients and servers of both
packages talk to each other.

The port's copy of ``fluvio_tpu/schema/admin.py``.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional, Type

from fluvio_tpu_torch.metadata.partition import PartitionSpec
from fluvio_tpu_torch.metadata.smartmodule import SmartModuleSpec
from fluvio_tpu_torch.metadata.spg import SpuGroupSpec
from fluvio_tpu_torch.metadata.spu import SpuSpec
from fluvio_tpu_torch.metadata.tableformat import TableFormatSpec
from fluvio_tpu_torch.metadata.topic import TopicSpec
from fluvio_tpu_torch.protocol.api import ApiRequest, Encodable
from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.stream_model.core import MetadataStoreObject


class AdminApiKey(enum.IntEnum):
    API_VERSION = 18
    CREATE = 1001
    DELETE = 1002
    LIST = 1003
    WATCH = 1004


# Kind registry: the wire names every admin object travels under.
# Parity: AdminSpec::LABEL dispatch in fluvio-sc-schema/src/objects/classic.rs.
ADMIN_SPECS: Dict[str, type] = {
    TopicSpec.KIND: TopicSpec,
    SpuSpec.KIND: SpuSpec,
    "custom-spu": SpuSpec,
    SpuGroupSpec.KIND: SpuGroupSpec,
    SmartModuleSpec.KIND: SmartModuleSpec,
    PartitionSpec.KIND: PartitionSpec,
    TableFormatSpec.KIND: TableFormatSpec,
}


def spec_type_for(kind: str) -> type:
    try:
        return ADMIN_SPECS[kind]
    except KeyError:
        raise ValueError(f"unknown admin object kind: {kind!r}") from None


def _write_json(w: ByteWriter, obj: Any) -> None:
    w.write_bytes(json.dumps(obj, separators=(",", ":")).encode())


def _read_json(r: ByteReader) -> Any:
    data = r.read_bytes()
    return json.loads(data) if data else None


@dataclass
class AdminObject(Encodable):
    """One admin-visible object: name + kind + spec/status dict forms.

    Parity: objects/metadata.rs `Metadata<S>`.
    """

    name: str = ""
    kind: str = ""
    spec: Dict[str, Any] = field(default_factory=dict)
    status: Dict[str, Any] = field(default_factory=dict)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_string(self.kind)
        _write_json(w, self.spec)
        _write_json(w, self.status)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "AdminObject":
        return cls(
            name=r.read_string(),
            kind=r.read_string(),
            spec=_read_json(r) or {},
            status=_read_json(r) or {},
        )

    @classmethod
    def from_store_object(cls, obj: MetadataStoreObject) -> "AdminObject":
        return cls(
            name=obj.key,
            kind=type(obj.spec).KIND,
            spec=obj.spec.to_dict(),
            status=obj.status.to_dict() if obj.status is not None else {},
        )

    def to_store_object(self) -> MetadataStoreObject:
        spec_type = spec_type_for(self.kind)
        return MetadataStoreObject.from_dict(
            spec_type,
            {"key": self.name, "spec": self.spec, "status": self.status},
        )


@dataclass
class AdminStatus(Encodable):
    """Create/Delete outcome (parity: objects/create.rs Status)."""

    name: str = ""
    error_code: ErrorCode = ErrorCode.NONE
    error_message: str = ""

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_u16(int(self.error_code))
        w.write_string(self.error_message)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "AdminStatus":
        return cls(
            name=r.read_string(),
            error_code=ErrorCode(r.read_u16()),
            error_message=r.read_string(),
        )

    def as_error(self) -> Optional[str]:
        if self.error_code == ErrorCode.NONE:
            return None
        return self.error_message or self.error_code.name


@dataclass
class CreateRequest(ApiRequest):
    """Create one object (parity: objects/create.rs ObjectApiCreateRequest)."""

    API_KEY: ClassVar[int] = AdminApiKey.CREATE
    RESPONSE: ClassVar[Type[Encodable]] = AdminStatus

    name: str = ""
    kind: str = ""
    spec: Dict[str, Any] = field(default_factory=dict)
    dry_run: bool = False
    timeout_ms: int = 0  # 0 = don't wait for provisioning

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_string(self.kind)
        _write_json(w, self.spec)
        w.write_bool(self.dry_run)
        w.write_i32(self.timeout_ms)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "CreateRequest":
        return cls(
            name=r.read_string(),
            kind=r.read_string(),
            spec=_read_json(r) or {},
            dry_run=r.read_bool(),
            timeout_ms=r.read_i32(),
        )


@dataclass
class DeleteRequest(ApiRequest):
    """Delete by key (parity: objects/delete.rs)."""

    API_KEY: ClassVar[int] = AdminApiKey.DELETE
    RESPONSE: ClassVar[Type[Encodable]] = AdminStatus

    name: str = ""
    kind: str = ""

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_string(self.kind)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "DeleteRequest":
        return cls(name=r.read_string(), kind=r.read_string())


@dataclass
class ListResponse(Encodable):
    error_code: ErrorCode = ErrorCode.NONE
    error_message: str = ""
    objects: List[AdminObject] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u16(int(self.error_code))
        w.write_string(self.error_message)
        w.write_vec(self.objects, lambda o: o.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ListResponse":
        return cls(
            error_code=ErrorCode(r.read_u16()),
            error_message=r.read_string(),
            objects=r.read_vec(lambda: AdminObject.decode(r, version)),
        )


@dataclass
class ListRequest(ApiRequest):
    """List objects of a kind, optional name filters (objects/list.rs)."""

    API_KEY: ClassVar[int] = AdminApiKey.LIST
    RESPONSE: ClassVar[Type[Encodable]] = ListResponse

    kind: str = ""
    name_filters: List[str] = field(default_factory=list)
    summary: bool = False

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.kind)
        w.write_vec(self.name_filters, w.write_string)
        w.write_bool(self.summary)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ListRequest":
        return cls(
            kind=r.read_string(),
            name_filters=r.read_vec(r.read_string),
            summary=r.read_bool(),
        )


@dataclass
class WatchResponse(Encodable):
    """One epoch-stamped update pushed on a watch stream.

    Parity: objects/watch.rs `ObjectApiWatchResponse` carrying
    `UpdatedObjects{epoch, changes|all}`. ``all`` non-empty means full
    resync at ``epoch``; otherwise ``changes``/``deleted`` are deltas.
    """

    epoch: int = 0
    all_objects: List[AdminObject] = field(default_factory=list)
    changes: List[AdminObject] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)
    is_sync_all: bool = False
    error_code: ErrorCode = ErrorCode.NONE  # stream-fatal (e.g. denied)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i64(self.epoch)
        w.write_bool(self.is_sync_all)
        w.write_vec(self.all_objects, lambda o: o.encode(w, version))
        w.write_vec(self.changes, lambda o: o.encode(w, version))
        w.write_vec(self.deleted, w.write_string)
        w.write_i16(int(self.error_code))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "WatchResponse":
        return cls(
            epoch=r.read_i64(),
            is_sync_all=r.read_bool(),
            all_objects=r.read_vec(lambda: AdminObject.decode(r, version)),
            changes=r.read_vec(lambda: AdminObject.decode(r, version)),
            deleted=r.read_vec(r.read_string),
            error_code=ErrorCode(r.read_i16()),
        )


@dataclass
class WatchRequest(ApiRequest):
    """Open a push stream of metadata updates for one kind (objects/watch.rs)."""

    API_KEY: ClassVar[int] = AdminApiKey.WATCH
    RESPONSE: ClassVar[Type[Encodable]] = WatchResponse

    kind: str = ""
    summary: bool = False

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.kind)
        w.write_bool(self.summary)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "WatchRequest":
        return cls(kind=r.read_string(), summary=r.read_bool())
