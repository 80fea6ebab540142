"""SC<->SPU internal (private) API wire schema.

Capability parity: `fluvio-controlplane` — SPU->SC requests
(sc_api/: `RegisterSpu`, `UpdateLrs`, `ReplicaRemoved`) and SC->SPU push
messages (spu_api/update_{spu,replica,smartmodule}.rs: full-or-delta sync
of SpuSpecs, Replicas, SmartModules). Transport shape mirrors the
reference: the SPU dials the SC private endpoint, registers, and the SC
pushes `InternalUpdate`s down the same connection as a server-push stream;
LRS status flows SPU->SC as serial requests on a second connection.

The port's copy of ``fluvio_tpu/schema/controlplane.py``.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Type

from fluvio_tpu_torch.protocol.api import ApiRequest, Encodable
from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version
from fluvio_tpu_torch.protocol.error import ErrorCode


class InternalScApiKey(enum.IntEnum):
    API_VERSION = 18
    REGISTER_SPU = 2000
    UPDATE_LRS = 2001
    REPLICA_REMOVED = 2002


@dataclass
class Replica(Encodable):
    """One partition assignment pushed to an SPU.

    Parity: fluvio-controlplane/src/replica.rs `Replica{id, leader,
    replicas}` + the mirrored topic config the SPU needs to serve it.
    """

    topic: str = ""
    partition: int = 0
    leader: int = 0
    replicas: List[int] = field(default_factory=list)
    is_being_deleted: bool = False
    # mirrored topic config (dict forms of Deduplication / storage knobs)
    config: Dict[str, Any] = field(default_factory=dict)

    @property
    def replica_key(self) -> str:
        return f"{self.topic}-{self.partition}"

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)
        w.write_i32(self.leader)
        w.write_vec(self.replicas, w.write_i32)
        w.write_bool(self.is_being_deleted)
        w.write_bytes(json.dumps(self.config, separators=(",", ":")).encode())

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "Replica":
        return cls(
            topic=r.read_string(),
            partition=r.read_i32(),
            leader=r.read_i32(),
            replicas=r.read_vec(r.read_i32),
            is_being_deleted=r.read_bool(),
            config=json.loads(r.read_bytes() or b"{}"),
        )


@dataclass
class SpuUpdate(Encodable):
    """SpuSpec mirror pushed to SPUs (spu_api/update_spu.rs)."""

    id: int = 0
    name: str = ""
    public_addr: str = ""
    private_addr: str = ""
    rack: str = ""

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.id)
        w.write_string(self.name)
        w.write_string(self.public_addr)
        w.write_string(self.private_addr)
        w.write_string(self.rack)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "SpuUpdate":
        return cls(
            id=r.read_i32(),
            name=r.read_string(),
            public_addr=r.read_string(),
            private_addr=r.read_string(),
            rack=r.read_string(),
        )


@dataclass
class SmartModuleUpdate(Encodable):
    """Named SmartModule artifact pushed to SPUs (update_smartmodule.rs)."""

    name: str = ""
    payload: bytes = b""

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_bytes(self.payload)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "SmartModuleUpdate":
        return cls(name=r.read_string(), payload=r.read_bytes() or b"")


class UpdateKind(enum.IntEnum):
    SPU = 0
    REPLICA = 1
    SMARTMODULE = 2


@dataclass
class InternalUpdate(Encodable):
    """One SC->SPU push: full sync (``sync_all``) or delta of one kind.

    Parity: UpdateSpuRequest/UpdateReplicaRequest/UpdateSmartModuleRequest
    — the reference sends `all` or `changes` lists per message; deletions
    travel as keys in ``deleted`` (delta) / absence from ``all`` (full).
    """

    kind: UpdateKind = UpdateKind.SPU
    epoch: int = 0
    sync_all: bool = False
    spus: List[SpuUpdate] = field(default_factory=list)
    replicas: List[Replica] = field(default_factory=list)
    smartmodules: List[SmartModuleUpdate] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u8(int(self.kind))
        w.write_i64(self.epoch)
        w.write_bool(self.sync_all)
        w.write_vec(self.spus, lambda s: s.encode(w, version))
        w.write_vec(self.replicas, lambda x: x.encode(w, version))
        w.write_vec(self.smartmodules, lambda m: m.encode(w, version))
        w.write_vec(self.deleted, w.write_string)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "InternalUpdate":
        return cls(
            kind=UpdateKind(r.read_u8()),
            epoch=r.read_i64(),
            sync_all=r.read_bool(),
            spus=r.read_vec(lambda: SpuUpdate.decode(r, version)),
            replicas=r.read_vec(lambda: Replica.decode(r, version)),
            smartmodules=r.read_vec(lambda: SmartModuleUpdate.decode(r, version)),
            deleted=r.read_vec(r.read_string),
        )


@dataclass
class RegisterSpuRequest(ApiRequest):
    """SPU->SC handshake; response stream carries InternalUpdates.

    Parity: sc_api RegisterSpu — the reference validates the SPU id
    against the store and then converts the connection into the push
    channel (private_server.rs).
    """

    API_KEY: ClassVar[int] = InternalScApiKey.REGISTER_SPU
    RESPONSE: ClassVar[Type[Encodable]] = InternalUpdate

    spu_id: int = 0

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.spu_id)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "RegisterSpuRequest":
        return cls(spu_id=r.read_i32())


@dataclass
class ReplicaStatusUpdate(Encodable):
    """One replica's offsets as seen by its SPU (LrsRequest leg)."""

    spu: int = 0
    hw: int = -1
    leo: int = -1

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.spu)
        w.write_i64(self.hw)
        w.write_i64(self.leo)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ReplicaStatusUpdate":
        return cls(spu=r.read_i32(), hw=r.read_i64(), leo=r.read_i64())


@dataclass
class LrsStatus(Encodable):
    """Live-replica status for one partition (sc_api/update_lrs.rs)."""

    topic: str = ""
    partition: int = 0
    leader: ReplicaStatusUpdate = field(default_factory=ReplicaStatusUpdate)
    replicas: List[ReplicaStatusUpdate] = field(default_factory=list)
    size: int = -1

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)
        self.leader.encode(w, version)
        w.write_vec(self.replicas, lambda x: x.encode(w, version))
        w.write_i64(self.size)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "LrsStatus":
        return cls(
            topic=r.read_string(),
            partition=r.read_i32(),
            leader=ReplicaStatusUpdate.decode(r, version),
            replicas=r.read_vec(lambda: ReplicaStatusUpdate.decode(r, version)),
            size=r.read_i64(),
        )


@dataclass
class AckResponse(Encodable):
    error_code: ErrorCode = ErrorCode.NONE

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u16(int(self.error_code))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "AckResponse":
        return cls(error_code=ErrorCode(r.read_u16()))


@dataclass
class UpdateLrsRequest(ApiRequest):
    """SPU->SC batched LRS status report."""

    API_KEY: ClassVar[int] = InternalScApiKey.UPDATE_LRS
    RESPONSE: ClassVar[Type[Encodable]] = AckResponse

    spu_id: int = 0
    updates: List[LrsStatus] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.spu_id)
        w.write_vec(self.updates, lambda x: x.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "UpdateLrsRequest":
        return cls(
            spu_id=r.read_i32(),
            updates=r.read_vec(lambda: LrsStatus.decode(r, version)),
        )


@dataclass
class ReplicaRemovedRequest(ApiRequest):
    """SPU->SC confirmation that a replica's storage was removed."""

    API_KEY: ClassVar[int] = InternalScApiKey.REPLICA_REMOVED
    RESPONSE: ClassVar[Type[Encodable]] = AckResponse

    spu_id: int = 0
    topic: str = ""
    partition: int = 0
    confirmed: bool = True

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.spu_id)
        w.write_string(self.topic)
        w.write_i32(self.partition)
        w.write_bool(self.confirmed)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ReplicaRemovedRequest":
        return cls(
            spu_id=r.read_i32(),
            topic=r.read_string(),
            partition=r.read_i32(),
            confirmed=r.read_bool(),
        )
