"""SPU<->SPU internal (peer) API wire schema: follower replication.

The port's copy of ``fluvio_tpu/schema/internal_spu.py`` (parity:
fluvio-spu/src/services/internal/ and the replication messages in
fluvio-spu/src/replication/{leader,follower}/sync.rs). A follower dials
its leader's private endpoint and opens a sync stream naming the replicas
it follows with its offsets (`FollowerSyncRequest`); the leader pushes
record batches with its HW and LEO a replica (`SyncRecords`), and the
follower reports its offsets back as serial requests on the same
connection (`FollowerOffsetsRequest`), from which the leader advances
its high watermark. Every type encodes byte-equal to the JAX package's.

`SyncRecords.decode` keeps each pushed batch's record section as it came
(``raw_records``): the follower appends the leader's batches unparsed, so
its log holds the leader's bytes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, List, Type

from fluvio_tpu_torch.protocol.api import ApiRequest, Encodable
from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.protocol.record import RecordSet


class InternalSpuApiKey(enum.IntEnum):
    API_VERSION = 18
    FETCH_STREAM = 3000
    FOLLOWER_OFFSETS = 3001


@dataclass
class ReplicaOffsets(Encodable):
    """One replica's offsets as seen by a follower."""

    topic: str = ""
    partition: int = 0
    leo: int = -1
    hw: int = -1

    @property
    def replica_key(self) -> str:
        return f"{self.topic}-{self.partition}"

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)
        w.write_i64(self.leo)
        w.write_i64(self.hw)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ReplicaOffsets":
        return cls(
            topic=r.read_string(),
            partition=r.read_i32(),
            leo=r.read_i64(),
            hw=r.read_i64(),
        )


@dataclass
class SyncRecords(Encodable):
    """Leader->follower push: records from the follower's LEO onward.

    Parity: the leader's sync response in replication/leader — batches
    carry leader-assigned offsets; ``leader_hw``/``leader_leo`` let the
    follower advance its own HW (bounded by what it has locally).
    """

    topic: str = ""
    partition: int = 0
    error_code: ErrorCode = ErrorCode.NONE
    leader_leo: int = -1
    leader_hw: int = -1
    records: RecordSet = field(default_factory=RecordSet)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)
        w.write_u16(int(self.error_code))
        w.write_i64(self.leader_leo)
        w.write_i64(self.leader_hw)
        self.records.encode(w, version)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "SyncRecords":
        return cls(
            topic=r.read_string(),
            partition=r.read_i32(),
            error_code=ErrorCode(r.read_u16()),
            leader_leo=r.read_i64(),
            leader_hw=r.read_i64(),
            records=RecordSet.decode(r, version, parse_records=False),
        )


@dataclass
class FollowerSyncRequest(ApiRequest):
    """Follower->leader: open the sync stream for a set of replicas."""

    API_KEY: ClassVar[int] = InternalSpuApiKey.FETCH_STREAM
    RESPONSE: ClassVar[Type[Encodable]] = SyncRecords

    follower_id: int = 0
    replicas: List[ReplicaOffsets] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.follower_id)
        w.write_vec(self.replicas, lambda x: x.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FollowerSyncRequest":
        return cls(
            follower_id=r.read_i32(),
            replicas=r.read_vec(lambda: ReplicaOffsets.decode(r, version)),
        )


@dataclass
class FollowerOffsetsAck(Encodable):
    error_code: ErrorCode = ErrorCode.NONE

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u16(int(self.error_code))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FollowerOffsetsAck":
        return cls(error_code=ErrorCode(r.read_u16()))


@dataclass
class FollowerOffsetsRequest(ApiRequest):
    """Follower->leader offset report after applying synced records.

    Parity: the follower's offset update that feeds
    `update_states_from_followers` (replica_state.rs:172).
    """

    API_KEY: ClassVar[int] = InternalSpuApiKey.FOLLOWER_OFFSETS
    RESPONSE: ClassVar[Type[Encodable]] = FollowerOffsetsAck

    follower_id: int = 0
    offsets: List[ReplicaOffsets] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.follower_id)
        w.write_vec(self.offsets, lambda x: x.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FollowerOffsetsRequest":
        return cls(
            follower_id=r.read_i32(),
            offsets=r.read_vec(lambda: ReplicaOffsets.decode(r, version)),
        )
