"""SPU public-API wire schema (the port's copy of
``fluvio_tpu/schema/spu.py``).

Capability parity: `fluvio-spu-schema` — api keys
(server/api_key.rs:13-23: Produce=0, Fetch=1, FetchOffsets=1002,
StreamFetch=1003, UpdateOffsets=1005, ApiVersion=18), produce
request/response (server/produce.rs via fluvio-protocol), stream fetch
(server/stream_fetch.rs:61), offset fetch/update (server/{offset,
update_offset}.rs), and `Isolation` (isolation.rs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, List, Type

from fluvio_tpu_torch.protocol.api import MAX_BYTES, ApiRequest, Encodable
from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocation
from fluvio_tpu_torch.protocol.record import RecordSet


class SpuServerApiKey(enum.IntEnum):
    PRODUCE = 0
    FETCH = 1
    API_VERSION = 18
    FETCH_OFFSETS = 1002
    STREAM_FETCH = 1003
    UPDATE_OFFSETS = 1005


class Isolation(enum.IntEnum):
    """Read bound: LEO (uncommitted) vs HW (committed)."""

    READ_UNCOMMITTED = 0
    READ_COMMITTED = 1


# ---------------------------------------------------------------------------
# Produce (api key 0)
# ---------------------------------------------------------------------------


@dataclass
class PartitionProduceData:
    partition_index: int = 0
    records: RecordSet = field(default_factory=RecordSet)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.partition_index)
        self.records.encode(w, version)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "PartitionProduceData":
        # full parse at ingest: malformed record framing must fail the
        # produce, not surface at consume time from the durable log
        return cls(
            partition_index=r.read_i32(),
            records=RecordSet.decode(r, version),
        )


@dataclass
class TopicProduceData:
    name: str = ""
    partitions: List[PartitionProduceData] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_vec(self.partitions, lambda p: p.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "TopicProduceData":
        return cls(
            name=r.read_string(),
            partitions=r.read_vec(lambda: PartitionProduceData.decode(r, version)),
        )


@dataclass
class PartitionProduceResponse(Encodable):
    partition_index: int = 0
    error_code: ErrorCode = ErrorCode.NONE
    base_offset: int = -1
    error_message: str = ""

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.partition_index)
        w.write_u16(int(self.error_code))
        w.write_i64(self.base_offset)
        w.write_string(self.error_message)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "PartitionProduceResponse":
        return cls(
            partition_index=r.read_i32(),
            error_code=ErrorCode(r.read_u16()),
            base_offset=r.read_i64(),
            error_message=r.read_string(),
        )


@dataclass
class TopicProduceResponse(Encodable):
    name: str = ""
    partitions: List[PartitionProduceResponse] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.name)
        w.write_vec(self.partitions, lambda p: p.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "TopicProduceResponse":
        return cls(
            name=r.read_string(),
            partitions=r.read_vec(lambda: PartitionProduceResponse.decode(r, version)),
        )


@dataclass
class ProduceResponse(Encodable):
    responses: List[TopicProduceResponse] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_vec(self.responses, lambda t: t.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ProduceResponse":
        return cls(responses=r.read_vec(lambda: TopicProduceResponse.decode(r, version)))

    def find_partition(self, topic: str, partition: int) -> PartitionProduceResponse:
        for t in self.responses:
            if t.name == topic:
                for p in t.partitions:
                    if p.partition_index == partition:
                        return p
        raise KeyError(f"{topic}-{partition} missing from produce response")


@dataclass
class ProduceRequest(ApiRequest):
    API_KEY: ClassVar[int] = SpuServerApiKey.PRODUCE
    MAX_API_VERSION: ClassVar[int] = 7
    DEFAULT_API_VERSION: ClassVar[int] = 7
    RESPONSE: ClassVar[Type[Encodable]] = ProduceResponse

    isolation: Isolation = Isolation.READ_UNCOMMITTED  # acks semantics
    timeout_ms: int = 1500
    topics: List[TopicProduceData] = field(default_factory=list)
    smartmodules: List[SmartModuleInvocation] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u8(int(self.isolation))
        w.write_i32(self.timeout_ms)
        w.write_vec(self.topics, lambda t: t.encode(w, version))
        w.write_vec(self.smartmodules, lambda s: s.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ProduceRequest":
        return cls(
            isolation=Isolation(r.read_u8()),
            timeout_ms=r.read_i32(),
            topics=r.read_vec(lambda: TopicProduceData.decode(r, version)),
            smartmodules=r.read_vec(lambda: SmartModuleInvocation.decode(r, version)),
        )


# ---------------------------------------------------------------------------
# Fetch (api key 1) — bounded one-shot read
# ---------------------------------------------------------------------------


@dataclass
class FetchablePartitionResponse(Encodable):
    """Partition payload shared by Fetch and StreamFetch responses."""

    partition_index: int = 0
    error_code: ErrorCode = ErrorCode.NONE
    error_message: str = ""  # transform runtime error detail
    high_watermark: int = -1
    log_start_offset: int = -1
    next_filter_offset: int = -1  # SmartModule streams: next offset to poll
    records: RecordSet = field(default_factory=RecordSet)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.partition_index)
        w.write_u16(int(self.error_code))
        w.write_string(self.error_message)
        w.write_i64(self.high_watermark)
        w.write_i64(self.log_start_offset)
        w.write_i64(self.next_filter_offset)
        self.records.encode(w, version)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FetchablePartitionResponse":
        return cls(
            partition_index=r.read_i32(),
            error_code=ErrorCode(r.read_u16()),
            error_message=r.read_string(),
            high_watermark=r.read_i64(),
            log_start_offset=r.read_i64(),
            next_filter_offset=r.read_i64(),
            # shallow: consumers parse records lazily (batch-level APIs
            # never pay the per-record decode)
            records=RecordSet.decode(r, version, parse_records=False),
        )


@dataclass
class FetchResponse(Encodable):
    topic: str = ""
    partition: FetchablePartitionResponse = field(
        default_factory=FetchablePartitionResponse
    )

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        self.partition.encode(w, version)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FetchResponse":
        return cls(
            topic=r.read_string(),
            partition=FetchablePartitionResponse.decode(r, version),
        )


@dataclass
class FetchRequest(ApiRequest):
    API_KEY: ClassVar[int] = SpuServerApiKey.FETCH
    MAX_API_VERSION: ClassVar[int] = 4
    DEFAULT_API_VERSION: ClassVar[int] = 4
    RESPONSE: ClassVar[Type[Encodable]] = FetchResponse

    topic: str = ""
    partition: int = 0
    fetch_offset: int = 0
    max_bytes: int = MAX_BYTES
    isolation: Isolation = Isolation.READ_UNCOMMITTED

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)
        w.write_i64(self.fetch_offset)
        w.write_i32(self.max_bytes)
        w.write_u8(int(self.isolation))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FetchRequest":
        return cls(
            topic=r.read_string(),
            partition=r.read_i32(),
            fetch_offset=r.read_i64(),
            max_bytes=r.read_i32(),
            isolation=Isolation(r.read_u8()),
        )


# ---------------------------------------------------------------------------
# FetchOffsets (api key 1002)
# ---------------------------------------------------------------------------


@dataclass
class FetchOffsetsResponse(Encodable):
    error_code: ErrorCode = ErrorCode.NONE
    start_offset: int = -1
    hw: int = -1
    leo: int = -1

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u16(int(self.error_code))
        w.write_i64(self.start_offset)
        w.write_i64(self.hw)
        w.write_i64(self.leo)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FetchOffsetsResponse":
        return cls(
            error_code=ErrorCode(r.read_u16()),
            start_offset=r.read_i64(),
            hw=r.read_i64(),
            leo=r.read_i64(),
        )


@dataclass
class FetchOffsetsRequest(ApiRequest):
    API_KEY: ClassVar[int] = SpuServerApiKey.FETCH_OFFSETS
    RESPONSE: ClassVar[Type[Encodable]] = FetchOffsetsResponse

    topic: str = ""
    partition: int = 0

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "FetchOffsetsRequest":
        return cls(topic=r.read_string(), partition=r.read_i32())


# ---------------------------------------------------------------------------
# StreamFetch (api key 1003) — server-push consumer stream
# ---------------------------------------------------------------------------


@dataclass
class StreamFetchResponse(Encodable):
    topic: str = ""
    partition_index: int = 0
    stream_id: int = 0
    partition: FetchablePartitionResponse = field(
        default_factory=FetchablePartitionResponse
    )

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition_index)
        w.write_i32(self.stream_id)
        self.partition.encode(w, version)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "StreamFetchResponse":
        return cls(
            topic=r.read_string(),
            partition_index=r.read_i32(),
            stream_id=r.read_i32(),
            partition=FetchablePartitionResponse.decode(r, version),
        )


@dataclass
class StreamFetchRequest(ApiRequest):
    """Open a push stream (parity: stream_fetch.rs:61).

    The server replies on the same correlation id indefinitely; the client
    acks consumed offsets with UpdateOffsetsRequest carrying the stream_id
    from the first response.
    """

    API_KEY: ClassVar[int] = SpuServerApiKey.STREAM_FETCH
    MAX_API_VERSION: ClassVar[int] = 23
    DEFAULT_API_VERSION: ClassVar[int] = 23
    RESPONSE: ClassVar[Type[Encodable]] = StreamFetchResponse

    topic: str = ""
    partition: int = 0
    fetch_offset: int = 0
    max_bytes: int = MAX_BYTES
    isolation: Isolation = Isolation.READ_UNCOMMITTED
    smartmodules: List[SmartModuleInvocation] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.topic)
        w.write_i32(self.partition)
        w.write_i64(self.fetch_offset)
        w.write_i32(self.max_bytes)
        w.write_u8(int(self.isolation))
        w.write_vec(self.smartmodules, lambda s: s.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "StreamFetchRequest":
        return cls(
            topic=r.read_string(),
            partition=r.read_i32(),
            fetch_offset=r.read_i64(),
            max_bytes=r.read_i32(),
            isolation=Isolation(r.read_u8()),
            smartmodules=r.read_vec(lambda: SmartModuleInvocation.decode(r, version)),
        )


# ---------------------------------------------------------------------------
# UpdateOffsets (api key 1005) — consumer ack / flow control
# ---------------------------------------------------------------------------


@dataclass
class OffsetUpdate:
    offset: int = 0
    session_id: int = 0  # stream_id from StreamFetchResponse

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i64(self.offset)
        w.write_i32(self.session_id)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "OffsetUpdate":
        return cls(offset=r.read_i64(), session_id=r.read_i32())


@dataclass
class OffsetUpdateStatus(Encodable):
    session_id: int = 0
    error_code: ErrorCode = ErrorCode.NONE

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.session_id)
        w.write_u16(int(self.error_code))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "OffsetUpdateStatus":
        return cls(session_id=r.read_i32(), error_code=ErrorCode(r.read_u16()))


@dataclass
class UpdateOffsetsResponse(Encodable):
    offsets: List[OffsetUpdateStatus] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_vec(self.offsets, lambda o: o.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "UpdateOffsetsResponse":
        return cls(offsets=r.read_vec(lambda: OffsetUpdateStatus.decode(r, version)))


@dataclass
class UpdateOffsetsRequest(ApiRequest):
    API_KEY: ClassVar[int] = SpuServerApiKey.UPDATE_OFFSETS
    RESPONSE: ClassVar[Type[Encodable]] = UpdateOffsetsResponse

    offsets: List[OffsetUpdate] = field(default_factory=list)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_vec(self.offsets, lambda o: o.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "UpdateOffsetsRequest":
        return cls(offsets=r.read_vec(lambda: OffsetUpdate.decode(r, version)))


SPU_PUBLIC_REQUESTS: dict[int, Type[ApiRequest]] = {
    SpuServerApiKey.PRODUCE: ProduceRequest,
    SpuServerApiKey.FETCH: FetchRequest,
    SpuServerApiKey.FETCH_OFFSETS: FetchOffsetsRequest,
    SpuServerApiKey.STREAM_FETCH: StreamFetchRequest,
    SpuServerApiKey.UPDATE_OFFSETS: UpdateOffsetsRequest,
}
