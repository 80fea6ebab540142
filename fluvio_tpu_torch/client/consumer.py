"""Partition consumer: push-stream with auto offset acks.

The port's copy of ``fluvio_tpu/client/consumer.py`` (parity:
fluvio/src/consumer.rs): `PartitionConsumer.stream_batches` opens a
StreamFetchRequest over the multiplexer, yields the pushed batches and
sends an `UpdateOffsetsRequest` ack after each response so the server
keeps pushing; `stream` decodes them into `ConsumerRecord`s.
`MultiplePartitionConsumer` merges one such stream per partition of a
`PartitionSelectionStrategy` (per-partition order kept, no order across
partitions).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import AsyncIterator, List, Optional

from fluvio_tpu_torch.protocol.api import MAX_BYTES
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.client.offset import Offset
from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocation
from fluvio_tpu_torch.schema.spu import (
    FetchOffsetsRequest,
    Isolation,
    OffsetUpdate,
    StreamFetchRequest,
    UpdateOffsetsRequest,
)
from fluvio_tpu_torch.types import Timestamp


@dataclass
class ConsumerConfig:
    max_bytes: int = MAX_BYTES
    isolation: Isolation = Isolation.READ_UNCOMMITTED
    smartmodules: List[SmartModuleInvocation] = field(default_factory=list)
    # stop the stream once the log end at stream-start is reached
    # (parity: `fluvio consume -d`)
    disable_continuous: bool = False


@dataclass
class ConsumerRecord:
    partition: int
    offset: int
    timestamp: Timestamp
    key: Optional[bytes]
    value: bytes


@dataclass
class PartitionSelectionStrategy:
    """Which partitions a consumer covers (parity: consumer.rs:590-720).

    ``all(topic)`` resolves the topic's full partition set at consume
    time; ``multiple(topic, partitions)`` pins an explicit list.
    """

    topic: str = ""
    partitions: Optional[List[int]] = None  # None = all partitions

    @classmethod
    def all(cls, topic: str) -> "PartitionSelectionStrategy":
        return cls(topic=topic, partitions=None)

    @classmethod
    def multiple(cls, topic: str, partitions: List[int]) -> "PartitionSelectionStrategy":
        return cls(topic=topic, partitions=list(partitions))


class MultiplePartitionConsumer:
    """Merged stream over several partitions (consumer.rs:590-720).

    One push stream per partition (each with its own ack flow), merged
    by arrival order through a queue — the reference's
    `MultiplePartitionConsumer` semantics: no global ordering across
    partitions, per-partition order preserved.
    """

    def __init__(self, consumers: List["PartitionConsumer"]):
        self.consumers = consumers

    async def stream(
        self,
        offset: "Offset",
        config: Optional[ConsumerConfig] = None,
    ) -> AsyncIterator[ConsumerRecord]:
        config = config or ConsumerConfig()
        queue: asyncio.Queue = asyncio.Queue(maxsize=64)
        _DONE = object()

        async def pump(consumer: "PartitionConsumer"):
            try:
                async for record in consumer.stream(offset, config):
                    await queue.put(record)
                await queue.put(_DONE)
            except asyncio.CancelledError:
                # shutdown path: never re-enter the (possibly full) queue —
                # a blocked put here would deadlock the closing reader
                raise
            except BaseException as e:  # noqa: BLE001 — surfaced to the reader
                await queue.put(e)

        tasks = [asyncio.ensure_future(pump(c)) for c in self.consumers]
        live = len(tasks)
        try:
            while live:
                item = await queue.get()
                if item is _DONE:
                    live -= 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)


class PartitionConsumer:
    """Consumer for one topic-partition (parity: consumer.rs:77)."""

    def __init__(self, topic: str, partition: int, socket):
        self.topic = topic
        self.partition = partition
        self._socket = socket  # VersionedSerialSocket to the leader SPU

    async def fetch_offsets(self):
        resp = await self._socket.send_receive(
            FetchOffsetsRequest(topic=self.topic, partition=self.partition)
        )
        if resp.error_code != ErrorCode.NONE:
            raise FluvioError(resp.error_code)
        return resp

    async def stream_batches(
        self,
        offset: Offset,
        config: Optional[ConsumerConfig] = None,
        start: Optional[int] = None,
        end_at: Optional[int] = None,
    ) -> AsyncIterator["Batch"]:
        """Yield raw (shallow-decoded) batches from ``offset`` onward.

        The batch-level consumer surface: records inside each batch stay
        wire-encoded (``batch.raw_records``) until the caller asks for
        ``memory_records()``, so high-throughput consumers never pay a
        per-record Python decode. Offsets are acked per response exactly
        as `stream` does. ``start``/``end_at`` are pre-resolved bounds
        passed by `stream` so offset resolution happens exactly once.
        """
        config = config or ConsumerConfig()
        if start is None:
            offsets = await self.fetch_offsets()
            start = offset.resolve(offsets, config.isolation)
            end_at = None
            if config.disable_continuous:
                end_at = (
                    offsets.hw
                    if config.isolation == Isolation.READ_COMMITTED
                    else offsets.leo
                )
                if start >= end_at:
                    return
        else:
            end_at = end_at if config.disable_continuous else None

        request = StreamFetchRequest(
            topic=self.topic,
            partition=self.partition,
            fetch_offset=start,
            max_bytes=config.max_bytes,
            isolation=config.isolation,
            smartmodules=list(config.smartmodules),
        )
        stream = await self._socket.create_stream(request)
        try:
            async for response in stream:
                part = response.partition
                if part.error_code != ErrorCode.NONE:
                    raise FluvioError(part.error_code, part.error_message)
                last_seen = start - 1
                for batch in part.records.batches:
                    yield batch
                    last_seen = max(last_seen, batch.computed_last_offset() - 1)
                # next offset to continue from: the engine's filter cursor
                # when present, else the last stored offset we decoded
                next_offset = (
                    part.next_filter_offset
                    if part.next_filter_offset >= 0
                    else last_seen + 1
                )
                await self._socket.send_async(
                    UpdateOffsetsRequest(
                        offsets=[
                            OffsetUpdate(
                                offset=next_offset, session_id=response.stream_id
                            )
                        ]
                    )
                )
                if end_at is not None and next_offset >= end_at:
                    return
        finally:
            await stream.close()

    async def stream(
        self,
        offset: Offset,
        config: Optional[ConsumerConfig] = None,
    ) -> AsyncIterator[ConsumerRecord]:
        """Yield records from ``offset`` onward, acking as it goes."""
        config = config or ConsumerConfig()
        offsets = await self.fetch_offsets()
        start = offset.resolve(offsets, config.isolation)
        end_at = None
        if config.disable_continuous:
            end_at = (
                offsets.hw
                if config.isolation == Isolation.READ_COMMITTED
                else offsets.leo
            )
            if start >= end_at:
                return
        # ``position`` tracks the consume cursor: records below it were
        # already delivered (a broker resuming mid-batch re-serves from
        # the batch start — reference consumers skip client-side). Equal
        # offsets are NOT skipped: array_map fan-out legitimately emits
        # several records at one source offset, and a record at the
        # cursor itself was never delivered (the cursor is the broker's
        # next_filter_offset, one past the last served record).
        position = start
        async for batch in self.stream_batches(
            offset, config, start=start, end_at=end_at
        ):
            base = batch.base_offset
            ts = batch.header.first_timestamp
            for rec in batch.memory_records():
                abs_offset = base + rec.offset_delta
                if abs_offset < position:
                    continue  # already delivered (or before the start)
                yield ConsumerRecord(
                    partition=self.partition,
                    offset=abs_offset,
                    timestamp=(
                        ts + rec.timestamp_delta if ts >= 0 else -1
                    ),
                    key=rec.key,
                    value=rec.value,
                )
            position = max(position, batch.computed_last_offset())
