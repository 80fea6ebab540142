"""Topic producer: batching accumulator + background flush.

Capability parity: fluvio/src/producer/ — `TopicProducer.send` routes
through a partitioner (partitioning.rs:16,39: key-hash or round-robin)
into per-partition `RecordAccumulator` batches (accumulator.rs:63-143);
a background `PartitionProducer` flushes on linger expiry or batch-full
(partition_producer.rs:26,181); callers get `FutureRecordMetadata`
(output.rs) resolving to the record's (partition, offset).

The port's copy of ``fluvio_tpu/client/producer.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from fluvio_tpu_torch.protocol.compression import Compression
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.protocol.record import Batch, Record, RecordSet
from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocation
from fluvio_tpu_torch.schema.spu import (
    Isolation,
    PartitionProduceData,
    ProduceRequest,
    TopicProduceData,
)

DEFAULT_BATCH_SIZE = 16_384
DEFAULT_LINGER_MS = 100

# broker-reported errors worth retrying under at-least-once: leadership is
# mid-move (parity: producer/config.rs RetryPolicy error classes); transport
# failures are classified separately where they are caught
RETRIABLE_ERRORS = frozenset({ErrorCode.NOT_LEADER_FOR_PARTITION})


@dataclass
class RetryPolicy:
    """Backoff schedule for at-least-once delivery (config.rs:348).

    Strategies mirror the reference: exponential (doubling), fibonacci,
    fixed — each capped at ``max_delay_ms``.
    """

    max_retries: int = 4
    initial_delay_ms: int = 50
    max_delay_ms: int = 2000
    strategy: str = "exponential"  # exponential | fibonacci | fixed

    def __post_init__(self) -> None:
        if self.strategy not in ("exponential", "fibonacci", "fixed"):
            raise ValueError(f"unknown retry strategy {self.strategy!r}")

    def delays_ms(self):
        a, b = self.initial_delay_ms, self.initial_delay_ms
        for attempt in range(self.max_retries):
            if self.strategy == "fixed":
                delay = self.initial_delay_ms
            elif self.strategy == "fibonacci":
                delay = a
                a, b = b, a + b
            else:
                delay = self.initial_delay_ms * (2**attempt)
            yield min(delay, self.max_delay_ms)


@dataclass
class ProducerConfig:
    batch_size: int = DEFAULT_BATCH_SIZE
    linger_ms: int = DEFAULT_LINGER_MS
    # None = "unset": the topic's compression_type decides (a topic set
    # to a specific codec adopts it; an EXPLICIT conflicting setting
    # errors — fluvio/src/producer resolution semantics)
    compression: Optional[Compression] = None
    isolation: Isolation = Isolation.READ_UNCOMMITTED
    timeout_ms: int = 1500
    smartmodules: List[SmartModuleInvocation] = field(default_factory=list)
    # delivery semantics (config.rs AtMostOnce / AtLeastOnce(RetryPolicy))
    delivery: str = "at-least-once"  # at-least-once | at-most-once
    retry_policy: RetryPolicy = field(default_factory=RetryPolicy)

    def __post_init__(self) -> None:
        if self.delivery not in ("at-least-once", "at-most-once"):
            raise ValueError(f"unknown delivery semantic {self.delivery!r}")


def resolve_topic_compression(
    topic_compression: str, config: Optional["ProducerConfig"]
) -> "ProducerConfig":
    """Resolve the producer's compression against the topic's
    ``compression_type`` (parity: the reference producer refuses a
    producer codec that conflicts with the topic policy; topic "any"
    keeps the producer's choice). Never mutates the caller's config —
    a shared ProducerConfig must not leak one topic's codec into the
    next producer built from it."""
    config = config or ProducerConfig()
    topic_c = (topic_compression or "any").lower()
    if topic_c == "any":
        return config
    try:
        want = Compression.parse(topic_c)
    except ValueError as e:
        raise FluvioError(ErrorCode.OTHER, str(e)) from None
    if config.compression is None or config.compression == want:
        return dataclasses.replace(config, compression=want)
    raise FluvioError(
        ErrorCode.OTHER,
        f"producer compression {config.compression.name.lower()!r} conflicts "
        f"with the topic's compression_type {topic_c!r}",
    )


@dataclass
class RecordMetadata:
    partition: int
    offset: int


class FutureRecordMetadata:
    """Resolves when the record's batch is acked by the leader."""

    def __init__(self, future: "asyncio.Future[Tuple[int, int]]", index: int):
        self._future = future
        self._index = index

    async def wait(self) -> RecordMetadata:
        partition, base_offset = await self._future
        return RecordMetadata(partition=partition, offset=base_offset + self._index)

    def add_done_callback(self, fn) -> None:
        """Run ``fn()`` the moment the batch is acked (latency probes)."""
        self._future.add_done_callback(lambda _f: fn())


class Partitioner:
    """Key-hash (stable) or round-robin routing (partitioning.rs:39)."""

    def __init__(self) -> None:
        self._round_robin = 0

    def partition(self, key: Optional[bytes], num_partitions: int) -> int:
        if num_partitions <= 1:
            return 0
        if key is None:
            p = self._round_robin % num_partitions
            self._round_robin += 1
            return p
        return zlib.crc32(key) % num_partitions


class _PendingBatch:
    """One in-flight MemoryBatch + its ack future (accumulator.rs:220)."""

    def __init__(self, partition: int, capacity: int):
        self.partition = partition
        self.capacity = capacity
        self.records: List[Record] = []
        self.size = 0
        self.future: asyncio.Future = asyncio.get_running_loop().create_future()
        self.created = asyncio.get_running_loop().time()

    def try_push(self, record: Record) -> Optional[FutureRecordMetadata]:
        rsize = record.write_size()
        if self.records and self.size + rsize > self.capacity:
            return None
        self.records.append(record)
        self.size += rsize
        return FutureRecordMetadata(self.future, len(self.records) - 1)


class PartitionProducer:
    """Background flusher for one partition (partition_producer.rs:26)."""

    def __init__(self, topic: str, partition: int, socket_factory, config: ProducerConfig):
        self.topic = topic
        self.partition = partition
        self._socket_factory = socket_factory
        self.config = config
        self._current: Optional[_PendingBatch] = None
        self._queue: List[_PendingBatch] = []
        self._inflight: List[_PendingBatch] = []
        self._wake = asyncio.Event()
        self._closed = False
        self._task = asyncio.ensure_future(self._run())

    def push_record(self, record: Record) -> FutureRecordMetadata:
        if self._current is None:
            self._current = _PendingBatch(self.partition, self.config.batch_size)
        fut = self._current.try_push(record)
        if fut is None:
            self._seal_current()
            self._current = _PendingBatch(self.partition, self.config.batch_size)
            fut = self._current.try_push(record)
            assert fut is not None, "record exceeds batch capacity"
        if self._current.size >= self.config.batch_size:
            self._seal_current()
        return fut

    def _seal_current(self) -> None:
        if self._current is not None and self._current.records:
            self._queue.append(self._current)
            self._current = None
            self._wake.set()

    async def flush(self) -> None:
        """Wait until every sealed batch resolves; the FIRST delivery
        failure re-raises here (parity: the reference's flush returns the
        error, producer_fail/mod.rs asserts it). Per-record futures carry
        the same error for callers that track them individually."""
        self._seal_current()
        # in-flight batches (popped by _run, awaiting their ack inside
        # _send) count: "every sealed batch resolves" includes them
        pending = list(self._inflight) + list(self._queue)
        self._wake.set()
        first_err: Optional[FluvioError] = None
        for batch in pending:
            try:
                await asyncio.shield(batch.future)
            except FluvioError as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    async def _run(self) -> None:
        linger = self.config.linger_ms / 1000
        while not self._closed:
            if not self._queue:
                if self._current is not None and self._current.records:
                    # linger: seal the open batch when it gets old enough
                    age = asyncio.get_running_loop().time() - self._current.created
                    timeout = max(linger - age, 0)
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=timeout)
                    except asyncio.TimeoutError:
                        self._seal_current()
                else:
                    await self._wake.wait()
                self._wake.clear()
                continue
            batches, self._queue = self._queue, []
            self._inflight = batches
            try:
                await self._send(batches)
            finally:
                self._inflight = []

    async def _send(self, pending: List[_PendingBatch]) -> None:
        record_set = RecordSet()
        for p in pending:
            record_set.add(
                Batch.from_records(
                    p.records,
                    compression=self.config.compression or Compression.NONE,
                )
            )
        request = ProduceRequest(
            isolation=self.config.isolation,
            timeout_ms=self.config.timeout_ms,
            topics=[
                TopicProduceData(
                    name=self.topic,
                    partitions=[
                        PartitionProduceData(
                            partition_index=self.partition, records=record_set
                        )
                    ],
                )
            ],
            smartmodules=list(self.config.smartmodules),
        )
        err = await self._send_with_retry(request, pending)
        if err is not None:
            for p in pending:
                if not p.future.done():
                    p.future.set_exception(err)

    async def _send_with_retry(
        self, request: ProduceRequest, pending: List[_PendingBatch]
    ) -> Optional[FluvioError]:
        """One attempt, plus retries under at-least-once for leadership
        moves / dropped connections (partition_producer.rs delivery
        semantics). Returns the final error, or None on success."""
        retries = (
            self.config.retry_policy.delays_ms()
            if self.config.delivery == "at-least-once"
            else iter(())
        )
        while True:
            try:
                socket = await self._socket_factory()
                response = await socket.send_receive(request)
                presp = response.find_partition(self.topic, self.partition)
            except Exception as e:  # noqa: BLE001 — classify then retry/raise
                if isinstance(e, FluvioError):
                    err, retriable = e, e.code in RETRIABLE_ERRORS
                else:
                    # only genuine transport failures are transient;
                    # programming/parse errors propagate immediately
                    retriable = isinstance(e, (ConnectionError, OSError))
                    err = FluvioError(ErrorCode.OTHER, str(e))
            else:
                if presp.error_code == ErrorCode.NONE:
                    offset = presp.base_offset
                    for p in pending:
                        if not p.future.done():
                            p.future.set_result((self.partition, offset))
                        offset += len(p.records)
                    return None
                err = FluvioError(presp.error_code, presp.error_message)
                retriable = err.code in RETRIABLE_ERRORS
            if not retriable:
                return err
            delay_ms = next(retries, None)
            if delay_ms is None:
                return err
            await asyncio.sleep(delay_ms / 1000)

    async def close(self) -> None:
        # teardown must not leak the background task: a delivery failure
        # during the final drain is already on the record futures (and on
        # any explicit flush() the caller made) — swallow it here so the
        # cancel below always runs
        try:
            await self.flush()
        except FluvioError:
            pass
        self._closed = True
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass


class TopicProducer:
    """Public producer handle (parity: fluvio/src/producer/mod.rs)."""

    def __init__(
        self,
        topic: str,
        num_partitions: int,
        socket_factory,
        config: Optional[ProducerConfig] = None,
    ):
        self.topic = topic
        self.num_partitions = num_partitions
        self.config = config or ProducerConfig()
        self._socket_factory = socket_factory
        self._partitioner = Partitioner()
        self._producers: dict[int, PartitionProducer] = {}

    def _producer_for(self, partition: int) -> PartitionProducer:
        if partition not in self._producers:
            # bind the partition so the flusher dials that partition's leader
            factory = lambda p=partition: self._socket_factory(p)  # noqa: E731
            self._producers[partition] = PartitionProducer(
                self.topic, partition, factory, self.config
            )
        return self._producers[partition]

    async def send(
        self,
        key: Union[bytes, str, None],
        value: Union[bytes, str],
    ) -> FutureRecordMetadata:
        kb = key.encode() if isinstance(key, str) else key
        vb = value.encode() if isinstance(value, str) else value
        partition = self._partitioner.partition(kb, self.num_partitions)
        record = Record(key=kb, value=vb)
        return self._producer_for(partition).push_record(record)

    async def send_all(self, items) -> List[FutureRecordMetadata]:
        return [await self.send(k, v) for k, v in items]

    async def flush(self) -> None:
        await asyncio.gather(*(p.flush() for p in self._producers.values()))

    async def close(self) -> None:
        await asyncio.gather(*(p.close() for p in self._producers.values()))
        self._producers.clear()
