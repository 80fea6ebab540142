"""Client-side metadata mirror fed by admin Watch streams.

Capability parity: fluvio/src/sync/{store.rs:41-99,controller.rs:51} —
the client keeps local stores of SPUs and partitions, updated by SC
watch pushes, and resolves topic/partition -> leader SPU public address
for the producer/consumer pool.

The port's copy of ``fluvio_tpu/client/sync.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from fluvio_tpu_torch.client.admin import list_objects
from fluvio_tpu_torch.metadata.partition import PartitionSpec, partition_key
from fluvio_tpu_torch.metadata.spu import SpuSpec
from fluvio_tpu_torch.metadata.topic import TopicSpec
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.schema.admin import WatchRequest, WatchResponse
from fluvio_tpu_torch.stream_model.store import StoreContext
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket

logger = logging.getLogger(__name__)

_WATCHED = (SpuSpec.KIND, PartitionSpec.KIND, TopicSpec.KIND)


class MetadataStores:
    """Watch-stream-fed mirrors of the SC's stores."""

    def __init__(self, socket: VersionedSerialSocket):
        self._socket = socket
        self.spus: StoreContext[SpuSpec] = StoreContext(SpuSpec)
        self.partitions: StoreContext[PartitionSpec] = StoreContext(PartitionSpec)
        self.topics: StoreContext[TopicSpec] = StoreContext(TopicSpec)
        self._tasks: list[asyncio.Task] = []
        self._streams: list = []

    def _store_for(self, kind: str) -> StoreContext:
        return {
            SpuSpec.KIND: self.spus,
            PartitionSpec.KIND: self.partitions,
            TopicSpec.KIND: self.topics,
        }[kind]

    async def start(self) -> None:
        for kind in _WATCHED:
            stream = await self._socket.create_stream(
                WatchRequest(kind=kind), queue_len=64
            )
            self._streams.append(stream)
            task = asyncio.create_task(
                self._sync_loop(kind, stream), name=f"client-sync-{kind}"
            )
            self._tasks.append(task)

    async def _sync_loop(self, kind: str, stream) -> None:
        store = self._store_for(kind)
        try:
            async for resp in stream:
                if resp.error_code != ErrorCode.NONE:
                    logger.error(
                        "metadata watch (%s) rejected: %s",
                        kind,
                        resp.error_code.name,
                    )
                    return
                self._apply(store, resp)
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            logger.exception("client sync loop failed (%s)", kind)

    def _apply(self, store: StoreContext, resp: WatchResponse) -> None:
        if resp.is_sync_all:
            store.store.sync_all([o.to_store_object() for o in resp.all_objects])
            return
        for obj in resp.changes:
            store.store.apply(obj.to_store_object())
        for key in resp.deleted:
            store.store.delete(key)

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    # -- lookups -------------------------------------------------------------

    async def list(self, kind: str, name_filters=None):
        """Authoritative List RPC on the SC socket — the store itself,
        not the (possibly lagging) watch mirror. Lets callers settle
        present-vs-absent in one round-trip instead of waiting out a
        mirror timeout."""
        return await list_objects(self._socket, kind, name_filters)

    def leader_addr(self, topic: str, partition: int) -> Optional[str]:
        pobj = self.partitions.store.value(partition_key(topic, partition))
        if pobj is None:
            return None
        sobj = self.spus.store.value(str(pobj.spec.leader))
        if sobj is None:
            return None
        return sobj.spec.public_endpoint.addr

    @staticmethod
    def count_from_topic_object(tobj) -> int:
        """Partition count of a topic store object: provisioned partitions
        (status.replica_map) when present, else the spec's request."""
        rm = tobj.status.replica_map
        if rm:
            return len(rm)
        rs = tobj.spec.replicas
        return len(rs.maps) if rs.is_assigned() else rs.partitions

    def partition_count(self, topic: str) -> Optional[int]:
        tobj = self.topics.store.value(topic)
        if tobj is None:
            return None
        return self.count_from_topic_object(tobj)

    async def wait_partition_count(
        self, topic: str, timeout: float = 5.0
    ) -> Optional[int]:
        """Partition count once the topic lands in the mirror (None = unknown)."""
        deadline = asyncio.get_running_loop().time() + timeout
        listener = self.topics.store.change_listener()
        while True:
            count = self.partition_count(topic)
            if count is not None:
                return count
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return None
            task = asyncio.ensure_future(listener.listen())
            try:
                await asyncio.wait((task,), timeout=remaining)
            finally:
                if not task.done():
                    task.cancel()
            listener.set_current()

    async def wait_for_leader(
        self, topic: str, partition: int, timeout: float = 10.0
    ) -> Optional[str]:
        """Block until the partition has a known leader address."""
        deadline = asyncio.get_running_loop().time() + timeout
        listener = self.partitions.store.change_listener()
        spu_listener = self.spus.store.change_listener()
        while True:
            addr = self.leader_addr(topic, partition)
            if addr is not None and not addr.endswith(":0"):
                return addr
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return None
            t1 = asyncio.ensure_future(listener.listen())
            t2 = asyncio.ensure_future(spu_listener.listen())
            try:
                await asyncio.wait(
                    (t1, t2), return_when=asyncio.FIRST_COMPLETED, timeout=remaining
                )
            finally:
                for p in (t1, t2):
                    if not p.done():
                        p.cancel()
            listener.set_current()
            spu_listener.set_current()
