"""Topic controller: drives TopicResolution to a final state.

Capability parity: fluvio-sc/src/controllers/topics/{controller.rs,
policy.rs:26-83,reducer.rs} — listen on the topic store; for each
non-final topic: validate config (policy), generate a replica map via the
scheduler (computed) or validate the explicit maps (assigned), then flip
the topic Provisioned and create its PartitionSpec children.

The port's copy of ``fluvio_tpu/sc/controllers/topics.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

from fluvio_tpu_torch.metadata.partition import PartitionSpec, partition_key
from fluvio_tpu_torch.metadata.topic import TopicSpec, TopicStatus, TopicResolution
from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.sc.scheduler import SchedulingError, generate_replica_map
from fluvio_tpu_torch.stream_model.core import MetadataStoreObject

logger = logging.getLogger(__name__)

MAX_TOPIC_NAME = 249  # parity: kafka-style topic name bound


def validate_topic_name(name: str) -> Optional[str]:
    if not name:
        return "topic name is empty"
    if len(name) > MAX_TOPIC_NAME:
        return f"topic name longer than {MAX_TOPIC_NAME} chars"
    ok = all(c.isalnum() and c.isascii() or c in "-." for c in name)
    if not ok or name.startswith("-"):
        return f"invalid topic name {name!r}: use [a-zA-Z0-9.-]"
    return None


def validate_topic_spec(name: str, spec: TopicSpec) -> Optional[str]:
    """None when valid, else the rejection reason.

    Parity: validate_computed_topic_parameters / validate_assigned
    (policy.rs:40-83).
    """
    err = validate_topic_name(name)
    if err:
        return err
    rs = spec.replicas
    if rs.is_assigned():
        ids = [m.id for m in rs.maps]
        if sorted(ids) != list(range(len(ids))):
            return "assigned partition ids must be contiguous from 0"
        for m in rs.maps:
            if not m.replicas:
                return f"partition {m.id} has no replicas"
            if len(set(m.replicas)) != len(m.replicas):
                return f"partition {m.id} has duplicate replicas"
        return None
    if rs.partitions <= 0:
        return "partition count must be > 0"
    if rs.replication_factor <= 0:
        return "replication factor must be > 0"
    return None


class TopicController:
    """One reconcile task over the topic store."""

    def __init__(self, ctx: ScContext):
        self.ctx = ctx
        self._task: Optional[asyncio.Task] = None
        self._next_start = 0  # rotating scheduler start

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="topic-controller")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        listener = self.ctx.topics.store.change_listener()
        spu_listener = self.ctx.spus.store.change_listener()
        while True:
            await self.sync_once()
            # wake on topic changes or SPU arrivals (pending topics may
            # become schedulable when SPUs register)
            t1 = asyncio.ensure_future(listener.listen())
            t2 = asyncio.ensure_future(spu_listener.listen())
            try:
                _, pending = await asyncio.wait(
                    (t1, t2), return_when=asyncio.FIRST_COMPLETED
                )
            finally:
                for p in (t1, t2):
                    if not p.done():
                        p.cancel()
            listener.set_current()
            spu_listener.set_current()

    async def sync_once(self) -> None:
        """One reconcile pass (exposed for tests)."""
        for obj in self.ctx.topics.store.values():
            status: TopicStatus = obj.status
            if status.resolution.is_final():
                continue
            await self._process_topic(obj)

    async def _process_topic(self, obj: MetadataStoreObject[TopicSpec]) -> None:
        name, spec = obj.key, obj.spec
        err = validate_topic_spec(name, spec)
        if err:
            await self.ctx.topics.update_status(name, TopicStatus.invalid(err))
            return
        replica_map = self._make_replica_map(spec)
        if replica_map is None:
            if obj.status.resolution != TopicResolution.PENDING:
                await self.ctx.topics.update_status(
                    name,
                    TopicStatus(
                        resolution=TopicResolution.PENDING,
                        reason="waiting for SPUs",
                    ),
                )
            return
        await self.ctx.topics.update_status(
            name,
            TopicStatus(
                resolution=TopicResolution.PROVISIONED, replica_map=replica_map
            ),
        )
        # create partition children mirroring topic config (reducer.rs)
        for pid, replicas in replica_map.items():
            key = partition_key(name, pid)
            if key in self.ctx.partitions.store:
                continue
            pspec = PartitionSpec(
                leader=replicas[0],
                replicas=list(replicas),
                cleanup_policy=spec.cleanup_policy,
                storage=spec.storage,
                retention_seconds=spec.retention_seconds,
                compression_type=spec.compression_type,
                deduplication=spec.deduplication,
                system=spec.system,
            )
            await self.ctx.partitions.apply(MetadataStoreObject(key=key, spec=pspec))
        logger.info("topic %s provisioned: %s", name, replica_map)

    def _make_replica_map(self, spec: TopicSpec) -> Optional[Dict[int, List[int]]]:
        rs = spec.replicas
        if rs.is_assigned():
            return {m.id: list(m.replicas) for m in rs.maps}
        spus = [
            o.spec for o in self.ctx.spus.store.values() if o.status.is_online()
        ]
        try:
            rm = generate_replica_map(
                spus,
                rs.partitions,
                rs.replication_factor,
                rs.ignore_rack_assignment,
                start_index=self._next_start,
            )
        except SchedulingError:
            return None
        self._next_start += 1
        return rm
