"""Partition controller: online/offline tracking + leader election.

Capability parity: fluvio-sc/src/controllers/partitions/reducer.rs:84-205
— when a partition's leader SPU goes offline, elect the first live
replica as the new leader (update the PartitionSpec leader field) and
flip the status resolution; when no replica is live the partition goes
Offline until an SPU returns.

The port's copy of ``fluvio_tpu/sc/controllers/partitions.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Optional

from fluvio_tpu_torch.metadata.partition import (
    PartitionResolution,
    PartitionSpec,
    PartitionStatus,
)
from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.stream_model.core import MetadataStoreObject

logger = logging.getLogger(__name__)


class PartitionController:
    def __init__(self, ctx: ScContext):
        self.ctx = ctx
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="partition-controller")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        part_listener = self.ctx.partitions.store.change_listener()
        spu_listener = self.ctx.spus.store.change_listener()
        while True:
            await self.sync_once()
            t1 = asyncio.ensure_future(part_listener.listen())
            t2 = asyncio.ensure_future(spu_listener.listen())
            try:
                await asyncio.wait((t1, t2), return_when=asyncio.FIRST_COMPLETED)
            finally:
                for p in (t1, t2):
                    if not p.done():
                        p.cancel()
            part_listener.set_current()
            spu_listener.set_current()

    def _spu_online(self, spu_id: int) -> bool:
        obj = self.ctx.spus.store.value(str(spu_id))
        return obj is not None and obj.status.is_online()

    async def sync_once(self) -> None:
        for obj in self.ctx.partitions.store.values():
            await self._process_partition(obj)

    async def _process_partition(
        self, obj: MetadataStoreObject[PartitionSpec]
    ) -> None:
        spec, status = obj.spec, obj.status
        leader_up = self._spu_online(spec.leader)
        if leader_up:
            if status.resolution != PartitionResolution.ONLINE:
                new_status = PartitionStatus(
                    resolution=PartitionResolution.ONLINE,
                    leader=status.leader,
                    replicas=status.replicas,
                    lsr=status.lsr,
                    size=status.size,
                )
                await self.ctx.partitions.update_status(obj.key, new_status)
            return
        # leader down: try electing the first live follower
        # (reducer.rs:109-205 force-elects from the live replica set)
        candidate = next(
            (r for r in spec.replicas if r != spec.leader and self._spu_online(r)),
            None,
        )
        if candidate is None:
            if status.resolution != PartitionResolution.LEADER_OFFLINE:
                await self.ctx.partitions.update_status(
                    obj.key,
                    PartitionStatus(resolution=PartitionResolution.LEADER_OFFLINE),
                )
            return
        logger.info(
            "partition %s: leader %s offline, electing %s",
            obj.key,
            spec.leader,
            candidate,
        )
        await self.ctx.partitions.update_spec(
            obj.key, dataclasses.replace(spec, leader=candidate)
        )
        await self.ctx.partitions.update_status(
            obj.key,
            PartitionStatus(resolution=PartitionResolution.ELECTION_LEADER_FOUND),
        )
