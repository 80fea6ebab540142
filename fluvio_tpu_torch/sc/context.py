"""SC global context: one StoreContext per spec + SPU health tracking.

The port's copy of ``fluvio_tpu/sc/context.py``. Capability parity: fluvio-sc/src/core/context.rs:25-35 — `Context` holds
`StoreContext`s for spus/partitions/topics/spgs/smartmodules/tableformats
plus the `HealthCheck` store the SPU controller reads liveness from.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from fluvio_tpu_torch.auth import RootAuthorization
from fluvio_tpu_torch.metadata.partition import PartitionSpec
from fluvio_tpu_torch.metadata.smartmodule import SmartModuleSpec
from fluvio_tpu_torch.metadata.spg import SpuGroupSpec
from fluvio_tpu_torch.metadata.spu import SpuSpec
from fluvio_tpu_torch.metadata.tableformat import TableFormatSpec
from fluvio_tpu_torch.metadata.topic import TopicSpec
from fluvio_tpu_torch.stream_model.store import StoreContext


class HealthStore:
    """SPU liveness bus (parity: HealthCheck store in core/context.rs:33).

    The private server marks SPUs up/down as their registration
    connections come and go; the SPU controller listens for flips.
    """

    def __init__(self) -> None:
        self._status: Dict[int, bool] = {}
        self._epoch = 0
        self._cond: Optional[asyncio.Condition] = None

    def _condition(self) -> asyncio.Condition:
        if self._cond is None:
            self._cond = asyncio.Condition()
        return self._cond

    @property
    def epoch(self) -> int:
        return self._epoch

    def is_online(self, spu_id: int) -> bool:
        return self._status.get(spu_id, False)

    def online_spus(self) -> list[int]:
        return sorted(s for s, up in self._status.items() if up)

    def update(self, spu_id: int, online: bool) -> None:
        if self._status.get(spu_id) == online:
            return
        self._status[spu_id] = online
        self._epoch += 1
        cond = self._condition()

        async def wake() -> None:
            async with cond:
                cond.notify_all()

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        loop.create_task(wake())

    async def wait_change(self, seen_epoch: int) -> int:
        cond = self._condition()
        async with cond:
            while self._epoch == seen_epoch:
                await cond.wait()
        return self._epoch


class ScContext:
    """Everything SC controllers and services share."""

    def __init__(self, authorization=None) -> None:
        # admin API access policy; default allow-all, like the reference's
        # RootAuthorization when no x509 auth is configured
        self.authorization = authorization or RootAuthorization()
        self.topics: StoreContext[TopicSpec] = StoreContext(TopicSpec)
        self.partitions: StoreContext[PartitionSpec] = StoreContext(PartitionSpec)
        self.spus: StoreContext[SpuSpec] = StoreContext(SpuSpec)
        self.spgs: StoreContext[SpuGroupSpec] = StoreContext(SpuGroupSpec)
        self.smartmodules: StoreContext[SmartModuleSpec] = StoreContext(
            SmartModuleSpec
        )
        self.tableformats: StoreContext[TableFormatSpec] = StoreContext(
            TableFormatSpec
        )
        self.health = HealthStore()

    def store_for(self, kind: str) -> StoreContext:
        stores = {
            TopicSpec.KIND: self.topics,
            PartitionSpec.KIND: self.partitions,
            SpuSpec.KIND: self.spus,
            "custom-spu": self.spus,
            SpuGroupSpec.KIND: self.spgs,
            SmartModuleSpec.KIND: self.smartmodules,
            TableFormatSpec.KIND: self.tableformats,
        }
        try:
            return stores[kind]
        except KeyError:
            raise ValueError(f"unknown object kind: {kind!r}") from None
