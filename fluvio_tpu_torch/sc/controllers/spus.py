"""SPU controller: health bus -> SpuStatus online/offline.

Capability parity: fluvio-sc/src/controllers/spus/controller.rs — listens
on the HealthCheck store and flips each SPU's status resolution; the
partition controller reacts to the resulting store changes.

The port's copy of ``fluvio_tpu/sc/controllers/spus.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from fluvio_tpu_torch.metadata.spu import SpuResolution, SpuStatus
from fluvio_tpu_torch.sc.context import ScContext

logger = logging.getLogger(__name__)


class SpuController:
    def __init__(self, ctx: ScContext):
        self.ctx = ctx
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="spu-controller")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        spu_listener = self.ctx.spus.store.change_listener()
        seen_health = -1
        while True:
            await self.sync_once()
            health_epoch = self.ctx.health.epoch
            if health_epoch == seen_health and not spu_listener.has_change():
                t1 = asyncio.ensure_future(self.ctx.health.wait_change(health_epoch))
                t2 = asyncio.ensure_future(spu_listener.listen())
                try:
                    await asyncio.wait((t1, t2), return_when=asyncio.FIRST_COMPLETED)
                finally:
                    for p in (t1, t2):
                        if not p.done():
                            p.cancel()
            seen_health = self.ctx.health.epoch
            spu_listener.set_current()

    async def sync_once(self) -> None:
        for obj in self.ctx.spus.store.values():
            online = self.ctx.health.is_online(obj.spec.id)
            want = SpuResolution.ONLINE if online else SpuResolution.OFFLINE
            if obj.status.resolution != want:
                logger.info("spu %s -> %s", obj.spec.id, want.value)
                await self.ctx.spus.update_status(obj.key, SpuStatus(resolution=want))
