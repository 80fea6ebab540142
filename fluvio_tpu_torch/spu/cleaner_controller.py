"""Background retention controller (the port's copy of
``fluvio_tpu/spu/cleaner_controller.py``).

Capability parity: fluvio-storage/src/cleaner.rs:20,56 — the reference
spawns a per-replica cleaner loop that periodically sheds read-only
segments past the retention age (and, size-bounded partitions, oldest
first). Here one controller task sweeps every led replica: replica
retention config already flows SC -> SPU into each replica's storage
config (`spu.context.GlobalContext._storage_config`).

Two-phase removal: a sweep DETACHES segments from the replica (new
reads can no longer resolve into them) but defers the file unlink to
the NEXT sweep — consume responses hold path-based file slices across
awaits, and unlinking under an in-flight sendfile would kill the stream
with FileNotFoundError. One full interval is the grace period.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from fluvio_tpu_torch.storage.cleaner import Cleaner

logger = logging.getLogger(__name__)


class CleanerController:
    def __init__(self, ctx, interval_seconds: float):
        self.ctx = ctx
        self.interval = interval_seconds
        self._task: Optional[asyncio.Task] = None
        self._pending_unlink: List[object] = []

    def start(self) -> None:
        if self.interval > 0:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # clean shutdown: without this, detached-but-not-unlinked segment
        # files would be re-discovered as live segments on the next boot
        self._unlink_pending()

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self.sweep()

    def _unlink_pending(self) -> None:
        for seg in self._pending_unlink:
            try:
                seg.remove_files()
            except FileNotFoundError:
                pass
        self._pending_unlink.clear()

    def sweep(self) -> int:
        """One cleaning pass over every led replica; returns segments shed."""
        self._unlink_pending()  # last sweep's detachments have drained
        shed = 0
        for key, leader in list(self.ctx.leaders.items()):
            cleaner = Cleaner(leader.storage)
            try:
                removed = cleaner.clean(unlink=False)
            except Exception:  # noqa: BLE001 — one replica must not stop the sweep
                logger.exception("retention clean failed for %s", key)
                continue
            if removed:
                self._pending_unlink.extend(cleaner.detached)
                shed += len(removed)
                logger.info(
                    "retention: %s shed %d segment(s) at offsets %s",
                    key,
                    len(removed),
                    removed,
                )
        return shed
