"""MetadataDispatcher: the backend <-> StoreContext reconcile loop (the
port's copy of ``fluvio_tpu/metadata/dispatcher.py``).

Capability parity: fluvio-stream-dispatcher/src/dispatcher/metadata.rs:28-120
— one dispatcher a spec type: (a) a full resync from the backend at start
and every reconciliation interval, (b) a wake on the backend's change
hint, (c) the StoreContext's write intents drained back into the
backend. Controllers only talk to the StoreContext; durability is the
dispatcher's job.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from fluvio_tpu_torch.metadata.client import MetadataClient
from fluvio_tpu_torch.stream_model.store import StoreContext

logger = logging.getLogger(__name__)

# parity: FLV_SC_RECONCILIATION_INTERVAL's default (the port reads no
# environment: `ScConfig.reconcile_interval` sets it)
RECONCILIATION_INTERVAL = 300.0


class MetadataDispatcher:
    def __init__(
        self,
        client: MetadataClient,
        ctx: StoreContext,
        reconcile_interval: Optional[float] = None,
    ):
        self.client = client
        self.ctx = ctx
        self.spec_type = ctx.spec_type
        self.interval = (
            RECONCILIATION_INTERVAL if reconcile_interval is None else reconcile_interval
        )
        self._task: Optional[asyncio.Task] = None
        self._writer_task: Optional[asyncio.Task] = None
        self._stopped = False
        self._write_inflight = False
        ctx.attach_backend()

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._watch_loop())
        self._writer_task = asyncio.ensure_future(self._writer_loop())

    async def stop(self) -> None:
        self._stopped = True
        for t in (self._task, self._writer_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass

    async def resync(self) -> None:
        """Full sync backend -> store.

        Deferred while controller write intents are queued or in flight:
        `sync_all` would otherwise delete for a moment a freshly applied
        object (or bring back a freshly deleted one) that the writer loop
        has not persisted yet, pushing spurious changes to every watcher.
        """
        for _ in range(200):
            if self.ctx.pending_actions() == 0 and not self._write_inflight:
                break
            await asyncio.sleep(0.01)
        objects = await self.client.retrieve_items(self.spec_type)
        if self.ctx.pending_actions() or self._write_inflight:
            return  # new local writes raced the read; the next wake retries
        self.ctx.store.sync_all(objects)

    async def _watch_loop(self) -> None:
        next_full = asyncio.get_running_loop().time() + self.interval
        while not self._stopped:
            try:
                timeout = max(next_full - asyncio.get_running_loop().time(), 0.01)
                if await self.client.watch_changed(self.spec_type, timeout):
                    await self.resync()
                if asyncio.get_running_loop().time() >= next_full:
                    await self.resync()
                    next_full = asyncio.get_running_loop().time() + self.interval
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("resync failed (%s)", self.spec_type.KIND)
                await asyncio.sleep(0.5)

    async def _writer_loop(self) -> None:
        """Apply controller write intents back to the backend."""
        while not self._stopped:
            action = await self.ctx.next_action()
            self._write_inflight = True
            try:
                if action[0] == "apply":
                    await self.client.apply(action[1])
                elif action[0] == "delete":
                    await self.client.delete_item(self.spec_type, action[1])
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception(
                    "backend write failed (%s %s)", self.spec_type.KIND, action[0]
                )
            finally:
                self._write_inflight = False
