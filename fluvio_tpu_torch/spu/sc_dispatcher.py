"""SPU -> SC dispatcher: register, receive metadata pushes, report LRS.

The port's copy of ``fluvio_tpu/spu/sc_dispatcher.py`` (parity:
fluvio-spu/src/control_plane/dispatcher.rs:42): dial the SC's private
endpoint (with backoff on failure), send RegisterSpu, then loop on the
push stream applying UpdateSpu / UpdateReplica / UpdateSmartModule.
Peer SPUs land in the context's ``peers``; replica assignments add,
promote, demote, re-point and remove the context's leaders and
followers (a promotion or demotion keeps the storage on disk, and a
leader's quorum is the size of its replica set); pushed SmartModules
land in its local store. A side loop reports each leader's offsets, and
its followers' as the leader saw them, back as UpdateLrs whenever they
move.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from fluvio_tpu_torch.models import builtin_sources
from fluvio_tpu_torch.schema.controlplane import (
    InternalUpdate,
    LrsStatus,
    RegisterSpuRequest,
    Replica,
    ReplicaRemovedRequest,
    ReplicaStatusUpdate,
    SpuUpdate,
    UpdateKind,
    UpdateLrsRequest,
)
from fluvio_tpu_torch.spu.context import GlobalContext
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket
from fluvio_tpu_torch.types import partition_replica_key

logger = logging.getLogger(__name__)

LRS_POLL_INTERVAL = 0.2  # seconds between offset-change checks
RECONNECT_BACKOFF_MAX = 5.0


class ScDispatcher:
    def __init__(self, ctx: GlobalContext, sc_private_addr: str):
        self.ctx = ctx
        self.sc_addr = sc_private_addr
        self._task: Optional[asyncio.Task] = None
        self._lrs_task: Optional[asyncio.Task] = None
        self._socket: Optional[VersionedSerialSocket] = None
        self.peers: Dict[int, SpuUpdate] = {}
        self.first_sync = asyncio.Event()  # set after the first replica update

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="sc-dispatcher")

    async def stop(self) -> None:
        for t in (self._task, self._lrs_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        self._task = self._lrs_task = None
        if self._socket is not None:
            await self._socket.close()
            self._socket = None

    async def _run(self) -> None:
        backoff = 0.05
        while True:
            try:
                await self._session()
                backoff = 0.05  # clean disconnect: retry quickly
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("SC session failed: %s", e)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, RECONNECT_BACKOFF_MAX)

    async def _session(self) -> None:
        socket = await VersionedSerialSocket.connect(self.sc_addr)
        self._socket = socket
        try:
            stream = await socket.create_stream(
                RegisterSpuRequest(spu_id=self.ctx.config.id), queue_len=64
            )
            logger.info("registered with SC at %s", self.sc_addr)
            if self._lrs_task is None or self._lrs_task.done():
                self._lrs_task = asyncio.create_task(
                    self._lrs_loop(), name="lrs-reporter"
                )
            async for update in stream:
                await self._apply(update)
        finally:
            if self._lrs_task is not None:
                self._lrs_task.cancel()
                await asyncio.gather(self._lrs_task, return_exceptions=True)
                self._lrs_task = None
            self._socket = None
            await socket.close()

    # -- update application --------------------------------------------------

    async def _apply(self, update: InternalUpdate) -> None:
        if update.kind == UpdateKind.SPU:
            self._apply_spus(update)
        elif update.kind == UpdateKind.REPLICA:
            await self._apply_replicas(update)
            self.first_sync.set()
        elif update.kind == UpdateKind.SMARTMODULE:
            self._apply_smartmodules(update)

    def _apply_spus(self, update: InternalUpdate) -> None:
        if update.sync_all:
            self.peers = {s.id: s for s in update.spus}
        else:
            for s in update.spus:
                self.peers[s.id] = s
            for key in update.deleted:
                self.peers.pop(int(key), None)
        self.ctx.peers = self.peers
        self.ctx.notify_followers_changed()

    async def _apply_replicas(self, update: InternalUpdate) -> None:
        my_id = self.ctx.config.id
        wanted: Dict[str, Replica] = {}
        for rep in update.replicas:
            if rep.is_being_deleted:
                continue
            if my_id in rep.replicas:
                wanted[partition_replica_key(rep.topic, rep.partition)] = rep
        # adds / role changes (promotion and demotion preserve storage)
        for key, rep in wanted.items():
            if rep.leader == my_id:
                if key in self.ctx.followers:
                    logger.info("replica promote (follower -> leader): %s", key)
                    self.ctx.promote_follower(rep.topic, rep.partition)
                elif key not in self.ctx.leaders:
                    logger.info("replica add (leader): %s", key)
                self.ctx.create_replica(rep.topic, rep.partition, len(rep.replicas), rep.config)
            elif key in self.ctx.leaders:
                logger.info("replica demote (leader -> follower): %s", key)
                self.ctx.demote_leader(rep.topic, rep.partition, rep.leader)
            else:
                cur = self.ctx.followers.get(key)
                if cur is None:
                    logger.info("replica add (follower of %s): %s", rep.leader, key)
                    self.ctx.create_follower(rep.topic, rep.partition, rep.leader, rep.config)
                elif cur.leader != rep.leader:
                    logger.info("follower %s re-pointed to leader %s", key, rep.leader)
                    cur.leader = rep.leader
        if update.sync_all:
            # removes: replicas held here that are no longer assigned here
            for key in list(self.ctx.leaders):
                if key in wanted:
                    continue  # kept, or demoted above
                logger.info("replica remove (leader): %s", key)
                leader = self.ctx.leaders.pop(key)
                leader.close()
                if self._socket is not None:
                    try:
                        await self._socket.send_receive(
                            ReplicaRemovedRequest(
                                spu_id=my_id,
                                topic=leader.topic,
                                partition=leader.partition,
                            )
                        )
                    except Exception:
                        pass
            for key in list(self.ctx.followers):
                if key not in wanted:
                    logger.info("replica remove (follower): %s", key)
                    self.ctx.followers.pop(key).close()
        self.ctx.notify_followers_changed()

    def _apply_smartmodules(self, update: InternalUpdate) -> None:
        store = self.ctx.smartmodules
        for sm in update.smartmodules:
            store.insert(sm.name, sm.payload)
        if update.sync_all:
            present = {sm.name for sm in update.smartmodules}
            for name in store.names():
                if name not in present:
                    store.remove(name)
        else:
            for name in update.deleted:
                store.remove(name)
        # bundled modules survive syncs: deleting an SC override restores
        # the built-in payload
        for name, payload in builtin_sources().items():
            if store.get(name) is None:
                store.insert(name, payload)

    # -- LRS reporting -------------------------------------------------------

    def _collect_lrs(self) -> list[LrsStatus]:
        """Each leader's offsets, and its followers' as last reported."""
        out = []
        for leader in self.ctx.leaders.values():
            info = leader.offsets()
            out.append(
                LrsStatus(
                    topic=leader.topic,
                    partition=leader.partition,
                    leader=ReplicaStatusUpdate(
                        spu=self.ctx.config.id, hw=info.hw, leo=info.leo
                    ),
                    replicas=[
                        ReplicaStatusUpdate(spu=sid, leo=leo, hw=hw)
                        for sid, (leo, hw) in leader.followers.items()
                    ],
                )
            )
        return out

    async def _lrs_loop(self) -> None:
        last: dict[str, tuple] = {}
        while True:
            await asyncio.sleep(LRS_POLL_INTERVAL)
            socket = self._socket
            if socket is None:
                continue
            updates = []
            for lrs in self._collect_lrs():
                key = f"{lrs.topic}-{lrs.partition}"
                # the key covers the followers' offsets too: a follower
                # catching up must reach the SC even when the leader's own
                # offsets are unchanged
                cur = (
                    lrs.leader.hw,
                    lrs.leader.leo,
                    tuple(sorted((r.spu, r.leo, r.hw) for r in lrs.replicas)),
                )
                if last.get(key) != cur:
                    last[key] = cur
                    updates.append(lrs)
            if not updates:
                continue
            try:
                await socket.send_receive(
                    UpdateLrsRequest(spu_id=self.ctx.config.id, updates=updates)
                )
            except Exception:
                pass  # session teardown will reconnect
