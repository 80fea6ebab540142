"""Follower replica state and the per-leader sync controller.

The port's copy of ``fluvio_tpu/spu/follower.py`` (parity:
fluvio-spu/src/replication/follower/{state.rs:313,controller.rs:21,sync.rs}).
`FollowerReplicaState` owns the replica's storage and appends the
batches its leader pushes (`apply_sync`: overlaps skipped, a gap asks the
session to rebuild the replica); `FollowersController` groups the
followed replicas by leader SPU and keeps one sync connection a leader
alive with backoff, reporting the local offsets back after every apply
so the leader can advance its HW. The pushed batches arrive unparsed
(`schema.internal_spu.SyncRecords`), so the follower's log holds the
leader's bytes.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Dict, List

from fluvio_tpu_torch.protocol.record import RecordSet
from fluvio_tpu_torch.schema.internal_spu import (
    FollowerOffsetsRequest,
    FollowerSyncRequest,
    ReplicaOffsets,
    SyncRecords,
)
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.storage.replica import FileReplica
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket
from fluvio_tpu_torch.types import partition_replica_key

if TYPE_CHECKING:
    from fluvio_tpu_torch.spu.context import GlobalContext

logger = logging.getLogger(__name__)

RECONNECT_BACKOFF_MAX = 3.0


class FollowerReplicaState:
    """One partition this SPU follows: storage + leader id."""

    def __init__(
        self, topic: str, partition: int, leader: int, config: ReplicaConfig
    ):
        self.topic = topic
        self.partition = partition
        self.leader = leader
        self.replica_key = partition_replica_key(topic, partition)
        self._config = config
        self.storage = FileReplica(topic, partition, 0, config)

    def leo(self) -> int:
        return self.storage.get_leo()

    def hw(self) -> int:
        return self.storage.get_hw()

    def offsets(self) -> ReplicaOffsets:
        return ReplicaOffsets(
            topic=self.topic, partition=self.partition, leo=self.leo(), hw=self.hw()
        )

    def apply_sync(self, sync: SyncRecords) -> bool:
        """Append leader batches; advance HW bounded by local LEO.

        Leader-assigned base offsets equal the follower's LEO when logs
        agree (state.rs `update_from_leaders` semantics). Batches below
        the local LEO are resend overlaps and are skipped; a batch
        *above* the local LEO means this log diverged from the leader's
        — returns True so the sync session rebuilds the replica from
        the leader (reset_storage + renegotiate).
        """
        for batch in sync.records.batches:
            if batch.base_offset < self.storage.get_leo():
                continue  # already have it (leader resent an overlap)
            if batch.base_offset > self.storage.get_leo():
                logger.warning(
                    "follower %s diverged: leader batch at %s, local leo %s; "
                    "rebuilding from leader",
                    self.replica_key,
                    batch.base_offset,
                    self.storage.get_leo(),
                )
                return True
            rs = RecordSet(batches=[batch])
            self.storage.write_recordset(rs)
        if sync.leader_hw >= 0:
            new_hw = min(sync.leader_hw, self.leo())
            if new_hw > self.hw():
                self.storage.update_high_watermark(new_hw)
        return False

    def reset_storage(self) -> None:
        """Drop the local log and start empty (divergence recovery)."""
        self.storage.remove()
        self.storage = FileReplica(
            self.topic, self.partition, 0, self._config
        )

    def close(self) -> None:
        self.storage.close()

    def remove(self) -> None:
        self.storage.remove()


class FollowersController:
    """Keeps one sync connection per leader SPU alive.

    Parity: replication/follower/controller.rs — wakes when follower
    assignments change, (re)dials each leader's private endpoint with
    exponential backoff, and runs the pull loop.
    """

    def __init__(self, ctx: "GlobalContext"):
        self.ctx = ctx
        self._tasks: Dict[int, asyncio.Task] = {}  # leader id -> sync task
        self._wake = asyncio.Event()
        # per-leader change signals: an idle sync session must renegotiate
        # when its replica set changes, not wait for stream traffic
        self._session_wakes: Dict[int, asyncio.Event] = {}

    def notify(self) -> None:
        """Assignments or peer table changed: reconcile connections."""
        self._wake.set()
        for ev in self._session_wakes.values():
            ev.set()

    def start(self) -> None:
        self._main = asyncio.create_task(self._run(), name="followers-controller")

    async def stop(self) -> None:
        self._main.cancel()
        await asyncio.gather(self._main, return_exceptions=True)
        for t in self._tasks.values():
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks.values(), return_exceptions=True)
        self._tasks.clear()

    def _leaders_needed(self) -> Dict[int, List[FollowerReplicaState]]:
        groups: Dict[int, List[FollowerReplicaState]] = {}
        for st in self.ctx.followers.values():
            groups.setdefault(st.leader, []).append(st)
        return groups

    async def _run(self) -> None:
        while True:
            groups = self._leaders_needed()
            # stop connections to leaders we no longer follow
            for leader_id in list(self._tasks):
                if leader_id not in groups:
                    self._tasks.pop(leader_id).cancel()
            # start connections to new leaders
            for leader_id in groups:
                task = self._tasks.get(leader_id)
                if task is None or task.done():
                    self._tasks[leader_id] = asyncio.create_task(
                        self._sync_leader(leader_id),
                        name=f"follower-sync-{leader_id}",
                    )
            self._wake.clear()
            await self._wake.wait()

    async def _sync_leader(self, leader_id: int) -> None:
        backoff = 0.05
        while True:
            replicas = [
                st for st in self.ctx.followers.values() if st.leader == leader_id
            ]
            if not replicas:
                return
            peer = self.ctx.peers.get(leader_id)
            addr = peer.private_addr if peer else ""
            if addr and not addr.endswith(":0"):
                try:
                    await self._session(leader_id, addr)
                    backoff = 0.05
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    logger.debug("follower sync to %s failed: %s", leader_id, e)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, RECONNECT_BACKOFF_MAX)

    def _replica_set(self, leader_id: int) -> Dict[str, FollowerReplicaState]:
        return {
            key: st
            for key, st in self.ctx.followers.items()
            if st.leader == leader_id
        }

    async def _session(self, leader_id: int, addr: str) -> None:
        socket = await VersionedSerialSocket.connect(addr)
        wake = self._session_wakes.setdefault(leader_id, asyncio.Event())
        try:
            my_replicas = self._replica_set(leader_id)
            stream = await socket.create_stream(
                FollowerSyncRequest(
                    follower_id=self.ctx.config.id,
                    replicas=[st.offsets() for st in my_replicas.values()],
                ),
                queue_len=64,
            )
            logger.info(
                "follower %s syncing %d replicas from leader %s",
                self.ctx.config.id,
                len(my_replicas),
                leader_id,
            )
            wake.clear()
            while True:
                # race the stream against assignment changes so an idle
                # session still picks up newly-assigned replicas
                next_task = asyncio.ensure_future(stream.next())
                wake_task = asyncio.ensure_future(wake.wait())
                try:
                    done, _ = await asyncio.wait(
                        (next_task, wake_task), return_when=asyncio.FIRST_COMPLETED
                    )
                finally:
                    for t in (next_task, wake_task):
                        if not t.done():
                            t.cancel()
                if wake_task in done:
                    wake.clear()
                    if set(self._replica_set(leader_id)) != set(my_replicas):
                        break  # renegotiate the stream with the new set
                if next_task not in done:
                    continue
                sync = next_task.result()
                if sync is None:
                    break  # stream/socket ended
                key = partition_replica_key(sync.topic, sync.partition)
                st = self.ctx.followers.get(key)
                if st is None or st.leader != leader_id:
                    break  # assignment changed mid-stream
                if st.apply_sync(sync):
                    # divergence: rebuild this replica from the leader
                    st.reset_storage()
                    break
                await socket.send_receive(
                    FollowerOffsetsRequest(
                        follower_id=self.ctx.config.id, offsets=[st.offsets()]
                    )
                )
        finally:
            await socket.close()
