"""Leader replica state: storage, offset event publishing and the
followers' offsets.

The port's copy of the leader half of ``fluvio_tpu/spu/replica.py``
(parity: fluvio-spu/src/replication/leader/replica_state.rs):
`LeaderReplicaState` owns the `FileReplica`, serializes writes
(`write_record_set`), and publishes LEO and HW changes on
`OffsetPublisher`s, which wake the stream-fetch loops and the followers'
push loops. With ``in_sync_replica`` 1 the high watermark advances on the
local write; above 1 it advances as followers report their offsets
(`update_follower_offsets`, replica_state.rs:172), to the highest offset
``in_sync_replica - 1`` followers hold. A chain attached as ``sm_chain``
(a topic's dedup filter, `smart_chain.ensure_dedup_chain`, whose hooks run
on the host) transforms every produced record set before the log append.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Tuple

from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.protocol.record import RecordSet
from fluvio_tpu_torch.schema.spu import Isolation
from fluvio_tpu_torch.spu.smart_chain import apply_chain
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.storage.replica import (
    ISOLATION_READ_COMMITTED,
    ISOLATION_READ_UNCOMMITTED,
    FileReplica,
    OffsetInfo,
    ReplicaSlice,
)
from fluvio_tpu_torch.types import OffsetPublisher, partition_replica_key


def _isolation_str(isolation: Isolation) -> str:
    return (
        ISOLATION_READ_COMMITTED
        if isolation == Isolation.READ_COMMITTED
        else ISOLATION_READ_UNCOMMITTED
    )


class LeaderReplicaState:
    """One partition's leader: storage, write lock and offset buses."""

    def __init__(
        self, topic: str, partition: int, config: ReplicaConfig, in_sync_replica: int = 1
    ):
        self.topic = topic
        self.partition = partition
        self.replica_key = partition_replica_key(topic, partition)
        self.in_sync_replica = in_sync_replica
        self.storage = FileReplica(topic, partition, 0, config)
        self.leo_publisher = OffsetPublisher(self.storage.get_leo())
        self.hw_publisher = OffsetPublisher(self.storage.get_hw())
        self._write_lock = asyncio.Lock()
        # follower spu id -> (leo, hw) as last reported (replica_state.rs:172)
        self.followers: Dict[int, Tuple[int, int]] = {}
        # a persistent chain every produced record set runs through before
        # the log append (parity: replica_state.rs:394-405 sm_ctx)
        self.sm_chain = None
        self.sm_chain_metrics = None

    # -- offsets ------------------------------------------------------------

    def leo(self) -> int:
        return self.storage.get_leo()

    def hw(self) -> int:
        return self.storage.get_hw()

    def offsets(self) -> OffsetInfo:
        return self.storage.offsets()

    def offset_publisher(self, isolation: Isolation) -> OffsetPublisher:
        """The bus a consumer stream waits on for new data."""
        if isolation == Isolation.READ_COMMITTED:
            return self.hw_publisher
        return self.leo_publisher

    def read_bound(self, isolation: Isolation) -> int:
        return self.hw() if isolation == Isolation.READ_COMMITTED else self.leo()

    # -- write path ---------------------------------------------------------

    async def write_record_set(self, records: RecordSet) -> int:
        """Append batches; with ``in_sync_replica`` 1 the HW advances
        with the local write, else as the followers report.

        Returns the base offset assigned to the first batch.
        """
        async with self._write_lock:
            if self.sm_chain is not None:
                # the chain runs on the card or in user hooks: keep it off
                # the event loop (the write lock already serializes it)
                records = await asyncio.to_thread(self._transform, records)
                if not records.batches:
                    return self.storage.get_leo()
            base = self.storage.write_recordset(
                records, update_highwatermark=(self.in_sync_replica <= 1)
            )
        self.leo_publisher.update(self.storage.get_leo())
        if self.in_sync_replica <= 1:
            self.hw_publisher.update(self.storage.get_hw())
        return base

    def _transform(self, records: RecordSet) -> RecordSet:
        """Run the attached chain over an incoming record set (parity:
        replica_state.rs:344-357 `transform`); a transform error fails the
        produce as a `FluvioError` the produce handler reports."""
        out, error = apply_chain(self.sm_chain, records, self.sm_chain_metrics)
        if error is not None:
            raise FluvioError(ErrorCode.SMARTMODULE_RUNTIME_ERROR, str(error))
        return out

    # -- read path ----------------------------------------------------------

    def read_records(self, offset: int, max_bytes: int, isolation: Isolation) -> ReplicaSlice:
        return self.storage.read_partition_slice(offset, max_bytes, _isolation_str(isolation))

    # -- follower tracking (replication) ------------------------------------

    def update_follower_offsets(self, spu_id: int, leo: int, hw: int) -> bool:
        """Record a follower's offsets and maybe advance the HW.

        Parity: update_states_from_followers (replica_state.rs:172) —
        HW advances to the highest offset replicated by at least
        ``in_sync_replica - 1`` followers (leader included, bounded by
        the leader's LEO). Returns True when the HW moved.
        """
        self.followers[spu_id] = (leo, hw)
        if self.in_sync_replica <= 1:
            return False
        needed = self.in_sync_replica - 1  # followers besides the leader
        follower_leos = sorted((l for (l, _) in self.followers.values()), reverse=True)
        if len(follower_leos) < needed:
            return False
        candidate = min(self.leo(), follower_leos[needed - 1])
        if candidate > self.hw():
            self.storage.update_high_watermark(candidate)
            self.hw_publisher.update(self.storage.get_hw())
            return True
        return False

    def drop_follower(self, spu_id: int) -> None:
        self.followers.pop(spu_id, None)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self.storage.close()

    def remove(self) -> None:
        self.storage.remove()
