"""Leader replica state: storage and offset event publishing.

The port's copy of the leader half of ``fluvio_tpu/spu/replica.py``
(parity: fluvio-spu/src/replication/leader/replica_state.rs):
`LeaderReplicaState` owns the `FileReplica`, serializes writes
(`write_record_set`), advances the high watermark on the local write
and publishes LEO and HW changes on `OffsetPublisher`s, which wake the
stream-fetch loops. A chain attached as ``sm_chain`` transforms every
produced record set before the log append. Followers and replication,
and with them an in-sync quorum above 1, are not ported yet.
"""

from __future__ import annotations

import asyncio

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

    def __init__(self, topic: str, partition: int, config: ReplicaConfig):
        self.topic = topic
        self.partition = partition
        self.replica_key = partition_replica_key(topic, partition)
        self.storage = FileReplica(topic, partition, 0, config)
        self.leo_publisher = OffsetPublisher(self.storage.get_leo())
        self.hw_publisher = OffsetPublisher(self.storage.get_hw())
        self._write_lock = asyncio.Lock()
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
        """Append batches; the HW advances with the local write.

        Returns the base offset assigned to the first batch.
        """
        async with self._write_lock:
            if self.sm_chain is not None:
                # the chain runs on the card: keep it off the event loop
                # (the write lock already serializes this chain)
                records = await asyncio.to_thread(self._transform, records)
                if not records.batches:
                    return self.storage.get_leo()
            base = self.storage.write_recordset(records, update_highwatermark=True)
        self.leo_publisher.update(self.storage.get_leo())
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

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self.storage.close()

    def remove(self) -> None:
        self.storage.remove()
