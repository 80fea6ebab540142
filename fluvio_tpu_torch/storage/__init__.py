"""Per-partition append-only log storage of the port (copies of
``fluvio_tpu/storage``'s modules; parity: the `fluvio-storage` crate).

`FileReplica` holds rolling segments (a ``.log`` batch stream and a
sparse ``.index``), the high-watermark checkpoint (``replication.chk``),
crash validation on load, and offset-addressed file-slice reads that feed
the consume path (`ReplicaSlice`). The retention cleaner is not ported
yet.
"""

from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.storage.replica import FileReplica, FileSlice, OffsetInfo, ReplicaSlice

__all__ = [
    "FileReplica",
    "FileSlice",
    "ReplicaSlice",
    "OffsetInfo",
    "ReplicaConfig",
]
