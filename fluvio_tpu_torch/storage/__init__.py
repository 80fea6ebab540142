"""Per-partition append-only log storage of the port (copies of
``fluvio_tpu/storage``'s modules; parity: the `fluvio-storage` crate).

`FileReplica` holds rolling segments (a ``.log`` batch stream and a
sparse ``.index``), the high-watermark checkpoint (``replication.chk``),
crash validation on load, and offset-addressed file-slice reads that feed
the consume path (`ReplicaSlice`). `Cleaner` sheds read-only segments by
age and by the partition's size (cleaner.rs).
"""

from fluvio_tpu_torch.storage.cleaner import Cleaner
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.storage.replica import FileReplica, FileSlice, OffsetInfo, ReplicaSlice

__all__ = [
    "FileReplica",
    "FileSlice",
    "ReplicaSlice",
    "OffsetInfo",
    "ReplicaConfig",
    "Cleaner",
]
