"""Storage configuration (the port's copy of
``fluvio_tpu/storage/config.py``; parity: fluvio-storage/src/config.rs).

``retention_seconds`` and ``max_partition_size`` bound what a replica
keeps: the cleaner (`storage.cleaner.Cleaner`, swept by the SPU's
`spu.cleaner_controller.CleanerController`) sheds read-only segments
whose newest record is older than the window, then, when a size is set,
the oldest until the partition fits."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ReplicaConfig:
    base_dir: str = "."
    segment_max_bytes: int = 1 << 30  # 1 GB, reference default
    index_max_bytes: int = 10 << 20  # mmap'd index capacity
    index_max_interval_bytes: int = 4096  # entry every N log bytes
    retention_seconds: int = 7 * 24 * 3600
    max_partition_size: Optional[int] = None  # size-based retention when set
    flush_write_count: int = 1  # fsync every N writes; 0 = OS-buffered
