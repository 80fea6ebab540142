"""Storage configuration (the port's copy of
``fluvio_tpu/storage/config.py``; parity: fluvio-storage/src/config.rs)."""

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
