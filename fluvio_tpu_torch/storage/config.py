"""Storage configuration (the port's copy of
``fluvio_tpu/storage/config.py``; parity: fluvio-storage/src/config.rs).

Retention is not ported: there is no cleaner, so a replica keeps every
segment until it is removed, and the config carries no retention window
or partition size. A produce to a topic that sets either answers
``STORAGE_ERROR`` (`spu.public_service.handle_produce`)."""

from __future__ import annotations

from dataclasses import dataclass

@dataclass
class ReplicaConfig:
    base_dir: str = "."
    segment_max_bytes: int = 1 << 30  # 1 GB, reference default
    index_max_bytes: int = 10 << 20  # mmap'd index capacity
    index_max_interval_bytes: int = 4096  # entry every N log bytes
    flush_write_count: int = 1  # fsync every N writes; 0 = OS-buffered
