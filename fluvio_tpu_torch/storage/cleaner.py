"""Retention cleaner (the port's copy of ``fluvio_tpu/storage/cleaner.py``;
parity: fluvio-storage/src/cleaner.rs).

Removes read-only segments whose newest record exceeds the retention age,
and (when ``max_partition_size`` is set) oldest-first until the partition
fits. Never touches the active segment.
"""

from __future__ import annotations

import time
from typing import List

from fluvio_tpu_torch.storage.replica import FileReplica


class Cleaner:
    def __init__(self, replica: FileReplica):
        self.replica = replica

    def clean(self, now_ms: int | None = None, unlink: bool = True) -> List[int]:
        """Run one cleaning pass; returns removed segment base offsets.

        ``unlink=False`` detaches segments from the replica (new reads
        can no longer reach them) but leaves the files on disk and
        returns via `detached` — callers with in-flight path-based file
        slices defer the unlink until those reads have drained.
        """
        config = self.replica.config
        now = int(time.time() * 1000) if now_ms is None else now_ms
        removed: List[int] = []
        self.detached: List[object] = []

        def shed(base: int) -> None:
            seg = self.replica.prev_segments.pop(base)
            if unlink:
                seg.remove_files()
            else:
                self.detached.append(seg)
            removed.append(base)

        # age-based
        cutoff = now - config.retention_seconds * 1000
        for base in sorted(self.replica.prev_segments):
            seg = self.replica.prev_segments[base]
            newest = seg.newest_timestamp()
            if newest != -1 and newest < cutoff:
                shed(base)
            else:
                break  # segments are time-ordered

        # size-based
        if config.max_partition_size is not None:
            def total_size() -> int:
                return self.replica.active_segment.size + sum(
                    s.size for s in self.replica.prev_segments.values()
                )

            for base in sorted(self.replica.prev_segments):
                if total_size() <= config.max_partition_size:
                    break
                shed(base)
        return removed
