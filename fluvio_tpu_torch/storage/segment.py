"""Log segment: batch stream file + sparse index (the port's copy of
``fluvio_tpu/storage/segment.py``).

Parity: fluvio-storage/src/segment.rs. A segment is
``<base_offset:020d>.log`` holding wire-format batches back to back, plus
its ``.index``. The active (mutable) segment appends and rolls; read-only
segments serve slices. ``validate_and_repair`` (segment.rs:353) scans the
tail on load and truncates torn writes.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

from fluvio_tpu_torch.protocol.record import (
    BATCH_HEADER_SIZE,
    BATCH_PREAMBLE_SIZE,
    Batch,
)
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.storage.index import OffsetIndex

_PREAMBLE = struct.Struct(">qi")  # base_offset, batch_len


def log_name(base_offset: int) -> str:
    return f"{base_offset:020d}.log"


def index_name(base_offset: int) -> str:
    return f"{base_offset:020d}.index"


@dataclass
class BatchPosition:
    """Shallow batch header info + its file location."""

    base_offset: int
    batch_len: int  # bytes after the preamble
    position: int  # file offset of the preamble
    last_offset_delta: int
    first_timestamp: int
    max_timestamp: int

    @property
    def end_position(self) -> int:
        return self.position + BATCH_PREAMBLE_SIZE + self.batch_len

    @property
    def last_offset(self) -> int:
        return self.base_offset + self.last_offset_delta

    @property
    def records_end_offset(self) -> int:
        """Offset after the batch's last record."""
        return self.base_offset + self.last_offset_delta + 1


class Segment:
    """One log segment; mutable when ``writable``."""

    def __init__(self, directory: str, base_offset: int, config: ReplicaConfig, writable: bool):
        self.directory = directory
        self.base_offset = base_offset
        self.config = config
        self.writable = writable
        self.log_path = os.path.join(directory, log_name(base_offset))
        mode = "a+b" if writable else "rb"
        exists = os.path.exists(self.log_path)
        if not exists and not writable:
            raise FileNotFoundError(self.log_path)
        self._file = open(self.log_path, mode)
        self.index = OffsetIndex(
            os.path.join(directory, index_name(base_offset)), config.index_max_bytes
        )
        self.size = os.path.getsize(self.log_path)
        self.end_offset = base_offset  # next offset; fixed up by validation
        self._writes_since_flush = 0
        self._newest_ts_cache: Optional[int] = None

    # -- scanning / recovery ------------------------------------------------

    def scan_batches(self, from_position: int = 0) -> Iterator[BatchPosition]:
        """Yield shallow batch positions; stops cleanly at a torn tail."""
        with open(self.log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            file_size = f.tell()
            pos = from_position
            while pos + BATCH_PREAMBLE_SIZE + BATCH_HEADER_SIZE <= file_size:
                f.seek(pos)
                preamble = f.read(BATCH_PREAMBLE_SIZE)
                if len(preamble) < BATCH_PREAMBLE_SIZE:
                    return
                base_offset, batch_len = _PREAMBLE.unpack(preamble)
                if batch_len < BATCH_HEADER_SIZE or pos + BATCH_PREAMBLE_SIZE + batch_len > file_size:
                    return  # torn write
                header = f.read(BATCH_HEADER_SIZE)
                # header layout: epoch i32, magic i8, crc u32, attrs i16,
                # last_offset_delta i32, first_ts i64, max_ts i64, ...
                last_offset_delta = struct.unpack(">i", header[11:15])[0]
                first_ts = struct.unpack(">q", header[15:23])[0]
                max_ts = struct.unpack(">q", header[23:31])[0]
                yield BatchPosition(
                    base_offset=base_offset,
                    batch_len=batch_len,
                    position=pos,
                    last_offset_delta=last_offset_delta,
                    first_timestamp=first_ts,
                    max_timestamp=max_ts,
                )
                pos += BATCH_PREAMBLE_SIZE + batch_len

    def validate_and_repair(self) -> int:
        """Scan all batches, truncate a torn tail, rebuild end state.

        Returns the segment's end offset (next offset to assign).
        """
        end = self.base_offset
        valid_end_pos = 0
        for bp in self.scan_batches():
            end = bp.records_end_offset
            valid_end_pos = bp.end_position
        actual = os.path.getsize(self.log_path)
        if actual > valid_end_pos:
            # torn tail: truncate
            if self.writable:
                self._file.truncate(valid_end_pos)
                self._file.flush()
            else:
                with open(self.log_path, "r+b") as f:
                    f.truncate(valid_end_pos)
            self.index.truncate_to_position(valid_end_pos)
        self.size = valid_end_pos
        self.end_offset = end
        return end

    # -- append -------------------------------------------------------------

    def is_full(self) -> bool:
        return self.size >= self.config.segment_max_bytes

    def append_batch(self, batch: Batch) -> int:
        """Append an encoded batch; returns its file position."""
        assert self.writable
        from fluvio_tpu_torch.protocol.codec import ByteWriter

        w = ByteWriter()
        batch.encode(w)
        data = bytes(w.buf)
        pos = self.size
        self._file.seek(0, os.SEEK_END)
        self._file.write(data)
        self._writes_since_flush += 1
        if (
            self.config.flush_write_count
            and self._writes_since_flush >= self.config.flush_write_count
        ):
            self._file.flush()
            os.fsync(self._file.fileno())
            self._writes_since_flush = 0
        else:
            self._file.flush()
        self.size += len(data)
        self.end_offset = batch.computed_last_offset()
        self.index.try_add(
            batch.base_offset - self.base_offset,
            pos,
            len(data),
            self.config.index_max_interval_bytes,
        )
        return pos

    # -- reads --------------------------------------------------------------

    def find_offset_position(self, offset: int) -> Optional[BatchPosition]:
        """Locate the batch containing ``offset`` (index hint + scan)."""
        if offset < self.base_offset:
            return None
        start = self.index.lookup(offset - self.base_offset)
        for bp in self.scan_batches(start):
            if bp.records_end_offset > offset:
                return bp
            if bp.base_offset > offset:
                return None
        return None

    def newest_timestamp(self) -> int:
        """Max record timestamp; cached for sealed (read-only) segments."""
        if not self.writable and self._newest_ts_cache is not None:
            return self._newest_ts_cache
        ts = -1
        for bp in self.scan_batches():
            ts = bp.max_timestamp
        if not self.writable:
            self._newest_ts_cache = ts
        return ts

    # -- lifecycle ----------------------------------------------------------

    def to_readonly(self) -> "Segment":
        self.close()
        return Segment(self.directory, self.base_offset, self.config, writable=False)

    def flush(self) -> None:
        if self.writable:
            self._file.flush()
            os.fsync(self._file.fileno())
        self.index.flush()

    def close(self) -> None:
        try:
            self._file.flush()
        except ValueError:
            pass
        self._file.close()
        self.index.close()

    def remove_files(self) -> None:
        self.close()
        for path in (self.log_path, os.path.join(self.directory, index_name(self.base_offset))):
            if os.path.exists(path):
                os.remove(path)
