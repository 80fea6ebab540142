"""FileReplica — the per-partition log (the port's copy of
``fluvio_tpu/storage/replica.py``; parity: fluvio-storage/src/replica.rs).

Active mutable segment + ordered read-only segments, high-watermark
checkpoint, offset-addressed slice reads for the consume path, and
crash-safe loading (every segment validated/truncated on open).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from fluvio_tpu_torch.protocol.codec import ByteReader
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.protocol.record import Batch, Record, RecordSet
from fluvio_tpu_torch.storage.checkpoint import CheckPoint
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.storage.segment import Segment
from fluvio_tpu_torch.types import NO_TIMESTAMP

ISOLATION_READ_UNCOMMITTED = "read_uncommitted"
ISOLATION_READ_COMMITTED = "read_committed"


@dataclass
class FileSlice:
    """A (path, position, length) view into a log file.

    The transport layer turns this into ``socket.sendfile`` — the zero-copy
    consume path (parity: AsyncFileSlice + encode_file_slices,
    fluvio-socket/src/sink.rs:123).
    """

    path: str
    position: int
    length: int

    def read_bytes(self) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(self.position)
            return f.read(self.length)


@dataclass
class OffsetInfo:
    start_offset: int
    hw: int
    leo: int


@dataclass
class ReplicaSlice:
    start: OffsetInfo
    end: Optional[OffsetInfo] = None
    file_slice: Optional[FileSlice] = None
    # offset after the last record covered by file_slice; lets the consume
    # path advance its cursor without decoding the batches it sendfile()s
    next_offset: Optional[int] = None

    def decode_batches(self, parse_records: bool = True) -> List[Batch]:
        """Parse the slice into batches (the non-zero-copy read paths)."""
        if self.file_slice is None:
            return []
        r = ByteReader(self.file_slice.read_bytes())
        batches: List[Batch] = []
        while r.remaining() > 0:
            batches.append(Batch.decode(r, parse_records=parse_records))
        return batches


class FileReplica:
    """One partition's storage."""

    CHECKPOINT_FILE = "replication.chk"

    def __init__(self, topic: str, partition: int, base_offset: int, config: ReplicaConfig):
        self.topic = topic
        self.partition = partition
        self.config = config
        self.directory = os.path.join(config.base_dir, f"{topic}-{partition}")
        os.makedirs(self.directory, exist_ok=True)

        bases = sorted(
            int(name.split(".")[0])
            for name in os.listdir(self.directory)
            if name.endswith(".log")
        )
        self.prev_segments: Dict[int, Segment] = {}
        if bases:
            for base in bases[:-1]:
                seg = Segment(self.directory, base, config, writable=False)
                seg.validate_and_repair()
                self.prev_segments[base] = seg
            active_base = bases[-1]
        else:
            active_base = base_offset
        self.active_segment = Segment(self.directory, active_base, config, writable=True)
        self._leo = self.active_segment.validate_and_repair()

        self.checkpoint = CheckPoint(
            os.path.join(self.directory, self.CHECKPOINT_FILE), initial=self._leo
        )
        hw = self.checkpoint.get_offset()
        if hw > self._leo:
            self.checkpoint.write(self._leo)

    # -- offsets ------------------------------------------------------------

    def get_leo(self) -> int:
        """Log end offset: next offset to be written."""
        return self._leo

    def get_hw(self) -> int:
        return min(self.checkpoint.get_offset(), self._leo)

    def get_log_start_offset(self) -> int:
        if self.prev_segments:
            return min(self.prev_segments)
        return self.active_segment.base_offset

    def update_high_watermark(self, offset: int) -> bool:
        """Returns True if changed; offset must be <= leo."""
        if offset > self._leo:
            raise FluvioError(
                ErrorCode.OFFSET_OUT_OF_RANGE,
                f"hw {offset} cannot exceed leo {self._leo}",
            )
        if offset == self.get_hw():
            return False
        self.checkpoint.write(offset)
        return True

    def update_high_watermark_to_end(self) -> bool:
        return self.update_high_watermark(self._leo)

    # -- write --------------------------------------------------------------

    def write_recordset(self, records: RecordSet, update_highwatermark: bool = False) -> int:
        """Assign offsets, append every batch, optionally advance HW.

        Returns the base offset of the first appended batch.
        """
        base = self._leo
        for batch in records.batches:
            self.write_batch(batch)
        if update_highwatermark:
            self.update_high_watermark_to_end()
        return base

    def write_batch(self, batch: Batch) -> None:
        batch.base_offset = self._leo
        if self.active_segment.is_full():
            self._roll_segment()
        self.active_segment.append_batch(batch)
        self._leo = batch.computed_last_offset()

    def _roll_segment(self) -> None:
        old = self.active_segment
        base = old.end_offset
        size = old.size
        readonly = old.to_readonly()
        readonly.end_offset = base
        readonly.size = size
        self.prev_segments[readonly.base_offset] = readonly
        self.active_segment = Segment(self.directory, base, self.config, writable=True)
        self.active_segment.end_offset = base

    # -- read ---------------------------------------------------------------

    def _segment_for(self, offset: int) -> Optional[Segment]:
        if offset >= self.active_segment.base_offset:
            return self.active_segment
        candidates = [b for b in self.prev_segments if b <= offset]
        if not candidates:
            return None
        base = max(candidates)
        seg = self.prev_segments[base]
        if offset >= seg.end_offset:
            return None
        return seg

    def offsets(self) -> OffsetInfo:
        return OffsetInfo(
            start_offset=self.get_log_start_offset(), hw=self.get_hw(), leo=self._leo
        )

    def read_partition_slice(
        self,
        offset: int,
        max_bytes: int,
        isolation: str = ISOLATION_READ_UNCOMMITTED,
    ) -> ReplicaSlice:
        """Bounded raw slice starting at the batch containing ``offset``.

        The slice covers whole batches only, capped at ``max_bytes`` and at
        the isolation bound (HW for read-committed). A client skips records
        before its requested offset using offset deltas, like the
        reference.
        """
        bound = self.get_hw() if isolation == ISOLATION_READ_COMMITTED else self._leo
        info = self.offsets()
        if offset < self.get_log_start_offset() or offset > self._leo:
            raise FluvioError(
                ErrorCode.OFFSET_OUT_OF_RANGE,
                f"offset {offset} outside [{self.get_log_start_offset()}, {self._leo}]",
            )
        if offset >= bound:
            return ReplicaSlice(start=info)

        seg = self._segment_for(offset)
        if seg is None:
            raise FluvioError(ErrorCode.OFFSET_OUT_OF_RANGE, f"no segment for {offset}")
        # one scan from the index hint: locate the target batch, then keep
        # iterating to widen up to max_bytes / the isolation bound
        start_bp = None
        end_pos = 0
        next_off = offset
        hint = seg.index.lookup(max(offset - seg.base_offset, 0))
        for bp in seg.scan_batches(hint):
            if start_bp is None:
                if bp.records_end_offset > offset:
                    start_bp = bp
                    end_pos = bp.end_position
                    next_off = bp.records_end_offset
                elif bp.base_offset > offset:
                    break
                continue
            if bp.base_offset >= bound:
                break
            if bp.end_position - start_bp.position > max_bytes:
                break
            end_pos = bp.end_position
            next_off = bp.records_end_offset
        if start_bp is None:
            return ReplicaSlice(start=info)
        length = end_pos - start_bp.position
        if length <= 0:
            return ReplicaSlice(start=info)
        return ReplicaSlice(
            start=info,
            file_slice=FileSlice(seg.log_path, start_bp.position, length),
            next_offset=next_off,
        )

    def read_records(
        self,
        offset: int,
        max_bytes: int,
        isolation: str = ISOLATION_READ_UNCOMMITTED,
    ) -> List[Batch]:
        """Parsed batches (test/lookback convenience over the slice path)."""
        return self.read_partition_slice(offset, max_bytes, isolation).decode_batches()

    def read_last_records(
        self, count: int, min_timestamp: Optional[int] = None
    ) -> List[Record]:
        """Recent records before HW (lookback support).

        ``count`` > 0 bounds the result to the last N records;
        ``min_timestamp`` (ms, resolved per record from its batch header)
        drops older records — together they implement Lookback::Last and
        Lookback::Age{age, last}. With only an age bound the walk starts at
        the log start (no time index yet).
        """
        hw = self.get_hw()
        if min_timestamp is None and count <= 0:
            return []
        if min_timestamp is not None:
            start = self.get_log_start_offset()
        else:
            start = max(self.get_log_start_offset(), hw - count)
        records: List[Record] = []
        off = start
        while off < hw:
            batches = self.read_records(off, 1 << 30, ISOLATION_READ_COMMITTED)
            if not batches:
                break
            for batch in batches:
                base_ts = batch.header.first_timestamp
                for rec in batch.memory_records():
                    abs_offset = batch.base_offset + rec.offset_delta
                    if not (start <= abs_offset < hw):
                        continue
                    if min_timestamp is not None:
                        abs_ts = (
                            base_ts + rec.timestamp_delta
                            if base_ts != NO_TIMESTAMP
                            else NO_TIMESTAMP
                        )
                        # records with no timestamp never satisfy an age bound
                        if abs_ts < min_timestamp:
                            continue
                    records.append(rec)
            off = batches[-1].computed_last_offset()
        return records[-count:] if count else records

    # -- lifecycle ----------------------------------------------------------

    def flush(self) -> None:
        self.active_segment.flush()

    def close(self) -> None:
        self.active_segment.close()
        for seg in self.prev_segments.values():
            seg.close()

    def remove(self) -> None:
        self.close()
        import shutil

        shutil.rmtree(self.directory, ignore_errors=True)
