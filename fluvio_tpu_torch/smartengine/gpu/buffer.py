"""RecordBuffer — the batched-record layout the GPU chain stages.

The port's copy of ``fluvio_tpu/smartengine/tpu/buffer.py``: records sit
in padded columnar numpy arrays on the host; the executor ships the
4-aligned ragged form of the values (`ragged_values`) to the card and
re-pads it there. Output buffers of view-mode chains are FLAT-BACKED
(``values is None``): they hold only the aligned flat and its starts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

NO_TIMESTAMP = -1
MIN_ROWS = 8
MIN_WIDTH = 32
# widest record the narrow (one row per record) layout stages; wider
# records stage as striped segments (`gpu/stripes.py`) up to the hard
# staging ceiling below
MAX_WIDTH = 1 << 16
MAX_RECORD_WIDTH = 1 << 20
# int32 addressing ceiling for one staged batch: every flat byte offset on
# the card (the cumsum of aligned lengths in `ragged_repad_words`) is i32
FLAT_ADDRESS_MAX = 2**31 - 1


class FlatAddressingError(ValueError):
    """The batch's byte extent exceeds int32 addressing — split the batch
    before staging."""


def check_flat_addressing(lengths, count: Optional[int] = None) -> int:
    """Total 4-aligned flat bytes of the live rows; raises
    :class:`FlatAddressingError` past ``FLAT_ADDRESS_MAX``. Computed on an
    int64 host mirror, so the check itself cannot overflow."""
    lengths64 = np.asarray(lengths, dtype=np.int64)
    if count is not None:
        lengths64 = lengths64[:count]
    total = int(((lengths64 + 3) & ~3).sum())
    if total > FLAT_ADDRESS_MAX:
        raise FlatAddressingError(
            f"4-aligned flat of {total} bytes exceeds int32 addressing "
            f"({FLAT_ADDRESS_MAX}); split the batch before staging"
        )
    return total


def _check_matrix_addressing(rows: int, width: int) -> None:
    """``rows x width`` bounds every per-batch flat extent (lengths are
    <= the width), so bounding it under int32 bounds them all."""
    if rows * width > FLAT_ADDRESS_MAX:
        raise FlatAddressingError(
            f"staged matrix {rows} x {width} = {rows * width} bytes "
            f"exceeds int32 addressing ({FLAT_ADDRESS_MAX}); split the "
            "batch before staging"
        )


def apply_postops_host(values: np.ndarray, postops) -> np.ndarray:
    """Host mirror of `lower.apply_postops`: static byte-wise case folds
    applied after view-mode materialization (case folds flip bit 5 of
    ASCII letters; padding zeros are outside both letter ranges)."""
    for op in postops:
        lo, hi = (0x61, 0x7A) if op == "upper" else (0x41, 0x5A)
        fold = (values >= lo) & (values <= hi)
        values = np.where(fold, values ^ 0x20, values).astype(np.uint8)
    return values


def ragged_range_select(
    flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray
) -> np.ndarray:
    """Extract ascending, DISJOINT byte ranges [starts[i], +lengths[i])
    from ``flat`` with one diff-mark + cumsum boolean select. Callers own
    the precondition: ranges are ascending, non-overlapping (the running
    sum then stays in {0, 1}, which makes the int8 cumsum safe) and end
    within ``flat``."""
    marks = np.zeros(len(flat) + 1, dtype=np.int8)
    np.add.at(marks, starts, 1)
    np.add.at(marks, starts + lengths, -1)
    keep = np.cumsum(marks[:-1], dtype=np.int8).view(np.bool_)
    return flat[keep]


def _next_pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v <<= 1
    return v


def bucket_width(max_v: int) -> int:
    """Value-matrix width bucket: pure pow2 up to 128, then pow2/8-granular
    steps (multiples of 32). Per-record kernels walk every column, so
    padding is work."""
    v = _next_pow2(max(max_v, 1), MIN_WIDTH)
    if v <= 128:
        return v
    step = max(32, v >> 3)
    return ((max_v + step - 1) // step) * step


@dataclass
class RecordBuffer:
    """Padded columnar record batch (numpy on the host).

    - ``values``: uint8 [N, L]; row i holds record i's value bytes, zero-pad
    - ``lengths``: int32 [N]
    - ``keys``: uint8 [N, LK]; ``key_lengths`` int32 [N], -1 = null key
    - ``offset_deltas``: int32 [N]; ``timestamp_deltas``: int64 [N]
    - ``count``: live rows (rows >= count are padding)
    """

    values: Optional[np.ndarray]
    lengths: np.ndarray
    keys: np.ndarray
    key_lengths: np.ndarray
    offset_deltas: np.ndarray
    timestamp_deltas: np.ndarray
    count: int
    base_offset: int = 0
    base_timestamp: int = NO_TIMESTAMP
    # cached ragged (flat) form of `values`. A FLAT-BACKED buffer
    # (`values is None`) holds ONLY this form; `_width`/`_rows` carry the
    # shape the padded matrix would have.
    _flat: Optional[np.ndarray] = None
    _starts: Optional[np.ndarray] = None
    _width: int = 0
    _rows: int = 0
    # the flat's glz link form, (chunk, stream or None, decline reason),
    # cached by the executor's up link
    _glz: Optional[tuple] = None

    @property
    def width(self) -> int:
        """Bucketed value-matrix width (valid in both backing modes)."""
        return self.values.shape[1] if self.values is not None else self._width

    @property
    def rows(self) -> int:
        return self.values.shape[0] if self.values is not None else self._rows

    def dense_values(self) -> np.ndarray:
        """The padded matrix; materialized on demand (and kept) for
        flat-backed buffers. The windowed runtime reads it; the chain
        executor ships the ragged form instead."""
        if self.values is None:
            rows, width = self._rows, self._width
            values = np.zeros((rows, width), dtype=np.uint8)
            flat, starts = self._flat, self._starts
            if len(flat):  # all-empty values (tombstones): zeros already
                mask = np.arange(width, dtype=np.int32)[None, :] < self.lengths[:, None]
                idx = starts.astype(np.int64)[:, None] + np.arange(width, dtype=np.int64)[None, :]
                values[mask] = flat[np.clip(idx, 0, len(flat) - 1)][mask]
            self.values = values
        return self.values

    def ragged_values(self) -> Tuple[np.ndarray, np.ndarray]:
        """(flat, starts): concatenated live bytes + per-row start index.

        Each record's span is padded to a 4-byte boundary so the device
        re-pad can gather whole i32 words. Cached on the buffer."""
        if self._flat is None:
            width = self.values.shape[1]
            check_flat_addressing(self.lengths)
            lengths4 = (self.lengths.astype(np.int64) + 3) & ~3
            # rows' padding bytes are already zero in `values`
            mask = np.arange(width, dtype=np.int64)[None, :] < lengths4[:, None]
            self._flat = np.ascontiguousarray(self.values[mask])
            starts = np.zeros(len(self.lengths), dtype=np.int64)
            starts[1:] = np.cumsum(lengths4[:-1])
            # check_flat_addressing above: every start fits i32
            self._starts = starts.astype(np.int32)
        return self._flat, self._starts

    def has_keys(self) -> bool:
        return bool((self.key_lengths[: self.count] >= 0).any())

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(
        cls,
        values: np.ndarray,
        lengths: np.ndarray,
        count: Optional[int] = None,
        keys: Optional[np.ndarray] = None,
        key_lengths: Optional[np.ndarray] = None,
        offset_deltas: Optional[np.ndarray] = None,
        timestamp_deltas: Optional[np.ndarray] = None,
        base_offset: int = 0,
        base_timestamp: int = NO_TIMESTAMP,
    ) -> "RecordBuffer":
        """Adopt pre-staged arrays. Rows must already be bucketed;
        ``count`` defaults to all rows."""
        rows = values.shape[0]
        _check_matrix_addressing(rows, values.shape[1])
        n = rows if count is None else count
        if keys is None:
            keys = np.zeros((rows, MIN_WIDTH), dtype=np.uint8)
            key_lengths = np.full(rows, -1, dtype=np.int32)
        if offset_deltas is None:
            offset_deltas = np.arange(rows, dtype=np.int32)
        if timestamp_deltas is None:
            timestamp_deltas = np.zeros(rows, dtype=np.int64)
        return cls(
            values=values,
            lengths=lengths.astype(np.int32),
            keys=keys,
            key_lengths=key_lengths.astype(np.int32),
            offset_deltas=offset_deltas,
            timestamp_deltas=timestamp_deltas,
            count=n,
            base_offset=base_offset,
            base_timestamp=base_timestamp,
        )

    @classmethod
    def from_values(
        cls,
        values: Sequence[bytes],
        base_offset: int = 0,
        base_timestamp: int = NO_TIMESTAMP,
    ) -> "RecordBuffer":
        """Stage record values (no keys, offsets 0..n-1, zero timestamp
        deltas) with one vectorized ragged copy."""
        n = len(values)
        rows = _next_pow2(max(n, 1), MIN_ROWS)
        lens = np.fromiter((len(v) for v in values), dtype=np.int64, count=n)
        max_v = int(lens.max()) if n else 0
        width = bucket_width(max_v)
        if width > MAX_RECORD_WIDTH:
            raise ValueError(f"record value of {max_v} bytes exceeds {MAX_RECORD_WIDTH}")
        _check_matrix_addressing(rows, width)
        arr = np.zeros((rows, width), dtype=np.uint8)
        flat = np.frombuffer(b"".join(values), dtype=np.uint8)
        starts = np.cumsum(lens) - lens
        dst_rows = np.repeat(np.arange(n), lens)
        dst_cols = np.arange(flat.size) - np.repeat(starts, lens)
        arr[dst_rows, dst_cols] = flat
        lengths = np.zeros(rows, dtype=np.int32)
        lengths[:n] = lens
        return cls.from_arrays(
            arr, lengths, count=n,
            base_offset=base_offset, base_timestamp=base_timestamp,
        )

    # -- materialization ----------------------------------------------------

    def value_list(self) -> List[bytes]:
        """Each live record's value bytes (either backing mode)."""
        if self.values is None:
            flat, starts = self._flat, self._starts
            return [
                flat[int(starts[i]) : int(starts[i]) + int(self.lengths[i])].tobytes()
                for i in range(self.count)
            ]
        return [
            self.values[i, : int(self.lengths[i])].tobytes() for i in range(self.count)
        ]

    def key_list(self) -> List[Optional[bytes]]:
        """Each live record's key bytes (None for a null key)."""
        return [
            None if int(k) < 0 else self.keys[i, : int(k)].tobytes()
            for i, k in enumerate(self.key_lengths[: self.count])
        ]
