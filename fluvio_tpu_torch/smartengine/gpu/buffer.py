"""RecordBuffer — the batched-record layout the GPU chain stages.

The port's copy of ``fluvio_tpu/smartengine/tpu/buffer.py``: records sit
in padded columnar numpy arrays on the host; the executor ships the
4-aligned ragged form of the values (`ragged_values`) to the card and
re-pads it there. Output buffers of view-mode chains are FLAT-BACKED
(``values is None``): they hold only the aligned flat and its starts. So
are the consume path's inputs: `from_flat` adopts the native decoder's
aligned columns, which already are the upload form, and `to_columns`
hands an output to the native encoder without building a padded matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fluvio_tpu_torch.protocol.record import Record
from fluvio_tpu_torch.types import NO_TIMESTAMP
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
    # explode outputs are "fresh" records of their source record's stored
    # batch: these columns hold each row's batch rebase deltas, which the
    # consume path's coalescer sets (None = zeros, one batch)
    fresh_offset_deltas: Optional[np.ndarray] = None
    fresh_timestamp_deltas: Optional[np.ndarray] = None
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
    # an output batch's transform error: the chain met it at its first
    # failing record, and the rows are the output before it
    error: Optional[object] = None

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

    def record_bytes(self, row: int) -> Tuple[bytes, Optional[bytes]]:
        """(value, key) of one row (key None for a null key), read from
        either backing form without building the padded matrix."""
        n = int(self.lengths[row])
        if self.values is not None:
            value = self.values[row, :n].tobytes()
        else:
            start = int(self._starts[row])
            value = self._flat[start:start + n].tobytes()
        klen = int(self.key_lengths[row])
        return value, None if klen < 0 else self.keys[row, :klen].tobytes()

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
        deltas) with one masked assignment of the joined bytes: row-major,
        the mask's true cells are the values' bytes in order."""
        n = len(values)
        rows = _next_pow2(max(n, 1), MIN_ROWS)
        lengths = np.zeros(rows, dtype=np.int32)
        lengths[:n] = np.fromiter(map(len, values), dtype=np.int64, count=n)
        max_v = int(lengths.max())
        width = bucket_width(max_v)
        if width > MAX_RECORD_WIDTH:
            raise ValueError(f"record value of {max_v} bytes exceeds {MAX_RECORD_WIDTH}")
        _check_matrix_addressing(rows, width)
        arr = np.zeros((rows, width), dtype=np.uint8)
        arr[np.arange(width, dtype=np.int32)[None, :] < lengths[:, None]] = np.frombuffer(
            b"".join(values), dtype=np.uint8)
        return cls.from_arrays(
            arr, lengths, count=n,
            base_offset=base_offset, base_timestamp=base_timestamp,
        )

    @classmethod
    def from_records(
        cls,
        records: Sequence[Record],
        base_offset: int = 0,
        base_timestamp: int = NO_TIMESTAMP,
    ) -> "RecordBuffer":
        """Stage parsed records: values, keys (null keys have length -1),
        offset and timestamp deltas; each byte column is filled with one
        masked assignment of the joined bytes."""
        n = len(records)
        rows = _next_pow2(max(n, 1), MIN_ROWS)
        lens = np.zeros(rows, dtype=np.int32)
        lens[:n] = np.fromiter((len(r.value) for r in records), dtype=np.int64, count=n)
        klens = np.full(rows, -1, dtype=np.int32)
        klens[:n] = np.fromiter((-1 if r.key is None else len(r.key) for r in records),
                                dtype=np.int64, count=n)
        max_v = int(lens.max())
        max_k = max(int(klens.max()), 0)
        width = bucket_width(max_v)
        kwidth = _next_pow2(max_k, MIN_WIDTH) if max_k else MIN_WIDTH
        if width > MAX_RECORD_WIDTH:
            raise ValueError(f"record value of {max_v} bytes exceeds {MAX_RECORD_WIDTH}")
        _check_matrix_addressing(rows, width)
        values = np.zeros((rows, width), dtype=np.uint8)
        values[np.arange(width)[None, :] < lens[:, None]] = np.frombuffer(
            b"".join(r.value for r in records), dtype=np.uint8)
        keys = np.zeros((rows, kwidth), dtype=np.uint8)
        keys[np.arange(kwidth)[None, :] < klens[:, None]] = np.frombuffer(
            b"".join(r.key for r in records if r.key is not None), dtype=np.uint8)
        offset_deltas = np.zeros(rows, dtype=np.int32)
        offset_deltas[:n] = np.fromiter((r.offset_delta for r in records), dtype=np.int64, count=n)
        timestamp_deltas = np.zeros(rows, dtype=np.int64)
        timestamp_deltas[:n] = np.fromiter((r.timestamp_delta for r in records), dtype=np.int64,
                                           count=n)
        return cls(
            values=values,
            lengths=lens,
            keys=keys,
            key_lengths=klens,
            offset_deltas=offset_deltas,
            timestamp_deltas=timestamp_deltas,
            count=n,
            base_offset=base_offset,
            base_timestamp=base_timestamp,
        )

    @classmethod
    def from_smartmodule_input(cls, inp) -> "RecordBuffer":
        """Stage a `SmartModuleInput`'s records with its bases."""
        return cls.from_records(
            inp.into_records(), base_offset=inp.base_offset, base_timestamp=inp.base_timestamp
        )

    @staticmethod
    def _stage_meta_columns(cols: dict, rows: int, n: int):
        """Key, offset and timestamp columns of natively decoded columns
        (shared by `from_columns` and `from_flat`). Returns (keys,
        key_lengths, offset_deltas, timestamp_deltas)."""
        key_present = cols["key_present"].astype(bool)
        key_lengths = np.full(rows, -1, dtype=np.int32)
        if n and key_present.any():
            key_off = cols["key_off"]
            klive = (key_off[1:] - key_off[:-1]).astype(np.int32)
            key_lengths[:n] = np.where(key_present, klive, -1)
            kwidth = _next_pow2(max(int(klive.max()), 1), MIN_WIDTH)
            keys = np.zeros((rows, kwidth), dtype=np.uint8)
            kmask = np.arange(kwidth, dtype=np.int32)[None, :] < np.maximum(key_lengths, 0)[:, None]
            keys[kmask] = cols["key_flat"]
        else:
            keys = np.zeros((rows, MIN_WIDTH), dtype=np.uint8)
        offset_deltas = np.zeros(rows, dtype=np.int32)
        offset_deltas[:n] = cols["off_delta"]
        timestamp_deltas = np.zeros(rows, dtype=np.int64)
        timestamp_deltas[:n] = cols["ts_delta"]
        return keys, key_lengths, offset_deltas, timestamp_deltas

    @classmethod
    def from_columns(
        cls,
        cols: dict,
        base_offset: int = 0,
        base_timestamp: int = NO_TIMESTAMP,
    ) -> "RecordBuffer":
        """Adopt exact-packed decoded columns (`native.records.
        decode_record_columns` at ``align=1``), re-padded into the value
        matrix with one masked assignment."""
        n = cols["count"]
        rows = _next_pow2(max(n, 1), MIN_ROWS)
        val_off = cols["val_off"]
        lengths_live = (val_off[1:] - val_off[:-1]).astype(np.int32)
        max_v = int(lengths_live.max()) if n else 0
        width = bucket_width(max_v)
        _check_matrix_addressing(rows, width)
        if width > MAX_RECORD_WIDTH:
            raise ValueError(f"record value of {max_v} bytes exceeds {MAX_RECORD_WIDTH}")
        lengths = np.zeros(rows, dtype=np.int32)
        lengths[:n] = lengths_live
        values = np.zeros((rows, width), dtype=np.uint8)
        values[np.arange(width, dtype=np.int32)[None, :] < lengths[:, None]] = cols["val_flat"]
        keys, key_lengths, offset_deltas, timestamp_deltas = cls._stage_meta_columns(cols, rows, n)
        return cls(
            values=values,
            lengths=lengths,
            keys=keys,
            key_lengths=key_lengths,
            offset_deltas=offset_deltas,
            timestamp_deltas=timestamp_deltas,
            count=n,
            base_offset=base_offset,
            base_timestamp=base_timestamp,
        )

    @classmethod
    def from_flat(
        cls,
        cols: dict,
        base_offset: int = 0,
        base_timestamp: int = NO_TIMESTAMP,
    ) -> "RecordBuffer":
        """Adopt the aligned decode's columns (`native.records.
        decode_record_columns` at ``align=4``) with no copy: the value flat
        already is the 4-aligned upload form, so the buffer is flat-backed
        and the padded matrix is built only if a consumer asks
        (`dense_values`)."""
        n = cols["count"]
        rows = _next_pow2(max(n, 1), MIN_ROWS)
        val_len = cols["val_len"]
        max_v = int(val_len.max()) if n else 0
        width = bucket_width(max_v)
        if width > MAX_RECORD_WIDTH:
            raise ValueError(f"record value of {max_v} bytes exceeds {MAX_RECORD_WIDTH}")
        _check_matrix_addressing(rows, width)
        if n and int(cols["val_off"][-1]) > FLAT_ADDRESS_MAX:
            raise FlatAddressingError(
                f"decoded flat of {int(cols['val_off'][-1])} bytes exceeds int32 addressing "
                f"({FLAT_ADDRESS_MAX}); split the batch before staging"
            )
        lengths = np.zeros(rows, dtype=np.int32)
        lengths[:n] = val_len
        starts = np.zeros(rows, dtype=np.int32)
        starts[:n] = cols["val_off"][:-1]
        # padding rows "start" at the end of the flat with length 0
        starts[n:] = int(cols["val_off"][-1]) if n else 0
        keys, key_lengths, offset_deltas, timestamp_deltas = cls._stage_meta_columns(cols, rows, n)
        return cls(
            values=None,
            lengths=lengths,
            keys=keys,
            key_lengths=key_lengths,
            offset_deltas=offset_deltas,
            timestamp_deltas=timestamp_deltas,
            count=n,
            base_offset=base_offset,
            base_timestamp=base_timestamp,
            _flat=np.asarray(cols["val_flat"], dtype=np.uint8),
            _starts=starts,
            _width=width,
            _rows=rows,
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

    def to_columns(self) -> dict:
        """The live rows as exact-packed columns, the input of
        `native.records.encode_record_columns`. A flat-backed buffer
        converts with one range select over its flat (no padded
        matrix)."""
        n = self.count
        lengths = self.lengths[:n].astype(np.int64)
        val_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=val_off[1:])
        if self.values is None:
            val_flat = self._flat_unaligned(lengths, val_off)
        else:
            mask = np.arange(self.values.shape[1], dtype=np.int32)[None, :] < lengths[:, None]
            val_flat = self.values[:n][mask]
        key_present = (self.key_lengths[:n] >= 0).astype(np.uint8)
        klens = np.maximum(self.key_lengths[:n], 0).astype(np.int64)
        key_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(klens, out=key_off[1:])
        kmask = np.arange(self.keys.shape[1], dtype=np.int32)[None, :] < klens[:, None]
        return {
            "count": n,
            "val_flat": val_flat,
            "val_off": val_off,
            "key_flat": self.keys[:n][kmask],
            "key_off": key_off,
            "key_present": key_present,
            "off_delta": self.offset_deltas[:n].astype(np.int64),
            "ts_delta": self.timestamp_deltas[:n].astype(np.int64),
        }

    def _flat_unaligned(self, lengths: np.ndarray, val_off: np.ndarray) -> np.ndarray:
        """The live bytes exact-packed out of the 4-aligned flat: the
        ranges [start, start + length) ascend and are disjoint (the starts
        are a cumsum of aligned lengths), so one range select takes
        them."""
        total = int(val_off[-1])
        if not len(lengths) or not total:
            return np.zeros(0, dtype=np.uint8)
        return ragged_range_select(self._flat, self._starts[: len(lengths)].astype(np.int64),
                                   lengths)

    def to_records(self) -> List[Record]:
        """Each live row as a `Record` (value, key, offset and timestamp
        deltas)."""
        return [
            Record(value=v, key=k, offset_delta=int(od), timestamp_delta=int(td))
            for v, k, od, td in zip(self.value_list(), self.key_list(),
                                    self.offset_deltas[: self.count],
                                    self.timestamp_deltas[: self.count])
        ]
