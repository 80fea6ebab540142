"""Sparse offset index (the port's copy of ``fluvio_tpu/storage/index.py``;
parity: fluvio-storage/src/{index.rs,mut_index.rs}).

``<base_offset>.index``: a memory-mapped array of ``(offset_delta u32,
file_position_plus_one u32)`` pairs, appended every
``index_max_interval_bytes`` of log data. Positions are stored +1 so a
valid entry is never all-zero — a zero pair terminates the entry list,
which makes reload scanning unambiguous (entry 0 indexes log position 0).
Entries must be strictly increasing in offset_delta; the reload scan stops
at the first violation, so stale bytes beyond a crash can never resurface.
Lookup finds the greatest indexed offset <= target so log scans start near
the right position (O(1) amortized reads).
"""

from __future__ import annotations

import mmap
import os
import struct

_PAIR = struct.Struct("<II")


class OffsetIndex:
    def __init__(self, path: str, max_bytes: int):
        self.path = path
        self.max_bytes = max_bytes - (max_bytes % _PAIR.size)
        exists = os.path.exists(path)
        self._file = open(path, "r+b" if exists else "w+b")
        if not exists or os.path.getsize(path) < self.max_bytes:
            self._file.truncate(self.max_bytes)
        self._mmap = mmap.mmap(self._file.fileno(), self.max_bytes)
        self._entries = self._scan_entries()
        self._bytes_since_entry = 0

    def _scan_entries(self) -> int:
        """Count valid entries: stop at the zero terminator or at the first
        non-monotonic offset_delta (stale bytes from before a crash)."""
        count = 0
        prev_delta = -1
        for i in range(0, self.max_bytes, _PAIR.size):
            delta, pos_p1 = _PAIR.unpack_from(self._mmap, i)
            if pos_p1 == 0:
                break
            if delta <= prev_delta:
                break
            prev_delta = delta
            count += 1
        return count

    def __len__(self) -> int:
        return self._entries

    def _last_delta(self) -> int:
        if self._entries == 0:
            return -1
        delta, _ = _PAIR.unpack_from(self._mmap, (self._entries - 1) * _PAIR.size)
        return delta

    def try_add(self, offset_delta: int, position: int, batch_bytes: int, interval: int) -> None:
        """Record an entry if enough log bytes have passed since the last."""
        self._bytes_since_entry += batch_bytes
        if self._bytes_since_entry < interval and self._entries > 0:
            return
        if (self._entries + 1) * _PAIR.size > self.max_bytes:
            return  # index full; scans fall back to the last entry
        if offset_delta <= self._last_delta():
            return  # keep the monotonic invariant
        _PAIR.pack_into(
            self._mmap, self._entries * _PAIR.size, offset_delta, position + 1
        )
        self._entries += 1
        self._bytes_since_entry = 0

    def lookup(self, offset_delta: int) -> int:
        """File position of the greatest indexed entry <= offset_delta."""
        lo, hi = 0, self._entries
        best = 0
        while lo < hi:
            mid = (lo + hi) // 2
            delta, pos_p1 = _PAIR.unpack_from(self._mmap, mid * _PAIR.size)
            if delta <= offset_delta:
                best = pos_p1 - 1
                lo = mid + 1
            else:
                hi = mid
        return best

    def flush(self) -> None:
        self._mmap.flush()

    def truncate_to_position(self, max_position: int) -> None:
        """Drop entries pointing at or beyond a truncated log position."""
        kept = 0
        for i in range(self._entries):
            _, pos_p1 = _PAIR.unpack_from(self._mmap, i * _PAIR.size)
            if pos_p1 - 1 < max_position:
                kept = i + 1
            else:
                break
        for i in range(kept, self._entries):
            _PAIR.pack_into(self._mmap, i * _PAIR.size, 0, 0)
        self._entries = kept

    def close(self) -> None:
        self._mmap.flush()
        self._mmap.close()
        self._file.close()
