"""Adaptive shape-bucket batcher: continuous batching into warmed buckets.

The port's copy of ``fluvio_tpu/admission/batcher.py``. Ragged arrival is
what makes production traffic expensive on the card: a lone 40-record
slice pays the same dispatch round trip (uploads, a few hundred torch
launches, the result copies) as a full one, and a slice whose width lands
in a bucket no warm-up touched pays the first dispatch's costs (the
caching allocator's growth for that shape) mid-serve. The batcher closes
both holes:

- admitted slices accumulate per (chain, width-bucket) and dispatch only
  at **bucket-full** (the row target) or a **deadline** — never a
  half-full dispatch while traffic can still fill it;
- the merged batch's value matrix pads to a **warmed** width bucket when
  one covers it (the warm-up registered the buckets it warmed), so
  coalescing cannot mint a fresh shape; a merge that has no warmed cover
  still dispatches (traffic beats latency) but counts ``cold-bucket`` on
  the admission family so the gap is visible, never silent.

Coalescing is cross-tenant: slices from different streams of the same
chain merge into ONE dispatch. Each source slice's rows get a disjoint
offset-delta base, and `split_output` routes the (row-preserving,
stateless) chain's survivors back to their source slices by that base —
exact, because filters/maps preserve survivor offset deltas. Stateful or
fan-out chains must not coalesce across tenants (carries/capacities are
per-dispatch); `AdmissionPipeline` routes those straight through.

The merged buffer is flat-backed (`RecordBuffer` with ``values`` None):
the sources' 4-aligned ragged bytes are concatenated as they are, which
is the form the executor uploads, so no padded matrix is built on the
host.

Locking: the batcher's lock guards only the pending map; the dispatch
callback always runs OUTSIDE it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fluvio_tpu_torch.admission.types import current_config
from fluvio_tpu_torch.smartengine.gpu.buffer import (
    FLAT_ADDRESS_MAX,
    FlatAddressingError,
    RecordBuffer,
    _check_matrix_addressing,
    bucket_width,
    ragged_range_select,
)
from fluvio_tpu_torch.telemetry import TELEMETRY

# disjoint offset-delta stride per merged slice: survivor deltas stay
# int32 and chains never shift them, so a power-of-two stride makes the
# route-back a shift compare
SLICE_STRIDE = 1 << 20
# int32 bound on the stride scheme: base = i * SLICE_STRIDE must fit —
# the batcher flushes at this item count even before the row target,
# and coalesce_buffers refuses (loudly) rather than wrap
MAX_COALESCE = (2**31 - 1) // SLICE_STRIDE  # 2047 source slices


@dataclass
class _Bucket:
    items: List = field(default_factory=list)
    rows: int = 0
    opened_at: float = 0.0


@dataclass
class Flush:
    """One dispatched coalesce: the merged buffer + the source items
    and their offset-delta bases (for `split_output`)."""

    chain: str
    width_bucket: int
    items: List
    bases: List[int]
    buffer: object  # RecordBuffer
    cause: str  # "batch-full" | "batch-deadline" | "shutdown" | "solo"
    result: object = None  # dispatch return value, if the callback returns
    compiles: int = 0  # build events attributed to this dispatch


def _aligned_live_flat(buf: RecordBuffer, count: int) -> np.ndarray:
    """The first ``count`` rows' 4-aligned ragged bytes, in row order (the
    executor's upload form, padding bytes zero)."""
    flat, starts = buf.ragged_values()
    lengths4 = (buf.lengths[:count].astype(np.int64) + 3) & ~3
    if not count or not int(lengths4.sum()):
        return np.zeros(0, dtype=np.uint8)
    return ragged_range_select(flat, starts[:count].astype(np.int64), lengths4)


def coalesce_buffers(bufs: Sequence, target_width: Optional[int] = None):
    """Merge RecordBuffers into ONE buffer with disjoint offset-delta
    bases per source. Returns (merged, bases). ``target_width`` pads the
    value matrix wider (a warmed bucket); rows bucket pow2 like every
    other staging path."""
    if len(bufs) > MAX_COALESCE:
        raise ValueError(
            f"{len(bufs)} source slices exceed the int32 offset-stride "
            f"bound ({MAX_COALESCE}) — coalesce in smaller flushes"
        )
    width = max(int(b.width) for b in bufs)
    if target_width is not None:
        width = max(width, int(target_width))
    width = bucket_width(width)
    kwidth = max(int(b.keys.shape[1]) for b in bufs)
    n = sum(int(b.count) for b in bufs)
    rows = 8
    while rows < max(n, 1):
        rows <<= 1
    _check_matrix_addressing(rows, width)
    lengths = np.zeros(rows, dtype=np.int32)
    keys = np.zeros((rows, kwidth), dtype=np.uint8)
    key_lengths = np.full(rows, -1, dtype=np.int32)
    offset_deltas = np.zeros(rows, dtype=np.int32)
    timestamp_deltas = np.zeros(rows, dtype=np.int64)
    flats: List[np.ndarray] = []
    bases: List[int] = []
    pos = 0
    for i, b in enumerate(bufs):
        c = int(b.count)
        base = i * SLICE_STRIDE
        bases.append(base)
        # for SHARED merges, delta < SLICE_STRIDE keeps base + delta <
        # MAX_COALESCE * SLICE_STRIDE <= i32 max AND keeps split_output's
        # bracket-by-base route-back exact — a slice whose deltas reach
        # the stride must dispatch solo, never wrap. A single-source merge
        # has base 0 and no banding, so any i32 delta is fine (the
        # batcher's solo path relies on this).
        if len(bufs) > 1 and c and int(b.offset_deltas[:c].max()) >= SLICE_STRIDE:
            raise ValueError(
                f"source slice offset delta "
                f"{int(b.offset_deltas[:c].max())} reaches the "
                f"coalesce stride ({SLICE_STRIDE}) — the disjoint-base "
                "route-back would alias; dispatch this slice solo"
            )
        flats.append(_aligned_live_flat(b, c))
        lengths[pos : pos + c] = b.lengths[:c]
        keys[pos : pos + c, : b.keys.shape[1]] = b.keys[:c]
        key_lengths[pos : pos + c] = b.key_lengths[:c]
        # guards above: base <= (MAX_COALESCE-1)*SLICE_STRIDE and every
        # delta < SLICE_STRIDE, so the sum stays inside i32
        offset_deltas[pos : pos + c] = b.offset_deltas[:c] + base
        timestamp_deltas[pos : pos + c] = b.timestamp_deltas[:c]
        pos += c
    flat = np.concatenate(flats) if flats else np.zeros(0, dtype=np.uint8)
    if len(flat) > FLAT_ADDRESS_MAX:
        raise FlatAddressingError(
            f"coalesced flat of {len(flat)} bytes exceeds int32 addressing "
            f"({FLAT_ADDRESS_MAX}); coalesce in smaller flushes"
        )
    starts = np.full(rows, len(flat), dtype=np.int64)  # padding rows: the end, length 0
    lengths4 = (lengths[:n].astype(np.int64) + 3) & ~3
    starts[:n] = np.cumsum(lengths4) - lengths4
    merged = RecordBuffer(
        values=None, lengths=lengths, keys=keys, key_lengths=key_lengths,
        offset_deltas=offset_deltas, timestamp_deltas=timestamp_deltas, count=n,
        _flat=flat, _starts=starts.astype(np.int32), _width=width, _rows=rows,
    )
    return merged, bases


def split_output(outbuf, bases: Sequence[int]) -> List[List[Tuple[bytes, int]]]:
    """Route a coalesced dispatch's survivors back to their source
    slices: survivor i belongs to the slice whose offset-delta base
    brackets it (row-preserving chains keep survivor deltas). Returns,
    per source slice, ``[(value bytes, original offset delta), ...]``
    in record order."""
    records = outbuf.to_records()
    if len(bases) == 1:
        # single-source (solo) flush: no base banding — every survivor
        # belongs to the one slice, whatever its deltas (a big-delta
        # slice must not lose records to the stride bracket)
        return [[(rec.value, int(rec.offset_delta) - bases[0]) for rec in records]]
    out: List[List[Tuple[bytes, int]]] = [[] for _ in bases]
    for rec in records:
        slot = int(rec.offset_delta) // SLICE_STRIDE
        if 0 <= slot < len(bases):
            out[slot].append((rec.value, int(rec.offset_delta) - bases[slot]))
    return out


class ShapeBucketBatcher:
    """Coalesce admitted slices into warmed shape buckets and dispatch
    at bucket-full or deadline."""

    def __init__(
        self,
        dispatch: Callable,  # dispatch(Flush) -> result (outside all locks)
        row_target: Optional[int] = None,
        deadline_s: Optional[float] = None,
        clock=time.monotonic,
    ) -> None:
        cfg = current_config()
        self.dispatch = dispatch
        self.row_target = row_target if row_target is not None else int(cfg.batch_rows)
        self.deadline_s = (
            deadline_s if deadline_s is not None else cfg.batch_deadline_ms / 1000.0
        )
        self.clock = clock
        self._lock = threading.Lock()
        self._pending: Dict[Tuple[str, int], _Bucket] = {}
        # warmed width buckets per chain (the warm-up registers them;
        # coalesces pad up to the smallest covering warmed bucket)
        self._warmed: Dict[str, set] = {}

    # -- warm-up registration ------------------------------------------------

    def note_warm(self, chain: str, width_buckets) -> None:
        with self._lock:
            self._warmed.setdefault(chain, set()).update(width_buckets)

    def warmed_cover(self, chain: str, width: int) -> Optional[int]:
        """Smallest warmed width bucket >= ``width`` for this chain."""
        with self._lock:
            covers = [w for w in self._warmed.get(chain, ()) if w >= width]
        return min(covers) if covers else None

    # -- accumulation --------------------------------------------------------

    def add(self, chain: str, buf) -> List[Flush]:
        """Accumulate one admitted slice; returns the flushes this add
        triggered (bucket-full only — deadlines flush via `poll`). A
        slice whose offset deltas reach the coalesce stride cannot share
        a dispatch (the disjoint-base route-back would alias — and
        overflow i32 at the 2047-slice bound), so it dispatches SOLO here
        instead of poisoning a shared bucket and losing its co-batched
        slices to the `coalesce_buffers` backstop raise."""
        flw = getattr(buf, "_flow", None)
        if flw is not None:
            flw.note_batcher()  # residence clock: add -> flush
        key = (chain, bucket_width(max(int(buf.width), 1)))
        c = int(buf.count)
        if c and int(buf.offset_deltas[:c].max()) >= SLICE_STRIDE:
            # the same warmed-cover padding / cold-bucket accounting /
            # cause counting as every other flush — just never shared
            return [self._flush(key, _Bucket(items=[buf], rows=c), "solo")]
        now = self.clock()
        ready: List[Tuple[Tuple[str, int], _Bucket]] = []
        with self._lock:
            bucket = self._pending.get(key)
            if bucket is None:
                bucket = self._pending.setdefault(key, _Bucket(opened_at=now))
            bucket.items.append(buf)
            bucket.rows += int(buf.count)
            if bucket.rows >= self.row_target or len(bucket.items) >= MAX_COALESCE:
                ready.append((key, self._pending.pop(key)))
        return [self._flush(k, b, "batch-full") for k, b in ready]

    def poll(self, now: Optional[float] = None) -> List[Flush]:
        """Flush every bucket whose deadline has passed — the 'traffic
        cannot fill it in time' half of the contract."""
        now = self.clock() if now is None else now
        ready = []
        with self._lock:
            for k in list(self._pending):
                if now - self._pending[k].opened_at >= self.deadline_s:
                    ready.append((k, self._pending.pop(k)))
        return [self._flush(k, b, "batch-deadline") for k, b in ready]

    def flush_all(self, cause: str = "shutdown") -> List[Flush]:
        """Drain every pending bucket (clean shutdown: nothing is held
        back, nothing dispatches twice)."""
        with self._lock:
            ready = [(k, self._pending.pop(k)) for k in list(self._pending)]
        return [self._flush(k, b, cause) for k, b in ready]

    def depth(self) -> int:
        with self._lock:
            return sum(b.rows for b in self._pending.values())

    # -- dispatch (never under the lock) -------------------------------------

    def _warm_state(self, chain: str, width: int):
        with self._lock:
            buckets = self._warmed.get(chain)
            covers = [w for w in buckets if w >= width] if buckets else []
            return (min(covers) if covers else None, bool(buckets))

    def _flush(self, key: Tuple[str, int], bucket: _Bucket, cause: str) -> Flush:
        chain, width_bucket = key
        cover, chain_warmed = self._warm_state(chain, width_bucket)
        if cover is None and chain_warmed:
            # a warmed chain dispatching outside its warmed set is the
            # first-dispatch hole the warm-up exists to close — count it
            TELEMETRY.add_admission("cold-bucket")
        merged, bases = coalesce_buffers(bucket.items, target_width=cover)
        TELEMETRY.add_admission(cause)
        # per-slice causality: every co-batched slice's flow records the
        # batcher residence it paid, the flush cause, and how many tenant
        # slices rode the same coalesced dispatch
        flows = [f for f in (getattr(b, "_flow", None) for b in bucket.items) if f is not None]
        for f in flows:
            f.end_batcher(cause, len(bucket.items))
            f.mark_dispatch()
        flush = Flush(
            chain=chain,
            width_bucket=merged.width,
            items=bucket.items,
            bases=bases,
            buffer=merged,
            cause=cause,
        )
        flush.result = self.dispatch(flush)
        for b in bucket.items:
            f = getattr(b, "_flow", None)
            if f is not None:
                TELEMETRY.end_flow(f, records=int(getattr(b, "count", 0) or 0))
        return flush
