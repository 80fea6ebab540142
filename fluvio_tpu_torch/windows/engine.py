"""The windowed-state runtime: device-resident carry, delta-only download.

The port's counterpart of ``fluvio_tpu/windows/engine.py``.
`WindowedRuntime` drives one stream through the window update: the bank
(state.py) stays on the device between batches, and per batch only the
record columns cross up and the scalar header plus the bucketed emit
slice (closed windows and the (key, window) entries the batch touched)
cross down, two downloads and the batch's only two synchronisations. A
full-state image ships only on consumer attach, replica seed/migration
and the emit-capacity overflow resync, and an overflow resync still
carries the batch's closed rows (their final aggregates were evicted
from the bank), never dropping closes.

The bank commits only after the header passed its checks, so a batch
that raises `WindowCapacityError` leaves the carry exactly as it was
(and counts a ``window-capacity`` decline).

Fault seams (`fluvio_tpu_torch.resilience.faults`, the reference's):
``stage`` (the host columns), ``dispatch`` (the update's torch calls),
``device`` (before the header's download) and ``fetch`` (after it). The
bank commits only after the fetch, so `process_buffer` retries a transient
`InjectedFault` once against the untouched bank (counted on the
``retries`` family at its point); a second fault, or a deterministic one,
raises.

Telemetry (the reference's seams): each batch is a span on the
``windowed`` path, chain label the window mode, with phases ``stage``
(the host columns), ``h2d`` (their uploads), ``dispatch`` (the update's
torch calls), ``device`` (to the header's download, the batch's first
synchronisation) and ``d2h`` (the emit slice's download, booked under the
``emit_buffer`` ledger owner while it is in flight); windows closed,
delta rows by kind, the delta-vs-full downlink bytes and one
``down-packed`` link form a batch count on the registry's families, and
the bank's live bytes on the ``window_bank`` owner (`state.py`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.resilience import faults
from fluvio_tpu_torch.smartengine.engine import resolve_device
from fluvio_tpu_torch.telemetry import TELEMETRY
from fluvio_tpu_torch.windows.kernels import WindowEagerOps
from fluvio_tpu_torch.windows.spec import DEFAULT_DELTA_ONLY, WindowCapacityError, WindowSpec
from fluvio_tpu_torch.windows.state import ENTRY_BYTES, WindowStateBank

# fixed per-delta framing cost (header scalars + column descriptors);
# the reference's packed-fetch 64-byte framing constant
DELTA_FRAME_BYTES = 64
# the reference's accounting of one shipped emit row: 3 i64 columns + 1
# i32 verdict column
EMIT_ROW_BYTES = 28


@dataclass
class WindowDelta:
    """One batch's downlink payload (already on host)."""

    kind: str  # "rows" (delta columns) | "resync" (full bank image)
    ids: np.ndarray
    accs: np.ndarray
    counts: np.ndarray
    closed: np.ndarray  # 1 = this row is a window close (rows kind)
    watermark: int
    n_open: int
    n_closed: int
    n_late: int
    delta_bytes: int
    full_bytes: int
    records: int
    # rows whose key fell outside the composite-id packing range
    # [0, KEY_STRIDE): dropped (never folded), counted for observability
    n_invalid: int = 0
    # filled by PartitionedWindowRuntime so replayed deltas can be deduped
    partition: Optional[Tuple[str, int]] = None
    offset: int = -1

    def row_count(self) -> int:
        return int(self.ids.shape[0])


def _full_state_bytes(records: int) -> int:
    """What the classic per-record emission ships for the same batch: one
    i64 result + i64 window id per record, a validity bitmap, and the
    packed-fetch framing; the denominator of the delta-vs-full ratio."""
    return 16 * records + math.ceil(records / 8) + DELTA_FRAME_BYTES


def _fetch_bucket(rows: int, cap: int) -> int:
    """Rows a bucketed emit fetch ships: the power of two (at least 8)
    that covers ``rows``, at most ``cap``. The reference quantizes its
    slice lengths so XLA compiles each slice once; the port keeps the
    buckets so that ``delta_bytes`` counts what the reference ships."""
    fetch = 8
    while fetch < rows:
        fetch *= 2
    return min(fetch, cap)


def _download(*columns: torch.Tensor) -> np.ndarray:
    """Stack equal-length columns as int64 and download them in one copy:
    [len(columns), n] on the host."""
    return torch.stack([c.to(torch.int64) for c in columns]).cpu().numpy()


class WindowedRuntime:
    """One stream's windowed-state engine (single-device path) on
    ``device``: the CUDA card unless the caller passes another."""

    def __init__(self, spec: WindowSpec, device=None, ops: Optional[WindowEagerOps] = None):
        self.spec = spec
        self.ops = ops if ops is not None else WindowEagerOps(spec)
        self.bank = WindowStateBank(spec, device=resolve_device(device))
        TELEMETRY.note_device(self.bank.device)
        self.batches = 0
        self.d2h_bytes_total = 0
        self.h2d_bytes_total = 0

    @classmethod
    def from_params(cls, kind: str, window_ms, slide_ms=0, keyed=False,
                    delta_only: bool = DEFAULT_DELTA_ONLY, device=None):
        return cls(
            WindowSpec.from_params(kind, window_ms, slide_ms, keyed, delta_only),
            device=device,
        )

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        self.h2d_bytes_total += array.nbytes
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.bank.device)

    # -- ingest --------------------------------------------------------------

    def process_buffer(self, buf) -> WindowDelta:
        """Fold one RecordBuffer; returns the batch's delta. Uploads the
        padded values, the lengths, the absolute event times and the
        validity column. A transient injected fault retries once against
        the identical carry (the bank is untouched until the fetch)."""
        try:
            return self._process_once(buf)
        except faults.InjectedFault as exc:
            if not exc.transient:
                raise
            TELEMETRY.add_retry(exc.point)
            t = time.perf_counter()
            out = self._process_once(buf)
            TELEMETRY.add_retry_time(exc.point, time.perf_counter() - t)
            return out

    def _process_once(self, buf) -> WindowDelta:
        span = TELEMETRY.begin_batch("windowed", chain=self.spec.mode)
        t = time.perf_counter() if span is not None else 0.0
        faults.maybe_fire("stage")
        values = buf.dense_values()
        n = values.shape[0]
        count = int(buf.count)
        # base_timestamp -1 is the buffer's "unset" sentinel
        base = max(int(buf.base_timestamp), 0)
        ts = np.asarray(buf.timestamp_deltas, dtype=np.int64) + base
        valid = np.arange(n, dtype=np.int64) < count
        lengths = np.asarray(buf.lengths, dtype=np.int32)
        if span is not None:
            t = span.lap("stage", t)
        args = tuple(self._upload(a) for a in (values, lengths, ts, valid))
        if span is not None:
            span.lap("h2d", t)
        return self._run(self.ops.update_values, args, count, span)

    def ingest_arrays(self, contribs, keys, ts, count: Optional[int] = None) -> WindowDelta:
        """Pre-parsed seam for the striped/sharded split-backs (and tests):
        contribs/keys/ts int64 rows, on the host or the bank's device."""
        cols = []
        for a in (contribs, keys, ts):
            if isinstance(a, torch.Tensor) and a.device == self.bank.device:
                cols.append(a.to(torch.int64))
            else:
                cols.append(self._upload(np.asarray(a, dtype=np.int64)))
        n = int(cols[0].shape[0])
        count = n if count is None else int(count)
        valid = torch.arange(n, dtype=torch.int64, device=self.bank.device) < count
        span = TELEMETRY.begin_batch("windowed", chain=self.spec.mode)
        return self._run(self.ops.update_arrays, (*cols, valid), count, span)

    def _run(self, update, batch_args, count: int, span=None) -> WindowDelta:
        t = time.perf_counter() if span is not None else 0.0
        faults.maybe_fire("dispatch")
        (header, nb_ids, nb_accs, nb_cnts,
         em_ids, em_accs, em_cnts, em_closed) = update(*self.bank.arrays(), *batch_args)
        if span is not None:
            span.lap("dispatch", t)
            span.mark_dispatched()
        faults.maybe_fire("device")
        # first blocking sync: the scalar header (8 i64 = 64 bytes)
        (n_emit, n_open, n_closed, n_late, new_wm, bank_ovf, emit_ovf,
         n_invalid) = header.cpu().tolist()
        if span is not None:
            span.mark_device_ready()
        faults.maybe_fire("fetch")
        if bank_ovf:
            # the merged open set no longer fits the device bank: loud
            # failure BEFORE committing, so the carry stays valid
            TELEMETRY.add_decline("window-capacity")
            raise WindowCapacityError(
                f"{n_open} open windows exceed bank capacity {self.spec.capacity}"
            )
        emit_cols = int(em_ids.shape[0])
        resync = emit_ovf or not self.spec.delta_only
        if resync and n_closed > emit_cols:
            # the batch closed more windows than the emit columns hold:
            # their final aggregates exist ONLY there (a close evicts the
            # entry from the bank), so they cannot be delivered
            TELEMETRY.add_decline("window-capacity")
            raise WindowCapacityError(
                f"{n_closed} windows closed in one batch exceed emit capacity {emit_cols}"
            )
        self.bank.commit(nb_ids, nb_accs, nb_cnts, header[4], n_open, new_wm)
        if resync:
            # more changed rows than the emit columns hold, or full-state
            # emission: ship the batch's CLOSED rows (the compacted emit
            # prefix: closes compact first) plus ONE full open-state image
            t = time.perf_counter() if span is not None else 0.0
            if n_closed:
                fetch_rows = _fetch_bucket(n_closed, emit_cols)
                cl_ids, cl_accs, cl_cnts = self._fetch_emit(
                    fetch_rows * ENTRY_BYTES,
                    em_ids[:fetch_rows], em_accs[:fetch_rows], em_cnts[:fetch_rows],
                )[:, :n_closed]
                closed_bytes = fetch_rows * ENTRY_BYTES
            else:
                cl_ids = cl_accs = cl_cnts = np.zeros((0,), dtype=np.int64)
                closed_bytes = 0
            rows = self.bank.full_rows()
            if span is not None:
                span.lap("d2h", t)
            ids = np.concatenate([cl_ids, rows[:, 0]])
            accs = np.concatenate([cl_accs, rows[:, 1]])
            cnts = np.concatenate([cl_cnts, rows[:, 2]])
            closed = np.zeros((ids.shape[0],), dtype=np.int32)
            closed[:n_closed] = 1
            kind = "resync"
            delta_bytes = closed_bytes + rows.shape[0] * ENTRY_BYTES + DELTA_FRAME_BYTES
        else:
            # second sync: the bucketed emit slice, one download
            t = time.perf_counter() if span is not None else 0.0
            fetch_rows = _fetch_bucket(n_emit, self.spec.emit_capacity)
            ids, accs, cnts, closed = self._fetch_emit(
                fetch_rows * EMIT_ROW_BYTES,
                em_ids[:fetch_rows], em_accs[:fetch_rows],
                em_cnts[:fetch_rows], em_closed[:fetch_rows],
            )[:, :n_emit]
            if span is not None:
                span.lap("d2h", t)
            kind = "rows"
            delta_bytes = fetch_rows * EMIT_ROW_BYTES + DELTA_FRAME_BYTES
        self.batches += 1
        self.d2h_bytes_total += delta_bytes
        # counters always on (exactness evidence); the span only with capture
        TELEMETRY.add_windows_closed(n_closed)
        if n_closed:
            TELEMETRY.add_window_delta("close", n_closed)
        if kind == "rows":
            upserts = int(ids.shape[0]) - n_closed
            if upserts:
                TELEMETRY.add_window_delta("upsert", upserts)
        else:
            # closes riding the resync are already counted under "close"
            TELEMETRY.add_window_delta("resync", int(ids.shape[0]) - n_closed)
        if n_late:
            TELEMETRY.add_window_delta("late", n_late)
        if n_invalid:
            TELEMETRY.add_window_delta("invalid", n_invalid)
        TELEMETRY.add_window_downlink(delta_bytes, _full_state_bytes(count))
        TELEMETRY.add_link_variant("down-packed")
        TELEMETRY.end_batch(span, records=count)
        return WindowDelta(
            kind=kind,
            ids=np.asarray(ids, dtype=np.int64),
            accs=np.asarray(accs, dtype=np.int64),
            counts=np.asarray(cnts, dtype=np.int64),
            closed=np.asarray(closed, dtype=np.int32),
            watermark=new_wm,
            n_open=n_open,
            n_closed=n_closed,
            n_late=n_late,
            delta_bytes=delta_bytes,
            full_bytes=_full_state_bytes(count),
            records=count,
            n_invalid=n_invalid,
        )

    def _fetch_emit(self, nbytes: int, *columns: torch.Tensor) -> np.ndarray:
        """Download emit-slice columns (`_download`), their device rows
        booked under the ledger's ``emit_buffer`` owner until the copy
        lands."""
        TELEMETRY.mem_acquire("emit_buffer", ("emit", id(self)), nbytes)
        try:
            return _download(*columns)
        finally:
            TELEMETRY.mem_release(("emit", id(self)))

    # -- attach / resync -----------------------------------------------------

    def resync_rows(self) -> Tuple[np.ndarray, int]:
        """Full-state image for a consumer attach: (rows, watermark) for
        `MaterializedView.resync`."""
        return self.bank.full_rows(), self.bank.watermark


def _fold_open(mirror: Dict[int, Tuple[int, int]], delta: WindowDelta) -> None:
    """Fold one delta into a host open-table mirror (the open side of
    `MaterializedView.apply_delta`): upserts overwrite, closes evict, a
    resync replaces the table from its open rows. Every open bank entry
    shipped in the batch that last touched it, so the mirror tracks the
    device bank's live entries exactly, and the replica publish rides rows
    the batch already fetched instead of a per-batch bank download."""
    if delta.kind == "resync":
        mirror.clear()
    for i, a, c, cl in zip(delta.ids, delta.accs, delta.counts, delta.closed):
        if cl:
            mirror.pop(int(i), None)
        else:
            mirror[int(i)] = (int(a), int(c))


class PartitionedWindowRuntime:
    """Per-(topic, partition) window banks sharing ONE `WindowEagerOps`,
    with the carry riding a replica: every committed batch publishes the
    bank snapshot and the served-delta offset, so promotion/migration
    restores a bit-equal bank and the serving side can dedupe replayed
    deltas. ``replica`` is any object with ``publish(key, offset,
    carries, inst_state=...)`` and ``latest(key) -> (offset, carries,
    inst_state)``. Banks live on ``device`` (the CUDA card unless the
    caller passes another) until `migrate` moves one."""

    def __init__(self, spec: WindowSpec, replica=None, ops: Optional[WindowEagerOps] = None,
                 device=None):
        self.spec = spec
        self.ops = ops if ops is not None else WindowEagerOps(spec)
        self.replica = replica
        self.device = resolve_device(device)
        self._runtimes: Dict[Tuple[str, int], WindowedRuntime] = {}
        self._offsets: Dict[Tuple[str, int], int] = {}
        # host mirror of each bank's open entries, folded from served
        # deltas: the replica-publish source (no extra download per batch)
        self._mirrors: Dict[Tuple[str, int], Dict[int, Tuple[int, int]]] = {}

    @staticmethod
    def _replica_key(topic: str, partition: int) -> str:
        return f"window/{topic}/{partition}"

    def runtime(self, topic: str, partition: int, device=None) -> WindowedRuntime:
        key = (topic, partition)
        rt = self._runtimes.get(key)
        if rt is None:
            rt = WindowedRuntime(self.spec, device=self.device if device is None else device,
                                 ops=self.ops)
            self._runtimes[key] = rt
        elif device is not None:
            rt.bank.to_device(device)
        return rt

    def process_buffer(self, topic: str, partition: int, buf, device=None) -> WindowDelta:
        rt = self.runtime(topic, partition, device=device)
        delta = rt.process_buffer(buf)
        key = (topic, partition)
        offset = self._offsets.get(key, 0)
        delta.partition = key
        delta.offset = offset
        self._offsets[key] = offset + delta.records
        if self.replica is not None:
            # the mirror IS the bank's live entry set (sorted by id, the
            # bank's compaction order), so promotion seeds bit-equal
            mirror = self._mirrors.setdefault(key, {})
            _fold_open(mirror, delta)
            self.replica.publish(
                self._replica_key(topic, partition),
                self._offsets[key],
                [(i,) + mirror[i] for i in sorted(mirror)],
                inst_state=[("wm", delta.watermark)],
            )
        return delta

    # -- failover / migration ------------------------------------------------

    def seed(self, topic: str, partition: int, device=None) -> int:
        """Promotion seed: restore the bank from the replica's last
        committed snapshot; returns the committed offset replay should
        resume from (the exactly-once rewind point)."""
        if self.replica is None:
            raise RuntimeError("no replica bound for window seed")
        offset, carries, inst_state = self.replica.latest(self._replica_key(topic, partition))
        wm = dict(inst_state or ()).get("wm", None)
        if wm is None:
            raise RuntimeError(f"window replica for {topic}/{partition} has no watermark")
        rt = self.runtime(topic, partition, device=device)
        rt.bank.restore(list(carries or ()), int(wm))
        self._offsets[(topic, partition)] = int(offset)
        self._mirrors[(topic, partition)] = {
            int(i): (int(a), int(c)) for i, a, c in (carries or ())
        }
        return int(offset)

    def migrate(self, topic: str, partition: int, device) -> None:
        """Mid-window partition move: re-place the live carry on
        ``device``. The replica snapshot published at the last commit is
        the rollback point."""
        rt = self._runtimes.get((topic, partition))
        if rt is not None:
            rt.bank.to_device(device)

    def snapshot(self, topic: str, partition: int):
        rt = self._runtimes.get((topic, partition))
        if rt is None:
            return [], None
        return rt.bank.snapshot()

    def state_bytes(self) -> int:
        return sum(rt.bank.state_bytes() for rt in self._runtimes.values())
