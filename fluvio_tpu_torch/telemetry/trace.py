"""Flight recorder: Chrome-trace / Perfetto export of the span ring.

The port's copy of ``fluvio_tpu/telemetry/trace.py``. Its continuous sink
is armed by ``TelemetryConfig.trace_path`` through ``telemetry.configure``,
never at import: the port reads no environment variable.

Renders the telemetry subsystem's per-batch `BatchSpan`s and instant
events (heals, spills, retries, breaker transitions, compiles,
quarantines) as Chrome trace JSON — the format ui.perfetto.dev and
chrome://tracing load directly. Each batch becomes a duration envelope
with its pipeline phases as nested duration events, placed at their
REAL wall positions (spans record per-phase start times), on per-path
tracks with greedy lane assignment: two batches whose spans overlap in
time land on different lanes, so the pipelined loop's overlap (batch
k's ``device`` span running under batch k+1's ``dispatch``) is directly
visible instead of inferable.

Three export surfaces share one renderer:

- **continuous**: ``TelemetryConfig(trace_path=...)`` streams completed spans and
  events into a file sink whose on-disk content is ALWAYS valid JSON
  (events coalesce in memory and every written chunk rewrites the
  closing ``]`` in place) and size-bounded — past
  ``trace_max_mb`` (default 64) the file rotates once to
  ``<path>.1`` and restarts, so a long-running broker cannot fill the
  disk,
- **on-demand**: the monitoring socket's ``trace`` mode line dumps the
  current ring as one complete document,
- **programmatic**: `render_trace()` returns the document as a dict.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Optional

from fluvio_tpu_torch.telemetry.flow import SliceFlow
from fluvio_tpu_torch.telemetry.registry import TELEMETRY, PipelineTelemetry
from fluvio_tpu_torch.telemetry.spans import PHASES, BatchSpan, InstantEvent

DEFAULT_TRACE_MAX_MB = 64.0

_PID = 1
# tid layout: tid 0 is the instant-event track; batch lanes start at
# path_rank * stride + 1 so each path family groups its lanes together;
# per-slice flow lanes are their own "slice" family (rank 3)
_PATH_RANK = {"fused": 0, "striped": 1, "interpreter": 2, "slice": 3}
_LANE_STRIDE = 100


def _us(t: float, base: float) -> float:
    return round((t - base) * 1e6, 3)


class _LaneAllocator:
    """Greedy per-path lane assignment: a span goes on the first lane
    whose previous occupant ended before it began; overlapping spans
    therefore occupy distinct lanes (tracks) in the trace view."""

    def __init__(self) -> None:
        self._ends: Dict[str, List[float]] = {}

    def lane(self, span: BatchSpan) -> int:
        ends = self._ends.setdefault(span.path, [])
        end = span.t_end if span.t_end is not None else span.t0
        for i, e in enumerate(ends):
            if span.t0 >= e:
                ends[i] = end
                return i
        ends.append(end)
        return len(ends) - 1


def _tid(path: str, lane: int) -> int:
    return _PATH_RANK.get(path, 4) * _LANE_STRIDE + lane + 1


def _thread_meta(path: str, lane: int) -> List[dict]:
    tid = _tid(path, lane)
    return [
        {
            "ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
            "args": {"name": f"{path} lane {lane}"},
        },
        {
            "ph": "M", "pid": _PID, "tid": tid, "name": "thread_sort_index",
            "args": {"sort_index": tid},
        },
    ]


def span_trace_events(span: BatchSpan, lane: int, base: float) -> List[dict]:
    """One batch envelope ("X" complete event) plus one duration event
    per recorded phase, on the span's (path, lane) track. Phases sit at
    their recorded wall start; a phase without one (pre-upgrade spans)
    lays out serially after the previous phase."""
    tid = _tid(span.path, lane)
    t_end = span.t_end if span.t_end is not None else span.t0
    out = [
        {
            "name": f"batch[{span.records}]",
            "cat": "batch",
            "ph": "X",
            "pid": _PID,
            "tid": tid,
            "ts": _us(span.t0, base),
            "dur": round(max(t_end - span.t0, 0.0) * 1e6, 3),
            "args": {"path": span.path, "records": span.records},
        }
    ]
    cursor = span.t0
    for i, name in enumerate(PHASES):
        s = span.phase_s[i]
        if s <= 0.0:
            continue
        t0p = span.phase_t0[i] or cursor
        out.append(
            {
                "name": name,
                "cat": "phase",
                "ph": "X",
                "pid": _PID,
                "tid": tid,
                "ts": _us(t0p, base),
                "dur": round(s * 1e6, 3),
            }
        )
        cursor = t0p + s
    return out


def _flow_matches_span(flow: SliceFlow, span: BatchSpan) -> bool:
    """Does this batch span plausibly carry (part of) this slice's
    work? Join rule: base chain signatures agree (a flow keyed
    ``sig@topic/partition`` matches spans labelled ``sig`` or
    ``sig@...``) and the span overlaps the flow's dispatch->serve
    window."""
    if span.t_end is None:
        return False
    lo = flow.dispatch_t if flow.dispatch_t is not None else flow.t0
    hi = flow.t_end if flow.t_end is not None else lo
    if span.t_end < lo or span.t0 > hi:
        return False
    fbase = (flow.chain or "").split("@", 1)[0]
    sbase = (span.chain or "").split("@", 1)[0]
    return not fbase or not sbase or fbase == sbase


def flow_trace_events(
    flow: SliceFlow,
    lane: int,
    base: float,
    span_tracks: Optional[List[tuple]] = None,
) -> List[dict]:
    """One slice envelope on the ``slice`` lane group, its lifecycle
    phases (hold / queue-wait / batcher) at their wall positions, and
    the Chrome-trace flow chain: ``s`` (arrival) on the slice track,
    one ``t`` step per batch span the slice rode (bound to that span's
    track by ts), and ``f`` at serve — so Perfetto draws arrows from
    slice arrival through the coalesced batch to the served response.
    ``span_tracks`` is ``[(BatchSpan, tid)]`` from the span pass; the
    continuous sink passes None (it renders incrementally and leaves
    the batch join to the on-demand renderer)."""
    tid = _tid("slice", lane)
    t_end = flow.t_end if flow.t_end is not None else flow.t0
    args: Dict = {"flow_id": flow.flow_id, "records": flow.records}
    if flow.chain:
        args["chain"] = flow.chain
    if flow.decision:
        args["decision"] = flow.decision
    if flow.holds:
        args["holds"] = flow.holds
    if flow.cause:
        args["cause"] = flow.cause
        args["sources"] = flow.sources
    out = [
        {
            "name": f"slice[{flow.records}]",
            "cat": "slice",
            "ph": "X",
            "pid": _PID,
            "tid": tid,
            "ts": _us(flow.t0, base),
            "dur": round(max(t_end - flow.t0, 0.0) * 1e6, 3),
            "args": args,
        }
    ]
    for name, p_t0, s in flow.phases:
        out.append(
            {
                "name": name,
                "cat": "slice-phase",
                "ph": "X",
                "pid": _PID,
                "tid": tid,
                "ts": _us(p_t0, base),
                "dur": round(s * 1e6, 3),
            }
        )
    head = {"name": "slice-flow", "cat": "flow", "id": flow.flow_id,
            "pid": _PID}
    out.append(dict(head, ph="s", tid=tid, ts=_us(flow.t0, base)))
    for span, stid in span_tracks or ():
        if _flow_matches_span(flow, span):
            out.append(
                dict(
                    head, ph="t", tid=stid,
                    ts=_us(max(span.t0, flow.t0), base),
                )
            )
    out.append(dict(head, ph="f", bp="e", tid=tid, ts=_us(t_end, base)))
    return out


def instant_trace_event(ev: InstantEvent, base: float) -> dict:
    """Heals/spills/retries/breaker/compiles as process-scoped instant
    markers — vertical lines across the batch tracks."""
    out = {
        "name": ev.kind,
        "cat": "event",
        "ph": "i",
        "s": "p",
        "pid": _PID,
        "tid": 0,
        "ts": _us(ev.t, base),
    }
    if ev.detail:
        out["args"] = {"detail": ev.detail}
    return out


def _base_meta() -> List[dict]:
    return [
        {
            "ph": "M", "pid": _PID, "name": "process_name",
            "args": {"name": "fluvio-tpu pipeline"},
        },
        {
            "ph": "M", "pid": _PID, "tid": 0, "name": "thread_name",
            "args": {"name": "events"},
        },
    ]


def build_trace(
    spans: List[BatchSpan],
    events: Optional[List[InstantEvent]] = None,
    flows: Optional[List[SliceFlow]] = None,
) -> dict:
    """Assemble one complete Chrome-trace document from a span list
    (completion order), an instant-event list, and the per-slice flow
    records (rendered as their own ``slice`` lane group, flow-linked to
    the batch spans they rode)."""
    events = events or []
    flows = flows or []
    times = (
        [s.t0 for s in spans]
        + [e.t for e in events]
        + [f.t0 for f in flows]
    )
    base = min(times) if times else 0.0
    out = list(_base_meta())
    alloc = _LaneAllocator()
    seen: set = set()
    span_tracks: List[tuple] = []
    for span in sorted(spans, key=lambda s: s.t0):
        lane = alloc.lane(span)
        if (span.path, lane) not in seen:
            seen.add((span.path, lane))
            out.extend(_thread_meta(span.path, lane))
        span_tracks.append((span, _tid(span.path, lane)))
        out.extend(span_trace_events(span, lane, base))
    for ev in events:
        out.append(instant_trace_event(ev, base))
    for flow in sorted(flows, key=lambda f: f.t0):
        lane = alloc.lane(flow)
        if ("slice", lane) not in seen:
            seen.add(("slice", lane))
            out.extend(_thread_meta("slice", lane))
        out.extend(flow_trace_events(flow, lane, base, span_tracks))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def render_trace(telemetry: Optional[PipelineTelemetry] = None) -> dict:
    """The current flight-recorder contents as one trace document."""
    t = telemetry if telemetry is not None else TELEMETRY
    return build_trace(t.spans.recent(), t.events.recent(), t.flows.recent())


def trace_json(telemetry: Optional[PipelineTelemetry] = None) -> str:
    return json.dumps(render_trace(telemetry))


class TraceFileSink:
    """Continuous bounded trace file: every write leaves the file as
    valid Chrome-trace JSON (a top-level event array — the format
    Perfetto loads directly) by rewriting the closing ``]`` in place.
    Past ``max_bytes`` the file rotates to ``<path>.1`` (one
    generation) and restarts, so total disk use is bounded at ~2x.

    Hot-path cost: events COALESCE in memory and hit the file only
    every ``BATCH_EVENTS`` events (or once ``FLUSH_INTERVAL_S`` has
    passed) — one buffered write per flush, not per batch, so the
    recorder stays inside the telemetry overhead gate even when the
    trace path lives on a slow (network) filesystem. Every written
    chunk ends with the closing bracket, so any on-disk prefix is
    complete valid JSON; a crash loses at most the coalesced tail.

    The file opens LAZILY on the first write: arming a sink touches no
    file until a span or event arrives. A
    pre-existing file is never appended into (its time base belongs to
    another run) and never truncated — the first write rotates it to
    ``<path>.1`` and starts fresh; a writer that still holds the old
    file keeps writing to the renamed inode, so even a second process
    arming the same path cannot corrupt an in-progress recording
    (still: one engine per trace path is the supported shape). A
    failed append rolls the file back to its pre-append closing
    bracket, so a torn chunk can never get buried mid-file by later
    appends."""

    BATCH_EVENTS = 16
    FLUSH_INTERVAL_S = 1.0

    def __init__(self, path: str, max_bytes: int) -> None:
        self.path = path
        self.max_bytes = max(int(max_bytes), 4096)
        # the sink lock IS the file serializer: appends, flushes,
        # and rotation must be mutually exclusive, so holding it
        # across the write is its documented job (io-designated
        # name: the FLV212 work-under-lock rule exempts it)
        self._lock = threading.Lock()
        self._alloc = _LaneAllocator()
        self._seen_tracks: set = set()
        self._base: Optional[float] = None
        self._f = None  # opened lazily by the first write
        self._broken = False
        self._has_events = False
        self._pending: List[dict] = []
        self._last_write = 0.0

    # -- file plumbing -------------------------------------------------------

    def _ensure_open(self) -> bool:
        """Open (or resume) the trace file; returns False when the sink
        is permanently broken. Caller holds the lock."""
        if self._f is not None:
            return True
        if self._broken:
            return False
        try:
            if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
                # a pre-existing file belongs to another run (its ts
                # base is that process's clock — appending would overlay
                # two timelines) or another writer: rotate it aside and
                # start fresh. A writer still holding it follows the
                # renamed inode, so nothing gets truncated or interleaved.
                os.replace(self.path, self.path + ".1")
            self._f = open(self.path, "w+b")
            self._f.write(b"[\n]")
            self._f.flush()
            self._has_events = False
        except OSError:
            self._broken = True
            return False
        self._pending = _base_meta() + self._pending
        return True

    def _append(self, events: List[dict]) -> None:
        """Write events before the closing ``]`` (caller holds the
        lock; file is open). On failure the file rolls back to its
        pre-append closing bracket so it stays valid JSON."""
        f = self._f
        f.seek(-1, os.SEEK_END)
        tail = f.tell()  # offset of the ']' this write overwrites
        chunks = []
        has = self._has_events
        for ev in events:
            chunks.append((b",\n" if has else b"") + json.dumps(ev).encode())
            has = True
        try:
            f.write(b"".join(chunks) + b"\n]")
            f.flush()
        except (OSError, ValueError):
            try:
                f.truncate(tail)
                f.seek(tail)
                f.write(b"]")
                f.flush()
            except (OSError, ValueError):
                # even the 1-byte repair failed: stop recording for good
                self._broken = True
                try:
                    f.close()
                except OSError:  # pragma: no cover
                    pass
                self._f = None
            raise
        self._has_events = has

    def _rotate_if_needed(self) -> None:
        if self._f is None or self._f.tell() <= self.max_bytes:
            return
        self._f.close()
        self._f = None  # next write lazily starts the fresh generation
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:  # pragma: no cover — rotation target unwritable
            pass
        # lanes and track metadata restart with the file; the time base
        # carries over so a stitched view of <path>.1 + <path> stays on
        # one clock
        self._alloc = _LaneAllocator()
        self._seen_tracks = set()
        self._has_events = False

    def _push(self, events: List[dict]) -> None:
        """Queue events; write the coalesced tail once the batch bound
        or the time bound trips (caller holds the lock)."""
        self._pending.extend(events)
        now = time.monotonic()
        if (
            len(self._pending) < self.BATCH_EVENTS
            and now - self._last_write < self.FLUSH_INTERVAL_S
        ):
            return
        self._write_pending(now)

    def _write_pending(self, now: float) -> None:
        if not self._pending:
            return
        if not self._ensure_open():
            self._pending = []  # dead sink: drop, never grow unbounded
            return
        try:
            self._append(self._pending)
        except (OSError, ValueError):
            pass  # file rolled back (or sink marked broken) in _append
        self._pending = []
        self._last_write = now
        self._rotate_if_needed()

    # -- sink interface (registry calls these) -------------------------------

    def on_span(self, span: BatchSpan) -> None:
        with self._lock:
            if self._base is None:
                self._base = span.t0
            lane = self._alloc.lane(span)
            events: List[dict] = []
            if (span.path, lane) not in self._seen_tracks:
                self._seen_tracks.add((span.path, lane))
                events.extend(_thread_meta(span.path, lane))
            events.extend(span_trace_events(span, lane, self._base))
            self._push(events)

    def on_event(self, ev: InstantEvent) -> None:
        with self._lock:
            if self._base is None:
                self._base = ev.t
            self._push([instant_trace_event(ev, self._base)])

    def on_flow(self, flow: SliceFlow) -> None:
        """Stream one completed slice flow (envelope + phases + its s/f
        flow pair). The batch-span ``t`` steps need the full span->track
        map and are the on-demand renderer's job — a stitched continuous
        file still shows every slice lane and its arrival/serve arrows."""
        with self._lock:
            if self._base is None:
                self._base = flow.t0
            lane = self._alloc.lane(flow)
            events: List[dict] = []
            if ("slice", lane) not in self._seen_tracks:
                self._seen_tracks.add(("slice", lane))
                events.extend(_thread_meta("slice", lane))
            events.extend(flow_trace_events(flow, lane, self._base))
            self._push(events)

    def flush(self) -> None:
        """Force the coalesced tail onto disk (tests + shutdown)."""
        with self._lock:
            self._write_pending(time.monotonic())

    def close(self) -> None:
        with self._lock:
            self._write_pending(time.monotonic())
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:  # pragma: no cover
                    pass
                self._f = None


def install_sink(
    telemetry: Optional[PipelineTelemetry] = None,
) -> Optional[TraceFileSink]:
    """Arm (or disarm) the continuous file sink from the registry's
    config: ``trace_path`` names the file ("" disarms), ``trace_max_mb``
    bounds it. Called by ``telemetry.configure``; returns the sink or
    None. Capture must be on — a sink with capture off would record
    nothing anyway. A sink being replaced flushes its coalesced tail."""
    t = telemetry if telemetry is not None else TELEMETRY
    cfg = t.config
    old = t.trace_sink
    if old is not None and (not cfg.trace_path or not t.enabled or old.path != cfg.trace_path):
        old.close()
        t.trace_sink = None
    if not cfg.trace_path or not t.enabled:
        return None
    if t.trace_sink is not None:
        return t.trace_sink
    # construction touches no files (lazy open on the first write)
    sink = TraceFileSink(cfg.trace_path, int(float(cfg.trace_max_mb) * 1e6))
    t.trace_sink = sink
    # the coalesced tail (<= BATCH_EVENTS) must survive a clean exit
    atexit.register(sink.flush)
    return sink
