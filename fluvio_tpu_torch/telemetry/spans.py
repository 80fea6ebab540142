"""Per-batch pipeline spans with fixed phase labels, in a bounded ring.

The port's copy of ``fluvio_tpu/telemetry/spans.py``. In the port the
``device`` phase runs from the end of a batch's dispatch to the return of
its first blocking wait (the CUDA event of its result copies), and
``spill`` stays 0: the port reruns nothing in an interpreter.

A `BatchSpan` is one batch's walk through the pipeline. Phases are a
FIXED vocabulary (indexes into one flat float list — no per-phase dict
allocation on the hot path):

- ``stage``        host staging: ragged flat build, column merge/slice
- ``glz_compress`` host glz compression of the H2D flat
- ``h2d``          host-side link staging/enqueue (pinned copies to the
                   card; the physical transfer overlaps ``device``)
- ``dispatch``     the chain's torch calls: kernel launches enqueued
- ``device``       dispatch-complete -> first result sync satisfied
                   (TRUE device-compute span: measured from the
                   dispatch -> result-event wait delta, so the pipelined
                   stream loop attributes overlap correctly — batch k's
                   device time keeps counting while the host dispatches
                   batch k+1)
- ``fetch``        host-side result materialization after download
- ``d2h``          blocking device->host copy time
- ``glz_decode``   host decompression of stored-batch compression on
                   the staging side (the card's glz decode of the up
                   link is part of ``device``)
- ``spill``        interpreter re-run after a fused-path spill/decline

Overhead contract: begin/end is two monotonic clock reads; each phase
adds one clock pair. No per-record work anywhere.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

PHASES = (
    "stage",
    "glz_compress",
    "h2d",
    "dispatch",
    "device",
    "fetch",
    "d2h",
    "glz_decode",
    "spill",
)
_PHASE_INDEX = {name: i for i, name in enumerate(PHASES)}


class BatchSpan:
    """One batch's phase timings. Not thread-safe; owned by the thread
    driving the batch (ring insertion at `end` is what synchronizes)."""

    __slots__ = (
        "t0", "t_end", "phase_s", "phase_t0", "records", "path", "chain",
        "dispatch_end", "ready_t",
    )

    def __init__(self, path: str = "fused", chain: str = "") -> None:
        self.t0 = time.perf_counter()
        self.t_end: Optional[float] = None
        self.phase_s: List[float] = [0.0] * len(PHASES)
        # first-add start time per phase (0.0 = never recorded): the
        # trace renderer places each phase's duration event at its real
        # wall position instead of reconstructing a serial layout
        self.phase_t0: List[float] = [0.0] * len(PHASES)
        self.records = 0
        self.path = path
        # chain identity (the executor's compact chain signature, e.g.
        # "filter+map"): keys the per-chain latency family the SLO
        # engine's windowed verdicts evaluate; "" = unattributed
        self.chain = chain
        # set by mark_dispatched; the device phase measures from here
        self.dispatch_end: Optional[float] = None
        # when the first blocking result sync returned (finish-side
        # "fetch" accounting subtracts the wait up to this point)
        self.ready_t: Optional[float] = None

    def add(self, phase: str, seconds: float) -> None:
        if seconds > 0.0:
            i = _PHASE_INDEX[phase]
            if self.phase_s[i] == 0.0:
                # callers measure `seconds` against a clock read taken
                # just before this call, so now-seconds is the start
                self.phase_t0[i] = time.perf_counter() - seconds
            self.phase_s[i] += seconds

    def mark_dispatched(self) -> None:
        self.dispatch_end = time.perf_counter()

    def mark_device_ready(self) -> None:
        """First blocking sync on this batch's results returned: the
        device span is dispatch-end -> now (monotone clock pair)."""
        now = time.perf_counter()
        if self.dispatch_end is not None:
            self.add("device", now - self.dispatch_end)
            self.dispatch_end = None  # a re-dispatch restarts the pair
        self.ready_t = now

    def phase(self, name: str) -> float:
        return self.phase_s[_PHASE_INDEX[name]]

    def lap(self, phase: str, t0: float) -> float:
        """Add the time since ``t0`` (a `time.perf_counter` read) to
        ``phase``; returns now, the next phase's ``t0`` (the port's
        seams time consecutive phases with one clock read each)."""
        now = time.perf_counter()
        self.add(phase, now - t0)
        return now

    def to_dict(self) -> Dict:
        d = {
            "path": self.path,
            "records": self.records,
        }
        if self.chain:
            d["chain"] = self.chain
        d |= {
            "e2e_ms": round(
                ((self.t_end if self.t_end is not None else time.perf_counter())
                 - self.t0) * 1000, 3,
            ),
            "t0": round(self.t0, 6),
        }
        if self.t_end is not None:
            d["t_end"] = round(self.t_end, 6)
        d["phases_ms"] = {
            name: round(s * 1000, 3)
            for name, s in zip(PHASES, self.phase_s)
            if s > 0.0
        }
        return d


class _BoundedRing:
    """Bounded ring: O(1) push, most recent ``capacity`` items retained
    in completion order, overwrites counted (``dropped``). One
    implementation for the span and instant-event rings — a fix to the
    slicing or lock discipline cannot land in one and miss the other."""

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._slots: List = [None] * capacity
        self._next = 0  # total pushes (monotone)
        self._lock = threading.Lock()

    def push(self, item) -> None:
        with self._lock:
            self._slots[self._next % self.capacity] = item
            self._next += 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._next, self.capacity)

    @property
    def total(self) -> int:
        """Items ever pushed (wrapped ones included)."""
        with self._lock:
            return self._next

    @property
    def dropped(self) -> int:
        """Items the ring has overwritten (total − retained): nonzero
        means a dump/trace of this ring is missing history — detectable
        instead of silently lossy."""
        with self._lock:
            return max(self._next - self.capacity, 0)

    def stats(self) -> "tuple":
        """(total, retained, dropped) under ONE lock acquisition — the
        scrape-visible invariant total == retained + dropped can tear
        across separate property reads when a push lands between them."""
        with self._lock:
            total = self._next
            retained = min(total, self.capacity)
            return total, retained, total - retained

    def recent(self, limit: Optional[int] = None) -> List:
        """Most-recent-last list of retained items."""
        with self._lock:
            n = min(self._next, self.capacity)
            start = self._next - n
            items = [
                self._slots[i % self.capacity] for i in range(start, self._next)
            ]
        if limit is not None and limit < len(items):
            items = items[-limit:]
        return items


class SpanRing(_BoundedRing):
    """Bounded ring of completed `BatchSpan`s."""

    def __init__(self, capacity: int = 256) -> None:
        super().__init__(capacity)


class InstantEvent:
    """One point-in-time pipeline event (heal, spill, retry, breaker
    transition, compile, quarantine) for the flight recorder: the trace
    renders these as instant markers over the batch tracks."""

    __slots__ = ("t", "kind", "detail")

    def __init__(self, kind: str, detail: str = "") -> None:
        self.t = time.perf_counter()
        self.kind = kind
        self.detail = detail

    def to_dict(self) -> Dict:
        d = {"t": round(self.t, 6), "kind": self.kind}
        if self.detail:
            d["detail"] = self.detail
        return d


class EventRing(_BoundedRing):
    """Bounded ring of `InstantEvent`s."""

    def __init__(self, capacity: int = 512) -> None:
        super().__init__(capacity)
