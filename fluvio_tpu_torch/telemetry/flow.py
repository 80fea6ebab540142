"""Per-slice causal flow records for the flight recorder.

The port's copy of ``fluvio_tpu/telemetry/flow.py``. The SPU's stream
handler books a held slice's ``hold`` on its flow, and an
`admission.AdmissionPipeline` its ``queue_wait`` and ``batcher``
residence; a flow's decision is ``admit`` or the last shed reason.

The span ring sees batches, not the slices a consumer is served: a
:class:`SliceFlow` is the per-slice walk: it is born when a
broker read slice (or an admission-pipeline submission) arrives, picks
up wall-positioned lifecycle phases as the slice moves —

- ``hold``        shed-held retry wait (admission backpressure),
- ``queue_wait``  admission fair-queue residence,
- ``batcher``     shape-bucket batcher residence (coalescing wait),
- ``serve``       arrival -> served end-to-end (recorded implicitly
                  from ``t0``/``t_end`` at close),

— and closes when the slice's output is served back. Completed flows
land in a bounded :class:`FlowRing` (capacity ``TelemetryConfig.slice_ring``)
and render as their own ``slice`` lane group in the Perfetto export,
connected to the batch spans they rode via Chrome-trace flow events
(``ph: s/t/f`` with a shared ``id`` — see telemetry/trace.py).

Cost contract: one object + a handful of clock reads per SLICE (never
per record, never per batch chunk); `PipelineTelemetry.begin_flow`
returns None when capture or ``TelemetryConfig.flow_trace`` is off, and every
instrumentation site guards on that.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from fluvio_tpu_torch.telemetry.spans import _BoundedRing

#: fixed slice-phase vocabulary (the registry's per-phase histograms
#: and the Prometheus ``slice_wait_seconds`` family key on it)
SLICE_PHASES = ("queue_wait", "batcher", "hold", "serve")


class SliceFlow:
    """One slice's causal walk through the serving pipeline.

    Not thread-safe; owned by the task driving the slice (ring
    insertion at `PipelineTelemetry.end_flow` is what synchronizes),
    exactly like `BatchSpan`.
    """

    #: lane-group key in the trace renderer (class attribute so the
    #: lane allocator treats flows as one track family)
    path = "slice"

    __slots__ = (
        "flow_id", "chain", "tenant", "t0", "t_end", "records", "phases",
        "decision", "holds", "cause", "sources", "dispatch_t",
        "_q_t0", "_b_t0",
    )

    def __init__(self, flow_id: int, chain: str = "", tenant: str = "") -> None:
        self.flow_id = flow_id
        self.chain = chain
        #: tenant label (topic-name prefix) — the soak scorer joins
        #: flow-ring records against the per-tenant counter families
        self.tenant = tenant
        self.t0 = time.perf_counter()
        self.t_end: Optional[float] = None
        self.records = 0
        #: wall-positioned phases: (name, start, seconds)
        self.phases: List[Tuple[str, float, float]] = []
        #: last admission outcome ("admit" or the shed reason)
        self.decision: Optional[str] = None
        self.holds = 0  # shed-then-retry cycles survived
        #: batcher flush cause + co-batched source count (coalesced
        #: flows only) — "which batch did this slice ride, and why"
        self.cause: Optional[str] = None
        self.sources = 0
        #: when the slice's device dispatch was enqueued (the renderer
        #: joins batch spans against [dispatch_t, t_end])
        self.dispatch_t: Optional[float] = None
        self._q_t0: Optional[float] = None
        self._b_t0: Optional[float] = None

    # -- phase capture -------------------------------------------------------

    def add_phase(self, name: str, start: float, seconds: float) -> None:
        if seconds > 0.0:
            self.phases.append((name, start, seconds))

    def hold(self, seconds: float) -> None:
        """One shed-hold released: callers measure ``seconds`` against
        a clock read taken at the hold start, so now-seconds is it."""
        self.holds += 1
        self.add_phase("hold", time.perf_counter() - seconds, seconds)

    def note_queue(self) -> None:
        self._q_t0 = time.perf_counter()

    def end_queue(self) -> None:
        if self._q_t0 is not None:
            now = time.perf_counter()
            self.add_phase("queue_wait", self._q_t0, now - self._q_t0)
            self._q_t0 = None

    def note_batcher(self) -> None:
        self._b_t0 = time.perf_counter()

    def end_batcher(self, cause: str, sources: int) -> None:
        self.cause = cause
        self.sources = sources
        if self._b_t0 is not None:
            now = time.perf_counter()
            self.add_phase("batcher", self._b_t0, now - self._b_t0)
            self._b_t0 = None

    def mark_dispatch(self) -> None:
        self.dispatch_t = time.perf_counter()

    def close(self, records: int = 0) -> None:
        self.t_end = time.perf_counter()
        self.records = records

    # -- reads ---------------------------------------------------------------

    def phase_totals(self) -> Dict[str, float]:
        """{phase: total seconds} across this flow's recorded phases."""
        out: Dict[str, float] = {}
        for name, _start, s in self.phases:
            out[name] = out.get(name, 0.0) + s
        return out

    def serve_seconds(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return max(end - self.t0, 0.0)

    def to_dict(self) -> Dict:
        d: Dict = {
            "flow_id": self.flow_id,
            "records": self.records,
            "serve_ms": round(self.serve_seconds() * 1000, 3),
            "t0": round(self.t0, 6),
        }
        if self.chain:
            d["chain"] = self.chain
        if self.tenant:
            d["tenant"] = self.tenant
        if self.decision:
            d["decision"] = self.decision
        if self.holds:
            d["holds"] = self.holds
        if self.cause:
            d["cause"] = self.cause
            d["sources"] = self.sources
        if self.t_end is not None:
            d["t_end"] = round(self.t_end, 6)
        totals = self.phase_totals()
        if totals:
            d["phases_ms"] = {
                k: round(v * 1000, 3) for k, v in totals.items()
            }
        return d


class FlowRing(_BoundedRing):
    """Bounded ring of completed `SliceFlow`s (same primitive as the
    span/event rings — one lock/slicing discipline for all three)."""

    def __init__(self, capacity: int = 512) -> None:
        super().__init__(capacity)
