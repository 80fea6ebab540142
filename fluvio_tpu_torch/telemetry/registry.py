"""Process-wide telemetry registry.

The port's copy of ``fluvio_tpu/telemetry/registry.py``. The JAX package
reads its settings from the environment; the port reads none: every one
of them is a field of `TelemetryConfig`, whose defaults are the JAX
package's defaults, applied with ``telemetry.configure(cfg)`` (or an
SPU's ``SpuConfig.telemetry``).

One `PipelineTelemetry` per process (module-global ``TELEMETRY``),
recording:

- batch end-to-end latency histograms, split by path (``fused`` /
  ``striped`` / ``interpreter``) so the execution modes are directly
  comparable,
- per-phase latency histograms + running time totals (the bench's
  per-phase breakdown reads the totals; histograms answer "is the
  d2h tail bimodal"),
- event counters: glz heals, interpreter spills keyed by reason,
  stripe fallbacks, fast-path declines keyed by reason,
- build telemetry: the port compiles no jit, so its compile events are
  the builds of its native libraries (the CUDA kernels with nvcc, the
  host codecs with g++, `telemetry/compiles.py`): per-kind counts + wall
  seconds + a latency histogram, built-vs-cached attribution in the
  persistent-cache counters, and a recompile-storm decline counter,
- gauges (point-in-time, not monotone): device-resident staged bytes,
  live dispatch handles, pipelined in-flight queue depth, dead-letter
  dir occupancy,
- a bounded ring of recent `BatchSpan`s plus a ring of instant events
  (heals/spills/retries/breaker/compiles) feeding the flight-recorder
  trace export (telemetry/trace.py).

Hot-path contract: `begin_batch` returns None when capture is disabled
(``TelemetryConfig(enabled=False)``) and every instrumentation site
guards on that;
`end_batch` takes one lock for the histogram adds (per BATCH, never per
record). Counters stay on even when capture is off — they cost the same
as the existing `SmartModuleChainMetrics` adds.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from fluvio_tpu_torch.telemetry.histogram import LatencyHistogram
from fluvio_tpu_torch.telemetry.flow import SLICE_PHASES, FlowRing, SliceFlow
from fluvio_tpu_torch.telemetry.spans import (
    PHASES,
    BatchSpan,
    EventRing,
    InstantEvent,
    SpanRing,
)

SPAN_RING_CAPACITY = 256
EVENT_RING_CAPACITY = 512


@dataclass(frozen=True)
class TelemetryConfig:
    """Every telemetry setting, one field each, in place of the JAX
    package's environment variables (named beside each field); the
    defaults are that package's. Apply with ``telemetry.configure``."""

    enabled: bool = True  # FLUVIO_TELEMETRY: capture master switch
    flow_trace: bool = True  # FLUVIO_FLOW_TRACE: per-slice flows (with capture)
    # FLUVIO_SLICE_RING: completed slice flows retained for the trace
    # export (one entry per SLICE, so 512 covers minutes of serving)
    slice_ring: int = 512
    # FLUVIO_COMPILE_STORM_N / _WINDOW_S: more than N build events inside
    # the window count one "recompile-storm" decline each, so a storm is
    # visible on every decline surface (Prometheus, snapshot)
    compile_storm_n: int = 8
    compile_storm_window_s: float = 60.0
    tenant_cap: int = 128  # FLUVIO_SOAK_TENANT_CAP: tenant labels kept
    trace_path: str = ""  # FLUVIO_TRACE: continuous Perfetto sink ("" = off)
    trace_max_mb: float = 64.0  # FLUVIO_TRACE_MAX_MB: sink rotation bound
    slo: str = ""  # FLUVIO_SLO: "rule:field=v;..." over the default rules
    slo_window_s: float = 10.0  # FLUVIO_SLO_WINDOW_S: one window's length
    slo_windows: int = 30  # FLUVIO_SLO_WINDOWS: windows retained
    # FLUVIO_SLO_PROFILE: directory of the torch.profiler capture a breach
    # takes ("" = no capture); _MS its dwell, _COOLDOWN_S the least gap
    slo_profile_dir: str = ""
    slo_profile_ms: float = 0.0
    slo_profile_cooldown_s: float = 60.0
    mem_budget: int = 0  # FLUVIO_MEM_BUDGET: ledger ceiling, bytes (0 = none)
    mem_leak_ttl_s: float = 120.0  # FLUVIO_MEM_LEAK_TTL_S
    mem_sample_s: float = 10.0  # FLUVIO_MEM_SAMPLE_S: least gap of ledger scans


def tenant_label(topic: str) -> str:
    """Tenant identity carried by the topic name: the soak generator
    names topics ``{tenant}.{stream}``, so the prefix before the first
    dot IS the tenant — no protocol change, and single-segment topics
    stay their own (degenerate) tenant."""
    if not topic:
        return ""
    return topic.split(".", 1)[0]


class PipelineTelemetry:
    def __init__(
        self,
        ring_capacity: int = SPAN_RING_CAPACITY,
        config: Optional[TelemetryConfig] = None,
    ) -> None:
        self.config = config if config is not None else TelemetryConfig()
        self.enabled = self.config.enabled
        self._lock = threading.Lock()
        # the device the engine's seams book bytes on (`note_device`): the
        # memory ledger reconciles against its allocator and the SLO
        # breach capture profiles it
        self.device = None
        # bumped by reset(): cumulative counters going BACKWARDS would
        # corrupt the time-series layer's window deltas, so its ring
        # self-invalidates when the generation changes
        self._generation = 0
        self.batch_latency: Dict[str, LatencyHistogram] = {
            "fused": LatencyHistogram(),
            "striped": LatencyHistogram(),
            "interpreter": LatencyHistogram(),
        }
        self.phase_hist: Dict[str, LatencyHistogram] = {
            p: LatencyHistogram() for p in PHASES
        }
        # per-chain e2e latency (keyed by the executor's chain
        # signature): the SAME mergeable-histogram primitive as the
        # path split above, so windowed per-chain rate/p50/p99 for the
        # SLO engine come from diffing snapshots — no second
        # instrumentation seam. Bounded like breaker_states: a broker
        # that builds a chain per stream keeps the 64 most recent.
        self.chain_latency: Dict[str, LatencyHistogram] = {}
        self.spans = SpanRing(ring_capacity)
        # event counters (always-on)
        self.heals = 0
        self.stripe_fallbacks = 0
        self.spills: Dict[str, int] = {}
        self.declines: Dict[str, int] = {}
        # which form each dispatched batch's flat crossed the H2D link
        # in: "raw" | "glz-gather" | "glz-pallas" (the bench's per-config
        # link breakdown and the preflight link-variant prediction both
        # read this family)
        self.link_variants: Dict[str, int] = {}
        self.batch_records: Dict[str, int] = {
            "fused": 0, "striped": 0, "interpreter": 0
        }
        # resilience counters: bounded-retry attempts keyed by the
        # seam that failed, poison batches dead-lettered, and the
        # per-chain circuit-breaker state machine (current state per
        # breaker + transition counts + open-state short-circuits)
        self.retries: Dict[str, int] = {}
        self.quarantined = 0
        # sharded inline-compress accounting (ROADMAP's noted gap: the
        # compress-ahead worker covers only single-device buffers, so a
        # sharded stream pays the n-shard compressor inline in stage):
        # shard segments glz-compressed inline, so the "extend the
        # worker to pre-fill _glz_shard_cache" call can be made from
        # evidence instead of guesswork
        self.sharded_compress_shards = 0
        # SLO breach transitions, keyed "chain/rule" (telemetry/slo.py)
        self.slo_breaches: Dict[str, int] = {}
        # admission-controller decisions keyed by outcome (admission/):
        # "admit" plus the shed reasons (breach-shed, warn-shed,
        # no-tokens, queue-full, breaker-open, cold-chain) and the
        # batcher flush causes (batch-full, batch-deadline, shutdown,
        # solo, cold-bucket)
        self.admission: Dict[str, int] = {}
        self.breaker_states: Dict[str, str] = {}
        self.breaker_transitions: Dict[str, int] = {}
        self.breaker_short_circuits = 0
        # per-module-instance interpreter accounting (one clock pair per
        # instance per batch): lets fused-vs-interpreter cost comparisons
        # see where interpreter time concentrates without per-record work
        self.interp_calls = 0
        self.interp_seconds = 0.0
        self.interp_records = 0
        # build observability: every native library the process built
        # or found cached records {kind, wall seconds, cached or built}
        self.compiles: Dict[str, int] = {}
        self.compile_seconds: Dict[str, float] = {}
        self.compile_hist = LatencyHistogram()
        self.persistent_cache_hits = 0
        self.persistent_cache_misses = 0
        self.jit_cache_hits = 0  # the port has no jit: stays 0
        self._compile_times: List[float] = []  # storm-window timestamps
        # gauges (point-in-time values, not monotone): device-resident
        # staged bytes / live dispatch handles / pipelined in-flight
        # queue depth. Updates go through gauge_add/gauge_set, which are
        # no-ops when capture is off — the zero-cost contract covers them.
        self.gauges: Dict[str, float] = {}
        # instant events (heals, spills, retries, breaker transitions,
        # compiles, quarantines) for the flight recorder's trace view
        self.events = EventRing(EVENT_RING_CAPACITY)
        # per-slice causal flow layer: flow tracing arms with capture
        # unless config.flow_trace is off; begin_flow returns None when
        # either is off (the zero-cost seam every site guards on)
        self.flow_trace = self.config.flow_trace
        self.flows = FlowRing(self.config.slice_ring)
        self._flow_seq = 0
        # per-phase slice lifecycle histograms (queue-wait, batcher
        # residence, shed-hold, arrival->served): the Prometheus
        # slice_wait_seconds / admission_hold_seconds families
        self.slice_hist: Dict[str, LatencyHistogram] = {
            p: LatencyHistogram() for p in SLICE_PHASES
        }
        # streaming-lag families (telemetry/lag.py writes them): point-
        # in-time consumer lag per chain@topic/partition, served-record
        # counters, and the end-to-end record-age histogram (append
        # wall-time -> served). Bounded like chain_latency.
        self.consumer_lag: Dict[str, float] = {}
        self.served_records: Dict[str, int] = {}
        self.record_age: Dict[str, LatencyHistogram] = {}
        # per-tenant accounting plane: served/shed/held
        # counters and record-age histograms keyed by tenant label (the
        # topic-name prefix). Label cardinality is HARD-capped — a
        # million-tenant soak run folds everyone past the cap into ONE
        # "_overflow" bucket instead of growing these dicts unboundedly
        # (LRU eviction would silently restart the hottest tenant's
        # counters, so overflow-fold is the honest bound here).
        self.tenant_cap = int(self.config.tenant_cap)
        self.tenant_served: Dict[str, int] = {}
        self.tenant_shed: Dict[str, int] = {}
        self.tenant_held: Dict[str, int] = {}
        self.tenant_age: Dict[str, LatencyHistogram] = {}
        # rebalance/migration plane: voluntary partition
        # moves by reason (lag burn, split, merge, rollback) + the
        # migration-duration histogram — the rebalancer daemon's
        # observable output, read by prom/CLI/bench
        self.rebalance_moves: Dict[str, int] = {}
        self.migration_hist = LatencyHistogram()
        # windowed-state plane: delta-only emission
        # accounting — windows closed, delta rows by kind
        # (upsert/close/resync/late), and the delta-vs-full downlink
        # byte split whose ratio is the d2h-win evidence
        self.windows_closed = 0
        self.window_deltas: Dict[str, int] = {}
        self.window_delta_bytes = 0
        self.window_full_bytes = 0
        # device-memory plane: leak-detector counter by
        # owner class. The ledger itself lives in telemetry/memory.py;
        # this counter is always-on like the window close counts (a
        # leak that happened while capture was off is still a leak).
        self.memory_leaks: Dict[str, int] = {}
        # pull-join hook: telemetry/lag.py installs its sampler here so
        # the time-series tick (and the Prometheus scrape) re-joins
        # committed offsets against replica high watermarks at the
        # sampling edge — lag keeps moving while serving is fully shed
        self.lag_sampler = None
        # pull-join hook: telemetry/memory.py installs the ledger's
        # leak-scan/reconcile sampler here (same contract as
        # lag_sampler — the scrape edge keeps the leak TTL honest
        # while nothing is dispatching)
        self.mem_sampler = None
        # optional flight-recorder sink (telemetry/trace.py installs it
        # from config.trace_path): completed spans and instant events stream
        # into it as they happen
        self.trace_sink = None

    # -- configuration -------------------------------------------------------

    def apply_config(self, config: TelemetryConfig) -> None:
        """Take ``config``'s registry settings (capture, flows, tenant
        cap, storm detection, the flow ring's capacity). Counters and
        rings keep what they hold; a changed ring capacity starts an
        empty flow ring."""
        with self._lock:
            self.config = config
            self.enabled = config.enabled
            self.flow_trace = config.flow_trace
            self.tenant_cap = int(config.tenant_cap)
        if self.flows.capacity != config.slice_ring:
            self.flows = FlowRing(config.slice_ring)

    def note_device(self, device) -> None:
        """Record the device an engine runs on (executors and windowed
        runtimes call this once at construction; the last one wins)."""
        self.device = device

    # -- span lifecycle ------------------------------------------------------

    def begin_batch(
        self, path: str = "fused", chain: str = ""
    ) -> Optional[BatchSpan]:
        if not self.enabled:
            return None
        return BatchSpan(path, chain)

    def end_batch(self, span: Optional[BatchSpan], records: int = 0) -> None:
        if span is None:
            return
        span.t_end = time.perf_counter()
        span.records = records
        e2e = span.t_end - span.t0
        with self._lock:
            hist = self.batch_latency.get(span.path)
            if hist is None:  # pragma: no cover — fixed path vocabulary
                hist = self.batch_latency.setdefault(
                    span.path, LatencyHistogram()
                )
            hist.record(e2e)
            self.batch_records[span.path] = (
                self.batch_records.get(span.path, 0) + records
            )
            if span.chain:
                ch = self.chain_latency.get(span.chain)
                if ch is None:
                    ch = self.chain_latency.setdefault(
                        span.chain, LatencyHistogram()
                    )
                    while len(self.chain_latency) > 64:
                        self.chain_latency.pop(
                            next(iter(self.chain_latency))
                        )
                ch.record(e2e)
            for name, s in zip(PHASES, span.phase_s):
                if s > 0.0:
                    self.phase_hist[name].record(s)
        self.spans.push(span)
        sink = self.trace_sink
        if sink is not None:
            sink.on_span(span)

    def add_phase(self, name: str, seconds: float) -> None:
        """Record phase time measured outside a span (slice-level host
        staging in the broker bridge, where one read slice fans into
        several per-chunk spans)."""
        if not self.enabled or seconds <= 0.0:
            return
        with self._lock:
            self.phase_hist[name].record(seconds)

    # -- slice flows (per-slice causal tracing) ------------------------------

    def begin_flow(
        self, chain: str = "", tenant: str = ""
    ) -> Optional[SliceFlow]:
        """A new slice's flow record, or None when capture/flow tracing
        is off (every caller guards on that — the zero-cost seam)."""
        if not (self.enabled and self.flow_trace):
            return None
        with self._lock:
            self._flow_seq += 1
            fid = self._flow_seq
        return SliceFlow(fid, chain, tenant)

    def end_flow(self, flow: Optional[SliceFlow], records: int = 0) -> None:
        """Close a slice flow: record its lifecycle phases into the
        per-phase slice histograms and push it onto the flow ring (and
        the continuous trace sink when one is armed). ``hold`` phases
        are NOT re-recorded here — the handler books them at each hold
        release via `add_slice_phase`, so a stream cancelled mid-hold
        still counts and nothing double-records."""
        if flow is None:
            return
        flow.close(records)
        with self._lock:
            for name, s in flow.phase_totals().items():
                if name == "hold":
                    continue
                h = self.slice_hist.get(name)
                if h is not None:
                    h.record(s)
            self.slice_hist["serve"].record(flow.serve_seconds())
        self.flows.push(flow)
        sink = self.trace_sink
        if sink is not None:
            on_flow = getattr(sink, "on_flow", None)
            if on_flow is not None:
                on_flow(flow)

    def add_slice_phase(self, name: str, seconds: float) -> None:
        """Record one slice-phase observation outside a flow close (the
        hold release in the stream handler, flow-less slices)."""
        if not self.enabled or seconds <= 0.0:
            return
        with self._lock:
            h = self.slice_hist.get(name)
            if h is not None:
                h.record(seconds)

    def flows_json(self, limit: Optional[int] = None) -> List[dict]:
        return [f.to_dict() for f in self.flows.recent(limit)]

    # -- streaming lag / record age (telemetry/lag.py writes these) ----------

    def set_consumer_lag(self, key: str, lag: float) -> None:
        """Point-in-time consumer lag (records behind the replica high
        watermark) for one ``chain@topic/partition``. Bounded +
        recency-refreshed like the breaker map."""
        if not self.enabled:
            return
        with self._lock:
            self.consumer_lag.pop(key, None)
            self.consumer_lag[key] = float(lag)
            while len(self.consumer_lag) > 128:
                self.consumer_lag.pop(next(iter(self.consumer_lag)))

    def clear_consumer_lag(self, key: str) -> None:
        with self._lock:
            self.consumer_lag.pop(key, None)

    def add_served(self, key: str, records: int) -> None:
        if not self.enabled or records <= 0:
            return
        with self._lock:
            # pop+reinsert refreshes recency (like the breaker map), so
            # with >128 active keys the IDLE ones evict, not the hottest
            total = self.served_records.pop(key, 0) + records
            self.served_records[key] = total
            while len(self.served_records) > 128:
                self.served_records.pop(next(iter(self.served_records)))

    def add_record_age(self, key: str, seconds: float) -> None:
        """One end-to-end record-age observation (append wall-time ->
        served) for one ``chain@topic/partition`` — one observation per
        served SLICE, never per record."""
        if not self.enabled:
            return
        with self._lock:
            # recency-refreshed like set_consumer_lag: insertion-order
            # eviction would destroy (and silently restart) the BUSIEST
            # stream's histogram once >64 keys are active, and the
            # record_age_p99 window delta would go blind on it
            h = self.record_age.pop(key, None)
            if h is None:
                h = LatencyHistogram()
            self.record_age[key] = h
            while len(self.record_age) > 64:
                self.record_age.pop(next(iter(self.record_age)))
            h.record(max(seconds, 0.0))

    def lag_families(self):
        """(consumer_lag, served_records, record-age copies) under ONE
        lock hold — the lag snapshot surface reads all three coherently."""
        with self._lock:
            return (
                dict(self.consumer_lag),
                dict(self.served_records),
                {k: h.copy() for k, h in self.record_age.items()},
            )

    # -- per-tenant accounting (the soak plane) ------------------------------

    def _tenant_key(self, d: dict, tenant: str) -> str:
        """Resolve the bounded label for ``tenant`` in family ``d``
        (caller holds the lock): known tenants and tenants under the cap
        keep their own label; everyone else folds into "_overflow"."""
        if tenant in d or len(d) < self.tenant_cap:
            return tenant
        return "_overflow"

    def add_tenant_served(self, tenant: str, records: int) -> None:
        if not self.enabled or not tenant or records <= 0:
            return
        with self._lock:
            k = self._tenant_key(self.tenant_served, tenant)
            self.tenant_served[k] = self.tenant_served.get(k, 0) + records

    def add_tenant_shed(self, tenant: str) -> None:
        if not self.enabled or not tenant:
            return
        with self._lock:
            k = self._tenant_key(self.tenant_shed, tenant)
            self.tenant_shed[k] = self.tenant_shed.get(k, 0) + 1

    def add_tenant_held(self, tenant: str) -> None:
        if not self.enabled or not tenant:
            return
        with self._lock:
            k = self._tenant_key(self.tenant_held, tenant)
            self.tenant_held[k] = self.tenant_held.get(k, 0) + 1

    def add_tenant_age(self, tenant: str, seconds: float) -> None:
        """One served-slice record-age observation attributed to a
        tenant (one per SLICE, never per record — same cadence as
        `add_record_age`)."""
        if not self.enabled or not tenant:
            return
        with self._lock:
            k = self._tenant_key(self.tenant_age, tenant)
            h = self.tenant_age.get(k)
            if h is None:
                h = self.tenant_age.setdefault(k, LatencyHistogram())
            h.record(max(seconds, 0.0))

    def tenant_families(self):
        """(served, shed, held, age copies) under ONE lock hold — the
        soak scorer and the Prometheus export read all four coherently."""
        with self._lock:
            return (
                dict(self.tenant_served),
                dict(self.tenant_shed),
                dict(self.tenant_held),
                {k: h.copy() for k, h in self.tenant_age.items()},
            )

    def refresh_lag(self) -> None:
        """Pull-join the lag gauges (telemetry/lag.py installs the
        sampler). One attribute check when nothing is tracked; never
        raises — a dead leader ref must not take a scrape with it."""
        sampler = self.lag_sampler
        if sampler is None or not self.enabled:
            return
        try:
            sampler()
        except Exception:  # noqa: BLE001 — scrape surfaces must stay live
            pass

    def refresh_memory(self) -> None:
        """Pull the device-memory ledger's sampler (leak scan +
        backend reconciliation + gauge republish). Same contract as
        :meth:`refresh_lag`: one attribute check when no ledger exists,
        never raises into a scrape."""
        sampler = self.mem_sampler
        if sampler is None or not self.enabled:
            return
        try:
            sampler()
        except Exception:  # noqa: BLE001 — scrape surfaces must stay live
            pass

    # -- device-memory ledger seams ------------------------------------------

    def mem_acquire(self, owner: str, key, nbytes: int) -> None:
        """Book device bytes under ``owner`` in the memory ledger. One
        ``enabled`` check when capture is off — the hot allocation
        seams (stage/dispatch/swap-in) call this unconditionally."""
        if not self.enabled or nbytes <= 0:
            return
        from fluvio_tpu_torch.telemetry import memory as memory_mod

        memory_mod.engine().acquire(owner, key, nbytes)

    def mem_release(self, key) -> None:
        """Retire a ledger booking. Idempotent at the ledger; gated
        here so disabled capture costs one attribute check."""
        if not self.enabled:
            return
        from fluvio_tpu_torch.telemetry import memory as memory_mod

        eng = memory_mod.peek()
        if eng is not None:
            eng.release(key)

    # -- instant events (flight recorder) ------------------------------------

    def _event(self, kind: str, detail: str = "") -> None:
        """Capture a point-in-time event for the trace view. Gated on
        ``enabled`` like span capture (the counters the event annotates
        stay always-on either way)."""
        if not self.enabled:
            return
        ev = InstantEvent(kind, detail)
        self.events.push(ev)
        sink = self.trace_sink
        if sink is not None:
            sink.on_event(ev)

    def events_json(self, limit: Optional[int] = None) -> List[dict]:
        return [e.to_dict() for e in self.events.recent(limit)]

    # -- counters ------------------------------------------------------------

    def add_heal(self) -> None:
        with self._lock:
            self.heals += 1
        self._event("heal")

    def add_stripe_fallback(self) -> None:
        with self._lock:
            self.stripe_fallbacks += 1

    def add_spill(self, reason: str) -> None:
        with self._lock:
            self.spills[reason] = self.spills.get(reason, 0) + 1
        self._event("spill", reason)

    def add_decline(self, reason: str) -> None:
        with self._lock:
            self.declines[reason] = self.declines.get(reason, 0) + 1

    def add_link_variant(self, variant: str) -> None:
        with self._lock:
            self.link_variants[variant] = (
                self.link_variants.get(variant, 0) + 1
            )

    def link_variant_counts(self) -> Dict[str, int]:
        """{variant: batches} — the bench diffs two of these around a
        run to report which link form each config actually shipped."""
        with self._lock:
            return dict(self.link_variants)

    def add_retry(self, point: str) -> None:
        with self._lock:
            self.retries[point] = self.retries.get(point, 0) + 1
        self._event("retry", point)

    def add_quarantine(self) -> None:
        with self._lock:
            self.quarantined += 1
        self._event("quarantine")

    def add_sharded_compress(self, shards: int) -> None:
        """Shard segments glz-compressed INLINE on the sharded staging
        path (the compress-ahead worker does not cover sharded buffers
        yet; this counter + the ``glz_compress`` phase span are the
        evidence for extending it)."""
        with self._lock:
            self.sharded_compress_shards += shards

    def add_slo_breach(self, key: str, detail: str = "") -> None:
        """One SLO verdict transition into ``breach`` for ``key``
        ("chain/rule"). Emits the flight-recorder instant event so the
        breach lands on the Perfetto timeline next to the batch spans
        it indicts."""
        with self._lock:
            self.slo_breaches[key] = self.slo_breaches.get(key, 0) + 1
        self._event("slo-breach", detail or key)

    def add_memory_leak(self, owner: str, detail: str = "") -> None:
        """One device-memory ledger entry aged past its leak TTL with
        no release. Counter is always-on (a leak is a leak); the
        flight-recorder instant lands the leak on the Perfetto
        timeline next to the spans that stranded it."""
        with self._lock:
            self.memory_leaks[owner] = self.memory_leaks.get(owner, 0) + 1
        self._event("mem-leak", detail or owner)

    def memory_leak_counts(self) -> Dict[str, int]:
        """{owner: leaks} — the memory CLI's rc gate reads this."""
        with self._lock:
            return dict(self.memory_leaks)

    def add_admission(self, reason: str) -> None:
        """One admission-controller decision: ``admit`` or a shed/flush
        reason. Breaker-open sheds and health sheds count on this ONE
        family so every decline surface (prom, CLI table, snapshot)
        reads admission behavior from a single vocabulary."""
        with self._lock:
            self.admission[reason] = self.admission.get(reason, 0) + 1

    def add_rebalance_move(self, reason: str, detail: str = "") -> None:
        """One voluntary partition migration outcome (reason ∈ the
        rebalancer's vocabulary: lag/split/merge/manual/rollback).
        Counts always-on like admission; the flight-recorder instant
        event (gated with capture) lands the move on the Perfetto
        timeline next to the slice flows it unblocks."""
        with self._lock:
            self.rebalance_moves[reason] = (
                self.rebalance_moves.get(reason, 0) + 1
            )
        self._event("rebalance", detail or reason)

    def add_migration_seconds(self, seconds: float) -> None:
        """One migration's drain+replay duration (seconds)."""
        if not self.enabled:
            return
        with self._lock:
            self.migration_hist.record(max(seconds, 0.0))

    def rebalance_families(self):
        """(moves-by-reason, migration histogram copy) under ONE lock
        hold — the CLI status table and bench read both coherently."""
        with self._lock:
            return dict(self.rebalance_moves), self.migration_hist.copy()

    def add_windows_closed(self, n: int) -> None:
        """``n`` windows crossed the close watermark this batch.
        Always-on like admission: close counts are exactness evidence
        (the pins diff them around runs), not observability sugar."""
        if n <= 0:
            return
        with self._lock:
            self.windows_closed += n

    def add_window_delta(self, kind: str, rows: int) -> None:
        """Delta rows shipped down by kind (upsert/close/resync/late/
        invalid — late and invalid count dropped rows, which never ship
        but must stay observable for the exactness story)."""
        if rows <= 0:
            return
        with self._lock:
            self.window_deltas[kind] = (
                self.window_deltas.get(kind, 0) + rows
            )

    def add_window_downlink(self, delta_bytes: int, full_bytes: int) -> None:
        """One windowed batch's downlink split: bytes the delta
        actually shipped vs what full-state per-record emission would
        have — numerator and denominator of the delta ratio."""
        with self._lock:
            self.window_delta_bytes += delta_bytes
            self.window_full_bytes += full_bytes

    def window_counts(self):
        """(closed, deltas-by-kind, delta_bytes, full_bytes) under ONE
        lock hold — bench and CLI read the family coherently."""
        with self._lock:
            return (
                self.windows_closed,
                dict(self.window_deltas),
                self.window_delta_bytes,
                self.window_full_bytes,
            )

    def record_breaker(self, name: str, state: str, transition: bool = True) -> None:
        if transition:
            self._event("breaker", f"{name}->{state}")
        with self._lock:
            # bounded: a broker that builds a chain (and breaker) per
            # stream must not grow this dict forever — keep the most
            # recently active 64 breakers (insertion order = recency
            # here because re-registration re-inserts)
            self.breaker_states.pop(name, None)
            self.breaker_states[name] = state
            while len(self.breaker_states) > 64:
                self.breaker_states.pop(next(iter(self.breaker_states)))
            if transition:
                self.breaker_transitions[state] = (
                    self.breaker_transitions.get(state, 0) + 1
                )

    def add_breaker_short_circuit(self) -> None:
        with self._lock:
            self.breaker_short_circuits += 1

    def add_interp_instance(self, seconds: float, records: int) -> None:
        with self._lock:
            self.interp_calls += 1
            self.interp_seconds += seconds
            self.interp_records += records

    # -- compile telemetry ---------------------------------------------------

    def add_compile(
        self,
        kind: str,
        signature: str,
        seconds: float,
        persistent_hit: Optional[bool] = None,
    ) -> None:
        """One native library build: ``kind`` names the compiler
        (``nvcc`` / ``g++``), ``signature`` the library, ``persistent_hit``
        whether the library was found built in its ``_build/`` directory
        (True), built now (False) or unknown (None)."""
        storm = False
        with self._lock:
            self.compiles[kind] = self.compiles.get(kind, 0) + 1
            self.compile_seconds[kind] = (
                self.compile_seconds.get(kind, 0.0) + seconds
            )
            self.compile_hist.record(seconds)
            if persistent_hit is not None:
                if persistent_hit:
                    self.persistent_cache_hits += 1
                else:
                    self.persistent_cache_misses += 1
            now = time.perf_counter()
            cutoff = now - self.config.compile_storm_window_s
            self._compile_times = [
                t for t in self._compile_times if t >= cutoff
            ]
            self._compile_times.append(now)
            if len(self._compile_times) > self.config.compile_storm_n:
                self.declines["recompile-storm"] = (
                    self.declines.get("recompile-storm", 0) + 1
                )
                storm = True
        pc = (
            ""
            if persistent_hit is None
            else (" pc=hit" if persistent_hit else " pc=miss")
        )
        self._event("compile", f"{kind} {signature} {seconds:.3f}s{pc}")
        if storm:
            self._event("recompile-storm", kind)

    def add_jit_hit(self) -> None:
        """Trace-cache hit on a jit entry point. The port has no jit, so
        no seam calls this; it stays for the family's shape (unlocked,
        as a per-batch monitoring counter would be)."""
        self.jit_cache_hits += 1

    def compile_totals(self) -> dict:
        """Monotone compile counters for differs (the bench wraps a
        timed run in two of these to attribute compile-vs-execute)."""
        with self._lock:
            return {
                "compiles": sum(self.compiles.values()),
                "by_kind": dict(self.compiles),
                "seconds": round(sum(self.compile_seconds.values()), 6),
                "persistent_hits": self.persistent_cache_hits,
                "persistent_misses": self.persistent_cache_misses,
                "jit_cache_hits": self.jit_cache_hits,
            }

    # -- gauges --------------------------------------------------------------

    def gauge_add(self, name: str, delta: float) -> None:
        """Move a gauge by ``delta`` (up at dispatch, down at finish).
        No-op when capture is off — the disabled contract is zero cost,
        and a half-tracked gauge would read as a leak."""
        if not self.enabled or delta == 0:
            return
        with self._lock:
            self.gauges[name] = self.gauges.get(name, 0) + delta

    def gauge_set(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def gauge_value(self, name: str) -> float:
        with self._lock:
            return self.gauges.get(name, 0)

    # -- reads ---------------------------------------------------------------

    def phase_totals(self) -> Dict[str, tuple]:
        """{phase: (count, total_seconds)} — the bench's per-phase
        breakdown diffs two of these around a timed pass."""
        with self._lock:
            return {
                p: (h.count, h.sum) for p, h in self.phase_hist.items()
            }

    def batch_hist_copy(self, path: str = "fused") -> LatencyHistogram:
        with self._lock:
            return self.batch_latency[path].copy()

    def chain_hist_copies(self) -> Dict[str, LatencyHistogram]:
        """{chain signature: e2e histogram copy} under one lock hold."""
        with self._lock:
            return {c: h.copy() for c, h in self.chain_latency.items()}

    def timeseries_sample(self) -> dict:
        """ONE-lock cumulative capture for the rolling-window layer
        (telemetry/timeseries.py): histogram copies + the monotone
        counters the SLO rules window, + point-in-time gauges. All
        fields come from the same instant, so window deltas cannot tear
        across families."""
        with self._lock:
            return {
                "generation": self._generation,
                "chains": {
                    c: h.copy() for c, h in self.chain_latency.items()
                },
                "paths": {
                    p: h.copy() for p, h in self.batch_latency.items()
                },
                "compile_hist": self.compile_hist.copy(),
                "counters": {
                    "spills": sum(self.spills.values()),
                    "retries": sum(self.retries.values()),
                    "quarantined": self.quarantined,
                    "compiles": sum(self.compiles.values()),
                    "compile_seconds": sum(self.compile_seconds.values()),
                    "recompile_storms": self.declines.get(
                        "recompile-storm", 0
                    ),
                    "breaker_short_circuits": self.breaker_short_circuits,
                    "rebalance_moves": sum(self.rebalance_moves.values()),
                },
                "gauges": dict(self.gauges),
                # streaming-lag families: point-in-time lag per
                # chain@topic/partition, monotone served counters, and
                # the record-age histograms (the consumer_lag /
                # record_age_p99 SLO rules window these)
                "lag": dict(self.consumer_lag),
                "served": dict(self.served_records),
                "record_age": {
                    k: h.copy() for k, h in self.record_age.items()
                },
                # per-tenant accounting plane (soak scorer + SLO layer
                # window these like the lag families above)
                "tenants": {
                    "served": dict(self.tenant_served),
                    "shed": dict(self.tenant_shed),
                    "held": dict(self.tenant_held),
                    "age": {
                        k: h.copy() for k, h in self.tenant_age.items()
                    },
                },
                "migration_hist": self.migration_hist.copy(),
            }

    def path_records(self) -> Dict[str, int]:
        """{path: records} — the bench diffs two of these around a timed
        run to report the path each config ACTUALLY executed on."""
        with self._lock:
            return dict(self.batch_records)

    def snapshot(self) -> dict:
        """The ONE snapshot shape every export surface renders from
        (monitoring JSON, Prometheus text, CLI table) — they must not
        drift apart, so they all start here."""
        with self._lock:
            doc = {
                "enabled": self.enabled,
                "batches": {
                    path: dict(h.to_dict(), records=self.batch_records.get(path, 0))
                    for path, h in self.batch_latency.items()
                },
                "phases": {
                    p: h.to_dict()
                    for p, h in self.phase_hist.items()
                    if h.count
                },
                "chains": {
                    c: h.to_dict()
                    for c, h in self.chain_latency.items()
                    if h.count
                },
                "counters": {
                    "heals": self.heals,
                    "stripe_fallbacks": self.stripe_fallbacks,
                    "spills": dict(self.spills),
                    "declines": dict(self.declines),
                    "link_variants": dict(self.link_variants),
                    "retries": dict(self.retries),
                    "quarantined": self.quarantined,
                    "sharded_inline_compress_shards": (
                        self.sharded_compress_shards
                    ),
                    "slo_breaches": dict(self.slo_breaches),
                    "admission": dict(self.admission),
                    "rebalance_moves": dict(self.rebalance_moves),
                    "breaker": {
                        "states": dict(self.breaker_states),
                        "transitions": dict(self.breaker_transitions),
                        "short_circuits": self.breaker_short_circuits,
                    },
                    "interp_instance": {
                        "calls": self.interp_calls,
                        "seconds": round(self.interp_seconds, 6),
                        "records": self.interp_records,
                    },
                },
                "compile": {
                    "by_kind": dict(self.compiles),
                    "seconds_by_kind": {
                        k: round(s, 6)
                        for k, s in self.compile_seconds.items()
                    },
                    "latency": self.compile_hist.to_dict(),
                    "persistent_cache_hits": self.persistent_cache_hits,
                    "persistent_cache_misses": self.persistent_cache_misses,
                    "jit_cache_hits": self.jit_cache_hits,
                },
                "gauges": dict(self.gauges),
                "slices": {
                    p: h.to_dict()
                    for p, h in self.slice_hist.items()
                    if h.count
                },
                "lag": {
                    "consumer_lag": dict(self.consumer_lag),
                    "served_records": dict(self.served_records),
                    "record_age": {
                        k: h.to_dict()
                        for k, h in self.record_age.items()
                        if h.count
                    },
                },
                "tenants": {
                    "served": dict(self.tenant_served),
                    "shed": dict(self.tenant_shed),
                    "held": dict(self.tenant_held),
                    "age": {
                        k: h.to_dict()
                        for k, h in self.tenant_age.items()
                        if h.count
                    },
                },
                "rebalance": {
                    "moves": dict(self.rebalance_moves),
                    "migration_seconds": self.migration_hist.to_dict(),
                },
                "windows": {
                    "closed": self.windows_closed,
                    "deltas": dict(self.window_deltas),
                    "delta_bytes": self.window_delta_bytes,
                    "full_bytes": self.window_full_bytes,
                },
            }
            leaks = dict(self.memory_leaks)
        # ledger section joins OUTSIDE the registry lock: the ledger
        # has its own lock (telemetry.memory) and the registry lock is
        # not re-entrant — holding both here would pin a lock order
        # the acquire seams then have to honor forever
        return doc | self._memory_stats(leaks) | self._ring_stats()

    def _memory_stats(self, leaks: Dict[str, int]) -> dict:
        """Device-memory ledger section — peek() never creates an
        engine just for a snapshot."""
        from fluvio_tpu_torch.telemetry import memory as memory_mod

        eng = memory_mod.peek()
        if eng is None:
            return {"memory": {"owners": {}, "total_bytes": 0,
                               "peak_bytes": 0, "leaks": leaks}}
        return {
            "memory": {
                "owners": {
                    o: b for o, b in eng.owner_bytes().items() if b
                },
                "total_bytes": eng.total_bytes(),
                "peak_bytes": eng.peak_bytes(),
                "leaks": leaks,
            }
        }

    def _ring_stats(self) -> dict:
        """Span/event/flow ring bookkeeping, each triple read under ONE
        ring lock acquisition so total == retained + dropped holds even
        while a concurrent end_batch pushes mid-snapshot."""
        spans_total, spans_retained, spans_dropped = self.spans.stats()
        events_total, _, events_dropped = self.events.stats()
        flows_total, _, flows_dropped = self.flows.stats()
        return {
            "spans_retained": spans_retained,
            "spans_total": spans_total,
            "spans_dropped": spans_dropped,
            "events_total": events_total,
            "events_dropped": events_dropped,
            "flows_total": flows_total,
            "flows_dropped": flows_dropped,
        }

    def spans_json(self, limit: Optional[int] = None) -> List[dict]:
        return [s.to_dict() for s in self.spans.recent(limit)]

    def reset(self) -> None:
        """Test/bench isolation helper — never called on the hot path."""
        with self._lock:
            self._generation += 1
            for h in self.batch_latency.values():
                h.__init__()
            for h in self.phase_hist.values():
                h.__init__()
            self.chain_latency = {}
            self.heals = 0
            self.stripe_fallbacks = 0
            self.spills = {}
            self.declines = {}
            self.link_variants = {}
            self.retries = {}
            self.quarantined = 0
            self.sharded_compress_shards = 0
            self.slo_breaches = {}
            self.admission = {}
            self.breaker_states = {}
            self.breaker_transitions = {}
            self.breaker_short_circuits = 0
            self.batch_records = {
                "fused": 0, "striped": 0, "interpreter": 0
            }
            self.interp_calls = 0
            self.interp_seconds = 0.0
            self.interp_records = 0
            self.compiles = {}
            self.compile_seconds = {}
            self.compile_hist = LatencyHistogram()
            self.persistent_cache_hits = 0
            self.persistent_cache_misses = 0
            self.jit_cache_hits = 0
            self._compile_times = []
            self.gauges = {}
            for h in self.slice_hist.values():
                h.__init__()
            self.consumer_lag = {}
            self.served_records = {}
            self.record_age = {}
            self.tenant_served = {}
            self.tenant_shed = {}
            self.tenant_held = {}
            self.tenant_age = {}
            self.rebalance_moves = {}
            self.migration_hist = LatencyHistogram()
            self.windows_closed = 0
            self.window_deltas = {}
            self.window_delta_bytes = 0
            self.window_full_bytes = 0
            self.memory_leaks = {}
            self._flow_seq = 0
            # lag_sampler survives reset on purpose (and mem_sampler
            # with it, same rationale): the bench resets between
            # configs and the engines must keep sampling; tests drop
            # them via lag.reset_engine() / memory.reset_engine()
        self.spans = SpanRing(self.spans.capacity)
        self.events = EventRing(self.events.capacity)
        self.flows = FlowRing(self.flows.capacity)


TELEMETRY = PipelineTelemetry()
