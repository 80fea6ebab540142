"""The port's telemetry (`fluvio_tpu_torch.telemetry`) against the JAX
package's (`fluvio_tpu.telemetry`), module by module, on the CPU.

Each test drives both packages through the same call sequence on inputs
made from a numpy seed and compares what they record at tolerance 0:
the histograms, the span / event / flow rings, the registry's snapshot,
the Prometheus text (every sample and ``# TYPE`` line; the ``# HELP``
text of the build families differs on purpose), the Chrome trace, the
time-series windows and SLO verdicts, the memory ledger's documents with
its leak detection, the lag documents and the compile-storm detection.
Every clock the modules read is a fake one, one per package, stepping
identically, so even the wall-clock fields agree and are compared.

Both registries are process singletons: an autouse fixture resets each,
with its ledger, lag and SLO engines, around every test.

The port reads no environment variable: `TelemetryConfig` holds every
setting, and `test_config_defaults_are_the_jax_defaults` holds each
field's default to the JAX package's default for its variable.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

import fluvio_tpu.telemetry as ref_telemetry
import fluvio_tpu_torch.telemetry as port_telemetry
from fluvio_tpu.analysis import envreg
from fluvio_tpu.telemetry import compiles as ref_compiles
from fluvio_tpu.telemetry import flow as ref_flow
from fluvio_tpu.telemetry import histogram as ref_histogram
from fluvio_tpu.telemetry import lag as ref_lag
from fluvio_tpu.telemetry import memory as ref_memory
from fluvio_tpu.telemetry import prometheus as ref_prometheus
from fluvio_tpu.telemetry import registry as ref_registry
from fluvio_tpu.telemetry import slo as ref_slo
from fluvio_tpu.telemetry import spans as ref_spans
from fluvio_tpu.telemetry import timeseries as ref_timeseries
from fluvio_tpu.telemetry import trace as ref_trace
from fluvio_tpu_torch.telemetry import compiles as port_compiles
from fluvio_tpu_torch.telemetry import flow as port_flow
from fluvio_tpu_torch.telemetry import histogram as port_histogram
from fluvio_tpu_torch.telemetry import lag as port_lag
from fluvio_tpu_torch.telemetry import memory as port_memory
from fluvio_tpu_torch.telemetry import prometheus as port_prometheus
from fluvio_tpu_torch.telemetry import registry as port_registry
from fluvio_tpu_torch.telemetry import slo as port_slo
from fluvio_tpu_torch.telemetry import spans as port_spans
from fluvio_tpu_torch.telemetry import timeseries as port_timeseries
from fluvio_tpu_torch.telemetry import trace as port_trace
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

REF = SimpleNamespace(
    pkg=ref_telemetry, histogram=ref_histogram, spans=ref_spans, flow=ref_flow,
    registry=ref_registry, prometheus=ref_prometheus, trace=ref_trace,
    timeseries=ref_timeseries, slo=ref_slo, memory=ref_memory, lag=ref_lag,
    T=ref_registry.TELEMETRY,
)
PORT = SimpleNamespace(
    pkg=port_telemetry, histogram=port_histogram, spans=port_spans, flow=port_flow,
    registry=port_registry, prometheus=port_prometheus, trace=port_trace,
    timeseries=port_timeseries, slo=port_slo, memory=port_memory, lag=port_lag,
    T=port_registry.TELEMETRY,
)
BOTH = (REF, PORT)


class FakeClock:
    """Stands in for the ``time`` module (and a module's injected clock):
    every read advances by ``step``, so two packages that read their
    clocks in the same order read the same values."""

    def __init__(self, t: float = 1000.0, step: float = 0.00125):
        self.t = t
        self.step = step

    def read(self) -> float:
        self.t += self.step
        return self.t

    perf_counter = monotonic = time = __call__ = read

    def advance(self, seconds: float) -> None:
        self.t += seconds

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def _reset(ns) -> None:
    ns.T.reset()
    # `reset` keeps every path key a span ever added (windowed, sharded):
    # drop those past the fixed vocabulary, so both registries start from
    # the same families whatever ran before on this worker
    for family in (ns.T.batch_latency, ns.T.batch_records):
        for path in [p for p in family if p not in ("fused", "striped", "interpreter")]:
            del family[path]
    ns.lag.reset_engine()
    ns.memory.reset_engine()
    ns.slo.reset_engine()
    ns.T.trace_sink = None


@pytest.fixture(autouse=True)
def _fresh_registries():
    for ns in BOTH:
        _reset(ns)
    yield
    for ns in BOTH:
        _reset(ns)


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock a package, patched into every module that reads the
    ``time`` module, and installed as the ledger's and SLO engine's."""
    out = []
    for ns in BOTH:
        clock = FakeClock()
        for mod in (ns.spans, ns.flow, ns.registry, ns.lag, ns.trace):
            monkeypatch.setattr(mod, "time", clock)
        ledger = ns.memory.MemoryLedger(clock=clock)
        ns.memory._ENGINE = ledger
        ns.T.mem_sampler = ledger.sample
        ns.slo._ENGINE = ns.slo.SloEngine(clock=clock, profile_dir="")
        out.append(clock)
    return out


def _both(fn):
    """fn(ns) on each package: (reference's result, port's result)."""
    return tuple(fn(ns) for ns in BOTH)


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def _seconds(seed: int, kind: str, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(mean=-7.0, sigma=2.0, size=n)
    if kind == "uniform":
        return rng.uniform(0.0, 2.0, size=n)
    # edges: zero, negative (clamped), underflow, bounds, overflow
    bounds = np.array(ref_histogram.BUCKET_BOUNDS)
    return np.concatenate([[0.0, -1.0, 1e-9, 500.0, 1e6], bounds, bounds * (1 + 1e-12),
                           rng.choice(bounds, size=64)])


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "edges"])
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_equals_reference(seed, kind):
    assert port_histogram.BUCKET_BOUNDS == ref_histogram.BUCKET_BOUNDS
    assert port_histogram.N_BUCKETS == ref_histogram.N_BUCKETS
    values = _seconds(seed, kind)
    half = len(values) // 2

    def run(ns):
        a, b = ns.histogram.LatencyHistogram(), ns.histogram.LatencyHistogram()
        for v in values[:half]:
            a.record(float(v))
        snap = a.copy()
        for v in values[half:]:
            b.record(float(v))
        a.merge(b)
        d = a.diff(snap)
        pct = [a.percentile(p) for p in (0, 1, 10, 50, 90, 99, 99.9, 100)]
        return (a.counts, a.count, a.sum, a.min, a.max, a.mean(), pct, a.to_dict(),
                a.cumulative_buckets(), d.counts, d.count, d.sum, d.to_dict(),
                ns.histogram.LatencyHistogram().to_dict())

    ref, port = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# span / event / flow rings
# ---------------------------------------------------------------------------

def _ring_sequence(ns, seed: int):
    rng = np.random.default_rng(seed)
    spans = ns.spans.SpanRing(capacity=8)
    events = ns.spans.EventRing(capacity=5)
    flows = ns.flow.FlowRing(capacity=6)
    phases = ns.spans.PHASES
    for i in range(12):
        span = ns.spans.BatchSpan(path=("fused", "striped")[i % 2], chain=f"c{i % 3}")
        for k in rng.choice(len(phases), size=3, replace=False):
            span.add(phases[int(k)], float(rng.uniform(1e-5, 1e-2)))
        span.add("stage", 0.0)  # no time: no phase
        span.mark_dispatched()
        span.mark_device_ready()
        span.mark_device_ready()  # a second sync adds nothing
        span.records = int(rng.integers(0, 1000))
        span.t_end = span.t0 + float(rng.uniform(0.01, 0.1))
        spans.push(span)
        events.push(ns.spans.InstantEvent(("heal", "spill", "compile")[i % 3], f"d{i}"))
        flow = ns.flow.SliceFlow(i + 1, chain=f"c{i % 3}@t/0", tenant=("acme", "")[i % 2])
        flow.note_queue()
        flow.end_queue()
        if i % 3 == 0:
            flow.hold(float(rng.uniform(1e-4, 1e-3)))
            flow.note_batcher()
            flow.end_batcher("batch-full", 3)
        flow.decision = "admit"
        flow.mark_dispatch()
        flow.close(records=int(rng.integers(0, 500)))
        flows.push(flow)
    return {
        "spans": [s.to_dict() for s in spans.recent()],
        "spans_limited": [s.to_dict() for s in spans.recent(3)],
        "events": [e.to_dict() for e in events.recent()],
        "flows": [f.to_dict() for f in flows.recent()],
        "flow_totals": [f.phase_totals() for f in flows.recent()],
        "stats": [r.stats() for r in (spans, events, flows)],
        "lens": [(len(r), r.total, r.dropped) for r in (spans, events, flows)],
        "phase": [s.phase("device") for s in spans.recent()],
    }


@pytest.mark.parametrize("seed", [3, 4])
def test_span_and_flow_rings_equal_reference(clocks, seed):
    assert port_spans.PHASES == ref_spans.PHASES
    assert port_flow.SLICE_PHASES == ref_flow.SLICE_PHASES
    ref, port = _both(lambda ns: _ring_sequence(ns, seed))
    assert port == ref
    with pytest.raises(ValueError):
        port_spans.SpanRing(0)


# ---------------------------------------------------------------------------
# the registry: one scripted sequence of every seam
# ---------------------------------------------------------------------------

def _registry_sequence(ns, seed: int) -> None:
    """Every add_* / gauge_* / mem_* / span / flow / lag seam of the
    registry, driven from one seed."""
    rng = np.random.default_rng(seed)
    T = ns.T
    phases = ns.spans.PHASES
    for i in range(40):
        path = ("fused", "striped", "interpreter", "windowed")[i % 4]
        span = T.begin_batch(path, chain=("filter+map", "aggregate", "")[i % 3])
        for k in rng.choice(len(phases), size=4, replace=False):
            span.add(phases[int(k)], float(rng.uniform(1e-5, 5e-2)))
        span.mark_dispatched()
        span.mark_device_ready()
        T.end_batch(span, records=int(rng.integers(1, 5000)))
        T.add_phase("stage", float(rng.uniform(0, 1e-3)))
        T.add_phase("glz_decode", 0.0)
        T.add_decline(("record-too-wide", "glz-ratio", "staging-cap")[i % 3])
        T.add_link_variant(("raw", "down-packed")[i % 2])
        if i % 5 == 0:
            T.add_heal()
            T.add_stripe_fallback()
            T.add_spill(("transform-error", "fused-error")[i % 2])
            T.add_retry("fetch")
            T.add_quarantine()
            T.add_sharded_compress(2)
            T.add_admission("admit")
            T.record_breaker(f"b{i % 2}", ("open", "closed")[i % 2])
            T.add_breaker_short_circuit()
            T.add_interp_instance(float(rng.uniform(0, 1e-3)), 7)
            T.add_slo_breach(f"c/{i}")
            T.add_memory_leak("staged_batch")
        T.gauge_add("live_batch_handles", 1)
        T.gauge_add("inflight_queue_depth", int(rng.integers(0, 4)))
        T.gauge_set("warmed_buckets", i)
        T.mem_acquire(("staged_batch", "glz_tokens", "carry_bank")[i % 3], ("k", i),
                      int(rng.integers(1, 1 << 20)))
        if i % 2:
            T.mem_release(("k", i - 1))
        flow = T.begin_flow(f"sig@t{i % 2}.s/0", ("acme", "beta", "")[i % 3])
        flow.decision = "admit"
        flow.mark_dispatch()
        T.add_slice_phase("hold", float(rng.uniform(0, 1e-3)))
        T.end_flow(flow, records=int(rng.integers(0, 100)))
        key = f"sig@t{i % 2}.s/0"
        T.set_consumer_lag(key, float(rng.integers(0, 100)))
        T.add_served(key, int(rng.integers(1, 100)))
        T.add_record_age(key, float(rng.uniform(0, 3)))
        T.add_tenant_served(("acme", "beta")[i % 2], 5)
        T.add_tenant_shed("acme")
        T.add_tenant_held("beta")
        T.add_tenant_age("acme", float(rng.uniform(0, 1)))
        T.add_rebalance_move(("lag", "split")[i % 2], "t/0:0->1")
        T.add_migration_seconds(float(rng.uniform(0, 0.2)))
        T.add_windows_closed(int(rng.integers(0, 3)))
        T.add_window_delta(("upsert", "close", "late")[i % 3], int(rng.integers(0, 9)))
        T.add_window_downlink(int(rng.integers(0, 999)), 4096)
        T.add_compile(("nvcc", "g++")[i % 2], f"lib{i}", float(rng.uniform(0, 2)),
                      persistent_hit=(None, True, False)[i % 3])
    T.gauge_add("live_batch_handles", -40)
    T.clear_consumer_lag("sig@t1.s/0")


def _registry_reads(ns) -> dict:
    T = ns.T
    return {
        "snapshot": T.snapshot(),
        "spans": T.spans_json(),
        "events": T.events_json(),
        "flows": T.flows_json(),
        "phase_totals": T.phase_totals(),
        "path_records": T.path_records(),
        "compile_totals": T.compile_totals(),
        "link_variants": T.link_variant_counts(),
        "window_counts": T.window_counts(),
        "leaks": T.memory_leak_counts(),
        "gauge": T.gauge_value("inflight_queue_depth"),
        "lag_families": [
            {k: v if not hasattr(v, "to_dict") else {kk: h.to_dict() for kk, h in v.items()}
             for k, v in enumerate(T.lag_families()[:2])},
            {k: h.to_dict() for k, h in T.lag_families()[2].items()},
        ],
        "tenant_families": [dict(x) for x in T.tenant_families()[:3]]
        + [{k: h.to_dict() for k, h in T.tenant_families()[3].items()}],
        "rebalance": [T.rebalance_families()[0], T.rebalance_families()[1].to_dict()],
        "hists": {p: T.batch_hist_copy(p).to_dict() for p in ("fused", "striped")},
        "chain_hists": {c: h.to_dict() for c, h in T.chain_hist_copies().items()},
    }


@pytest.mark.parametrize("seed", [5, 6])
def test_registry_snapshot_equals_reference(clocks, seed):
    def run(ns):
        _registry_sequence(ns, seed)
        return _registry_reads(ns)

    ref, port = _both(run)
    assert port == ref
    assert port["snapshot"]["memory"]["total_bytes"] > 0


def test_registry_disabled_records_no_spans(clocks):
    """With capture off, the seams return None and record nothing but the
    always-on counters."""
    for ns in BOTH:
        ns.T.enabled = False
    try:
        def run(ns):
            T = ns.T
            assert T.begin_batch() is None and T.begin_flow() is None
            T.end_batch(None)
            T.end_flow(None)
            T.gauge_add("live_batch_handles", 1)
            T.mem_acquire("staged_batch", "k", 100)
            T.add_decline("staging-cap")
            T.add_windows_closed(2)
            return T.snapshot()

        ref, port = _both(run)
        assert port == ref
        assert port["gauges"] == {} and port["counters"]["declines"] == {"staging-cap": 1}
    finally:
        for ns in BOTH:
            ns.T.enabled = True


# ---------------------------------------------------------------------------
# Prometheus text and the Chrome trace of the same registry state
# ---------------------------------------------------------------------------

SPU_METRICS = {
    "inbound": {"records": 120, "bytes": 9000},
    "outbound": {"records": 60, "bytes": 4000},
    "smartmodule": {"bytes_in": 9000, "records_out": 60, "invocation_count": 3,
                    "fuel_used": 240, "fastpath_slices": 3, "fallback_slices": 1,
                    "fallback_reasons": {"staging-cap": 1}},
}


def _samples(text: str):
    """Every line but the ``# HELP`` ones (help text may differ)."""
    return [line for line in text.splitlines() if not line.startswith("# HELP ")]


@pytest.mark.parametrize("spu", [False, True])
def test_prometheus_text_equals_reference(clocks, spu):
    def run(ns):
        _registry_sequence(ns, 7)
        return ns.prometheus.render_prometheus(spu_metrics=SPU_METRICS if spu else None)

    ref, port = _both(run)
    assert _samples(port) == _samples(ref)
    families = [line.split()[2] for line in _samples(port) if line.startswith("# TYPE ")]
    assert "fluvio_tpu_device_memory_bytes" in families
    assert "fluvio_tpu_slo_verdict" in families
    assert ("fluvio_tpu_spu_inbound_records_total" in families) == spu
    # the help text differs only for the build families and the leak counter
    helps = [{line.split()[2]: line for line in text.splitlines() if line.startswith("# HELP ")}
             for text in (ref, port)]
    assert helps[0].keys() == helps[1].keys()
    differ = {k for k in helps[0] if helps[0][k] != helps[1][k]}
    assert differ == {
        "fluvio_tpu_compiles_total", "fluvio_tpu_compile_seconds_total",
        "fluvio_tpu_compile_latency_seconds", "fluvio_tpu_persistent_cache_hits_total",
        "fluvio_tpu_persistent_cache_misses_total", "fluvio_tpu_jit_cache_hits_total",
        "fluvio_tpu_memory_leaks_total"} | ({"fluvio_tpu_smartmodule_fastpath_slices_total"}
                                           if spu else set())


def test_trace_json_equals_reference(clocks):
    def run(ns):
        _registry_sequence(ns, 8)
        T = ns.T
        extra = ns.spans.BatchSpan("fused", "filter+map")
        extra.add("dispatch", 0.002)
        return {
            "doc": json.loads(ns.trace.trace_json()),
            "render": ns.trace.render_trace(),
            "build": ns.trace.build_trace(T.spans.recent() + [extra], T.events.recent(),
                                          T.flows.recent()),
            "empty": ns.trace.build_trace([]),
        }

    ref, port = _both(run)
    assert port == ref
    kinds = {e["ph"] for e in port["doc"]["traceEvents"]}
    assert {"X", "i", "M", "s", "f"} <= kinds


def test_trace_file_sink_equals_reference(clocks, tmp_path):
    """The continuous sink (armed by config in the port, by FLUVIO_TRACE in
    the JAX package) writes the same valid JSON file."""
    paths = []
    for ns, name in zip(BOTH, ("ref.json", "port.json")):
        path = tmp_path / name
        sink = ns.trace.TraceFileSink(str(path), 1 << 20)
        ns.T.trace_sink = sink
        _registry_sequence(ns, 9)
        sink.close()
        paths.append(path)
    ref, port = (json.loads(p.read_text()) for p in paths)
    assert port == ref and len(port) > 100


def test_configure_arms_and_disarms_the_trace_sink(tmp_path):
    path = tmp_path / "t.json"
    try:
        port_telemetry.configure(port_telemetry.TelemetryConfig(trace_path=str(path)))
        sink = PORT.T.trace_sink
        assert isinstance(sink, port_trace.TraceFileSink) and sink.path == str(path)
        span = PORT.T.begin_batch(chain="c")
        span.add("stage", 0.001)
        PORT.T.end_batch(span, records=3)
        port_telemetry.configure(port_telemetry.TelemetryConfig())
        assert PORT.T.trace_sink is None
        doc = json.loads(path.read_text())
        assert any(e.get("name") == "batch[3]" for e in doc)
        port_telemetry.configure(port_telemetry.TelemetryConfig(enabled=False,
                                                                trace_path=str(path)))
        assert PORT.T.trace_sink is None and not PORT.T.enabled
    finally:
        port_telemetry.configure(port_telemetry.TelemetryConfig())


# ---------------------------------------------------------------------------
# time series and SLO verdicts under an injected clock
# ---------------------------------------------------------------------------

def _slo_sequence(ns, clock, seed: int):
    rng = np.random.default_rng(seed)
    T = ns.T
    rules = ns.slo.parse_slo_spec("e2e_p99:target_ms=5;queue_depth:target=3;"
                                  "spill_ratio:target=0.1,warn=0.5;consumer_lag:target=10")
    eng = ns.slo.SloEngine(clock=clock, rules=rules, profile_dir="")
    docs = []
    for w in range(14):
        slow = 4 <= w < 8
        for _ in range(int(rng.integers(2, 6))):
            span = T.begin_batch(chain=("filter+map", "aggregate")[w % 2])
            span.add("dispatch", 0.001)
            if slow:
                clock.advance(0.02)  # a slow batch: past the p99 target
            T.end_batch(span, records=100)
        if w % 3 == 0:
            T.add_spill("transform-error")
        T.gauge_set("inflight_queue_depth", 5 if slow else 1)
        T.set_consumer_lag("sig@t/0", 50.0 if 6 <= w < 9 else 0.0)
        clock.advance(10.0)
        docs.append(eng.evaluate())
    ts = ns.timeseries.TimeSeries(T, window_s=10.0, capacity=3, clock=clock)
    ts.maybe_tick()
    clock.advance(25.0)
    ts.maybe_tick()
    ts.force_tick()
    d = ts.delta(2)
    return {"docs": docs, "breaches": dict(T.slo_breaches), "events": T.events_json(),
            "summary": d.summary(), "batches": d.batches(), "retained": ts.retained_windows(),
            "summarize": ns.slo.summarize(docs[7]), "rules": [r.__dict__ for r in rules]}


@pytest.mark.parametrize("seed", [10, 11])
def test_slo_verdicts_equal_reference(clocks, seed):
    ref, port = (_slo_sequence(ns, clock, seed) for ns, clock in zip(BOTH, clocks))
    assert port == ref
    verdicts = [d["verdict"] for d in port["docs"]]
    assert "breach" in verdicts and verdicts[-1] in ("ok", "warn")
    assert port["breaches"]


def test_slo_rules_from_config_equal_reference(monkeypatch):
    specs = ["", "e2e_p99:target_ms=250;queue_depth:target=16;spill_ratio:off=1",
             "hbm_headroom:target=5", "bogus:target=1"]
    for spec in specs:
        for budget in (0, 1 << 30):
            monkeypatch.setenv("FLUVIO_SLO", spec)
            monkeypatch.setenv("FLUVIO_MEM_BUDGET", str(budget))
            cfg = port_telemetry.TelemetryConfig(slo=spec, mem_budget=budget)
            assert port_slo.rules_from_config(cfg) == tuple(
                port_slo.SloRule(**r.__dict__) for r in ref_slo.rules_from_env())
    with pytest.raises(ValueError):
        port_slo.parse_slo_spec("e2e_p99:nope=1")


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------

def _memory_sequence(ns, clock, seed: int):
    rng = np.random.default_rng(seed)
    T = ns.T
    led = ns.memory.engine()
    docs = []
    for i in range(30):
        owner = ns.memory.OWNERS[i % len(ns.memory.OWNERS)]
        T.mem_acquire(owner, ("e", i), int(rng.integers(1, 1 << 16)))
        if i % 4 == 1:
            T.mem_release(("e", i - 1))
        if i % 7 == 0:
            T.mem_acquire(owner, ("e", i), 64)  # a resize
        clock.advance(float(rng.uniform(0, 30)))
        if i % 10 == 9:
            docs.append(ns.memory.memory_snapshot())
    ns.memory.note_window_bank(1, 4096)
    ns.memory.note_window_bank(1, 2048)
    flagged = [(o, k, b) for o, k, b, _ in led.scan()]
    led.reset_peak()
    try:
        led.assert_drained()
        drained = True
    except AssertionError:
        drained = False
    T.refresh_memory()
    out = {"docs": docs, "flagged": flagged, "drained": drained,
           "owners": led.owner_bytes(), "entries": led.owner_entries(),
           "leaked": led.leaked_entries(), "peak": led.peak_bytes(),
           "config_peak": led.config_peak_bytes(), "bench": ns.memory.bench_block(),
           "reconcile": led.reconcile(), "last": led.last_reconcile(),
           "snapshot": T.snapshot()["memory"], "gauges": T.snapshot()["gauges"]}
    for key in list(led._entries):
        led.release(key)
    led.assert_drained()
    out["after"] = ns.memory.memory_snapshot()
    return out


@pytest.mark.parametrize("seed", [12, 13])
def test_memory_ledger_equals_reference(clocks, seed):
    ref, port = (_memory_sequence(ns, clock, seed) for ns, clock in zip(BOTH, clocks))
    assert port == ref
    # the snapshots' scans flagged the transient entries past the TTL
    assert port["leaked"] and port["snapshot"]["leaks"] and not port["drained"]
    assert port["reconcile"] == {"ledger_bytes": port["reconcile"]["ledger_bytes"],
                                 "backend": "unavailable"}
    with pytest.raises(ValueError):
        port_memory.engine().acquire("nobody", "k", 1)


def test_reconcile_reads_the_allocator_under_the_ledger_lock(clocks, monkeypatch):
    """On a card the allocator's live bytes and the ledger's total are one
    instant's (the ledger's lock held across both reads), and a failed
    read raises. The allocator is a stand-in here: the test holds the
    locking, not the card."""
    import torch

    led = port_memory.engine()
    PORT.T.mem_acquire("staged_batch", ("batch", 1), 1024)
    monkeypatch.setattr(PORT.T, "device", torch.device("cuda", 0))
    held = []

    def memory_stats(device):
        held.append((device, led._lock.locked()))
        return {port_memory.BACKEND_STAT: 5000}

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    # before CUDA's lazy init the allocator holds nothing and is not asked
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert led.reconcile() == {"ledger_bytes": 1024, "backend_bytes": 0,
                               "unaccounted_bytes": -1024}
    assert held == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert led.reconcile() == {"ledger_bytes": 1024, "backend_bytes": 5000,
                               "unaccounted_bytes": 3976}
    assert held == [(torch.device("cuda", 0), True)]
    assert led.last_reconcile()["backend_bytes"] == 5000

    def unreadable(device):
        raise RuntimeError("no allocator")

    monkeypatch.setattr(torch.cuda, "memory_stats", unreadable)
    with pytest.raises(RuntimeError, match="no allocator"):
        led.reconcile()


def test_batch_booking_retires_before_its_uploads_drop(clocks):
    """`GpuChainExecutor._unbook` releases the ledger's booking first and
    drops the staged uploads after, so a reconcile never finds bytes
    booked that the allocator has freed."""
    import torch

    from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor, _Fetch

    seen = []

    class Upload:
        def __del__(self):
            seen.append(port_memory.engine().owner_bytes()["staged_batch"])

    handle = _Fetch(torch.device("cpu"), None, 0)
    GpuChainExecutor._book(SimpleNamespace(_glz_last_h2d=0), handle, 4096)
    handle.staged = [Upload()]
    assert port_memory.engine().owner_bytes()["staged_batch"] == 4096
    GpuChainExecutor._unbook(handle)
    assert seen == [0] and handle.staged == [] and not handle.booked
    GpuChainExecutor._unbook(handle)  # a discard after the finish
    port_memory.engine().assert_drained()


def test_slo_capture_on_the_cpu_records_one_trace(tmp_path):
    """A breach capture on a CPU engine: one `torch.profiler` capture of
    CPU activity, its Chrome trace in the breach directory."""
    eng = port_slo.SloEngine(profile_dir=str(tmp_path))
    eng.profile_dwell_ms = 0.0
    path = str(tmp_path / "slo_breach_001")
    assert eng._capture(path, "test", None) is True
    doc = json.loads((tmp_path / "slo_breach_001" / port_slo.PROFILE_TRACE).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    assert events and port_slo.trace_kernel_events(
        str(tmp_path / "slo_breach_001" / port_slo.PROFILE_TRACE)) == 0


@pytest.mark.parametrize("empty", [0, 1, 2, 3])
def test_slo_capture_on_a_card_retakes_a_trace_without_kernels(tmp_path, monkeypatch, empty):
    """On a card a capture whose trace holds no CUDA kernel is taken
    again, up to `CAPTURE_ATTEMPTS` captures; then the capture raises.
    The profiler is a stand-in whose first ``empty`` traces hold none."""
    import torch
    import torch.profiler

    exports = []

    class FakeProfile:
        def __init__(self, activities):
            assert torch.profiler.ProfilerActivity.CUDA in activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            kernel = [] if len(exports) < empty else [{"cat": "kernel", "name": "k"}]
            exports.append(path)
            with open(path, "w") as f:
                json.dump({"traceEvents": [{"cat": "cpu_op", "name": "op"}, *kernel]}, f)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(port_slo, "_probe", lambda device: None)
    eng = port_slo.SloEngine(profile_dir=str(tmp_path))
    eng.profile_dwell_ms = 0.0
    path = str(tmp_path / "slo_breach_001")
    if empty < port_slo.CAPTURE_ATTEMPTS:
        assert eng._capture(path, "test", torch.device("cuda", 0)) is True
        assert len(exports) == empty + 1
    else:
        with pytest.raises(RuntimeError, match="recorded no CUDA kernel"):
            eng._capture(path, "test", torch.device("cuda", 0))
        assert len(exports) == port_slo.CAPTURE_ATTEMPTS
    kinds = [e.kind for e in PORT.T.events.recent()]
    assert kinds.count("slo-profile-empty") == min(empty, port_slo.CAPTURE_ATTEMPTS)


def test_memory_budget_breach_equals_reference(clocks, monkeypatch):
    monkeypatch.setenv("FLUVIO_MEM_BUDGET", "1000")
    port_telemetry.configure(port_telemetry.TelemetryConfig(mem_budget=1000))
    try:
        for ns, clock in zip(BOTH, clocks):
            ns.slo._ENGINE = ns.slo.SloEngine(clock=clock, profile_dir="")
        docs = _both(lambda ns: (ns.T.mem_acquire("carry_bank", "c", 5000),
                                 ns.memory.memory_snapshot())[1])
        assert docs[1] == docs[0] and docs[1]["verdict"] == "breach"
        assert docs[1]["budget_bytes"] == 1000
    finally:
        port_telemetry.configure(port_telemetry.TelemetryConfig())


# ---------------------------------------------------------------------------
# lag
# ---------------------------------------------------------------------------

class _Leader:
    def __init__(self, hw: int, leo=None):
        self._hw, self._leo = hw, leo

    def hw(self):
        return self._hw

    def leo(self):
        if self._leo is None:
            raise RuntimeError("torn down")
        return self._leo


@pytest.mark.parametrize("seed", [14, 15])
def test_lag_documents_equal_reference(clocks, seed):
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, 4)), int(rng.integers(0, 500)), int(rng.integers(1, 50)))
           for _ in range(40)]

    def run(ns):
        leaders = [_Leader(1000, 1200), _Leader(300), _Leader(0, 0), _Leader(700, 700)]
        keys = [f"filter+map@t{i}.s/0" for i in range(4)]
        for key, leader in zip(keys, leaders):
            ns.lag.track_stream(key, leader)
        out = []
        for k, off, n in ops:
            ns.lag.note_commit(keys[k], off)
            ns.lag.note_serve(keys[k], n, ns.lag.serve_age_s(1_000_000))
            ns.lag.note_serve(keys[k], 0, None)
        out.append(ns.lag.lag_snapshot())
        for key, leader in zip(keys, leaders):
            ns.lag.note_commit(key, leader.hw())
        out.append(ns.lag.lag_snapshot())
        ns.lag.engine().untrack(keys[0])
        out.append(ns.lag.engine().snapshot())
        out.append((ns.lag.serve_age_s(None), ns.lag.serve_age_s(-1)))
        out.append(ns.T.snapshot()["lag"])
        return out

    ref, port = _both(run)
    assert port == ref
    final = port[1]["partitions"]
    assert all(entry["lag"] == 0 for entry in final.values())


# ---------------------------------------------------------------------------
# compile events and storm detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gap_s", [0.5, 7.5, 61.0])
def test_compile_storm_detection_equals_reference(clocks, gap_s):
    def run(ns, clock):
        for i in range(14):
            ns.T.add_compile("nvcc", f"lib{i}", 0.25, persistent_hit=bool(i % 2))
            clock.advance(gap_s)
        return (ns.T.snapshot()["compile"], ns.T.snapshot()["counters"]["declines"],
                ns.T.events_json(), ns.T.compile_totals())

    ref, port = (run(ns, clock) for ns, clock in zip(BOTH, clocks))
    assert port == ref
    storms = port[1].get("recompile-storm", 0)
    assert (storms > 0) == (gap_s < 60.0 / 8)


def test_build_events_are_compile_events(clocks):
    """`note_build` is the port's compile event: one a library, cached as a
    persistent-cache hit, built as a miss."""
    port_compiles.note_build("nvcc", "json_span.cu", 12.5, cached=False)
    port_compiles.note_build("g++", "records.cpp", 0.01, cached=True)
    ref_registry.TELEMETRY.add_compile("nvcc", "json_span.cu built", 12.5, persistent_hit=False)
    ref_registry.TELEMETRY.add_compile("g++", "records.cpp cached", 0.01, persistent_hit=True)
    assert PORT.T.snapshot()["compile"] == REF.T.snapshot()["compile"]
    assert PORT.T.events_json() == REF.T.events_json()
    assert not hasattr(port_compiles, "instrument_jit") and hasattr(ref_compiles, "instrument_jit")


# ---------------------------------------------------------------------------
# configuration: the environment knobs as fields
# ---------------------------------------------------------------------------

CONFIG_ENV = {
    "enabled": ("FLUVIO_TELEMETRY", envreg.env_bool),
    "flow_trace": ("FLUVIO_FLOW_TRACE", envreg.env_bool),
    "slice_ring": ("FLUVIO_SLICE_RING", envreg.env_int),
    "compile_storm_n": ("FLUVIO_COMPILE_STORM_N", envreg.env_int),
    "compile_storm_window_s": ("FLUVIO_COMPILE_STORM_WINDOW_S", envreg.env_float),
    "tenant_cap": ("FLUVIO_SOAK_TENANT_CAP", envreg.env_int),
    "trace_path": ("FLUVIO_TRACE", envreg.env_raw),
    "trace_max_mb": ("FLUVIO_TRACE_MAX_MB", envreg.env_float),
    "slo": ("FLUVIO_SLO", envreg.env_raw),
    "slo_window_s": ("FLUVIO_SLO_WINDOW_S", envreg.env_float),
    "slo_windows": ("FLUVIO_SLO_WINDOWS", envreg.env_int),
    "slo_profile_dir": ("FLUVIO_SLO_PROFILE", envreg.env_raw),
    "slo_profile_ms": ("FLUVIO_SLO_PROFILE_MS", envreg.env_float),
    "slo_profile_cooldown_s": ("FLUVIO_SLO_PROFILE_COOLDOWN_S", envreg.env_float),
    "mem_budget": ("FLUVIO_MEM_BUDGET", envreg.env_int),
    "mem_leak_ttl_s": ("FLUVIO_MEM_LEAK_TTL_S", envreg.env_float),
    "mem_sample_s": ("FLUVIO_MEM_SAMPLE_S", envreg.env_float),
}


@pytest.mark.parametrize("field", sorted(CONFIG_ENV))
def test_config_defaults_are_the_jax_defaults(field):
    name, read = CONFIG_ENV[field]
    assert getattr(port_telemetry.TelemetryConfig(), field) == (read(name, {}) or
                                                                type(getattr(
                                                                    port_telemetry.TelemetryConfig(),
                                                                    field))())


def test_config_covers_every_field():
    import dataclasses

    assert {f.name for f in dataclasses.fields(port_telemetry.TelemetryConfig)} == set(CONFIG_ENV)


def test_configure_applies_registry_settings():
    try:
        port_telemetry.configure(port_telemetry.TelemetryConfig(
            enabled=True, flow_trace=False, slice_ring=4, tenant_cap=1,
            compile_storm_n=1, compile_storm_window_s=100.0))
        T = PORT.T
        assert T.begin_flow("k") is None and T.flows.capacity == 4
        T.add_tenant_served("a", 1)
        T.add_tenant_served("b", 1)
        assert T.tenant_families()[0] == {"a": 1, "_overflow": 1}
        T.add_compile("nvcc", "x", 0.1)
        T.add_compile("nvcc", "y", 0.1)
        assert T.snapshot()["counters"]["declines"] == {"recompile-storm": 1}
        eng = port_slo.engine()
        assert eng.timeseries.window_s == 10.0
    finally:
        port_telemetry.configure(port_telemetry.TelemetryConfig())
    assert PORT.T.flow_trace and PORT.T.flows.capacity == 512
