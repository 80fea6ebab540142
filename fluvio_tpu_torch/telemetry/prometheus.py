"""Prometheus text-format exposition of a telemetry snapshot.

The port's copy of ``fluvio_tpu/telemetry/prometheus.py``: the same
families, names and labels; only the help text of the build families
(the port's compile events are native library builds) and of the leak
counter (its TTL is a config field) differ.

Renders `PipelineTelemetry` (histograms, counters) and optionally the
SPU's `SpuMetrics` dict into exposition format 0.0.4 text — the format
every Prometheus-compatible scraper (and `promtool check metrics`)
accepts. The telemetry series copy out under ONE registry lock hold, so
all telemetry samples in a scrape are from the same instant (broker
counter sections snapshot under their own locks).
"""

from __future__ import annotations

from typing import Optional

from fluvio_tpu_torch.telemetry.registry import TELEMETRY, PipelineTelemetry

# the metric namespace, shared with the JAX package's exposition so a
# scraper reads both SPUs under the same family names (a namespace, not a
# path: joined so that no code string of the port names the JAX package)
_PREFIX = "_".join(("fluvio", "tpu"))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Writer:
    def __init__(self) -> None:
        self.lines = []

    def header(self, name: str, help_text: str, kind: str) -> None:
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, labels: dict, value: float) -> None:
        if labels:
            inner = ",".join(
                f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()
            )
            self.lines.append(f"{name}{{{inner}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _histogram(w: _Writer, name: str, help_text: str, series) -> None:
    """``series``: [(labels_dict, LatencyHistogram)] — one TYPE header,
    one bucket ladder per label set."""
    w.header(name, help_text, "histogram")
    for labels, hist in series:
        for bound, cum in hist.cumulative_buckets():
            le = "+Inf" if bound is None else _fmt(bound)
            w.sample(f"{name}_bucket", dict(labels, le=le), cum)
        w.sample(f"{name}_sum", labels, hist.sum)
        w.sample(f"{name}_count", labels, hist.count)


def render_prometheus(
    telemetry: Optional[PipelineTelemetry] = None,
    spu_metrics: Optional[dict] = None,
) -> str:
    """Exposition text for the telemetry registry (and, when given, the
    SPU broker counters dict from ``SpuMetrics.to_dict()``)."""
    t = telemetry if telemetry is not None else TELEMETRY
    w = _Writer()

    # pull-join the consumer-lag + device-memory gauges at the scrape
    # edge (outside the registry lock; one attribute check each when
    # nothing is tracked — and the memory pull runs the leak scan, so
    # scraping keeps the TTL detector honest while nothing dispatches)
    t.refresh_lag()
    t.refresh_memory()
    with t._lock:
        batch_series = [
            ({"path": path}, h.copy()) for path, h in t.batch_latency.items()
        ]
        phase_series = [
            ({"phase": p}, h.copy()) for p, h in t.phase_hist.items()
        ]
        chain_series = [
            ({"chain": c}, h.copy()) for c, h in t.chain_latency.items()
        ]
        records = dict(t.batch_records)
        heals, stripe = t.heals, t.stripe_fallbacks
        spills, declines = dict(t.spills), dict(t.declines)
        link_variants = dict(t.link_variants)
        retries, quarantined = dict(t.retries), t.quarantined
        sharded_compress = t.sharded_compress_shards
        slo_breaches = dict(t.slo_breaches)
        admission = dict(t.admission)
        breaker_states = dict(t.breaker_states)
        breaker_transitions = dict(t.breaker_transitions)
        breaker_shorts = t.breaker_short_circuits
        interp = (t.interp_calls, t.interp_seconds, t.interp_records)
        compiles = dict(t.compiles)
        compile_seconds = dict(t.compile_seconds)
        compile_hist = t.compile_hist.copy()
        pc_hits, pc_misses = t.persistent_cache_hits, t.persistent_cache_misses
        jit_hits = t.jit_cache_hits
        gauges = dict(t.gauges)
        slice_series = [
            ({"phase": p}, h.copy())
            for p, h in t.slice_hist.items()
            if p != "hold"
        ]
        hold_hist = t.slice_hist["hold"].copy()
        consumer_lag = dict(t.consumer_lag)
        served_records = dict(t.served_records)
        record_age = {k: h.copy() for k, h in t.record_age.items()}
        tenant_served = dict(t.tenant_served)
        tenant_shed = dict(t.tenant_shed)
        tenant_held = dict(t.tenant_held)
        tenant_age = {k: h.copy() for k, h in t.tenant_age.items()}
        rebalance_moves = dict(t.rebalance_moves)
        migration_hist = t.migration_hist.copy()
        windows_closed = t.windows_closed
        window_deltas = dict(t.window_deltas)
        window_bytes = (t.window_delta_bytes, t.window_full_bytes)
        memory_leaks = dict(t.memory_leaks)
    spans_dropped = t.spans.dropped
    # per-owner ledger bytes read OUTSIDE the registry lock (the
    # ledger has its own lock; peek() never creates one for a scrape)
    from fluvio_tpu_torch.telemetry import memory as memory_mod

    _mem_eng = memory_mod.peek()
    memory_owners = _mem_eng.owner_bytes() if _mem_eng is not None else {}

    _histogram(
        w,
        f"{_PREFIX}_batch_latency_seconds",
        "End-to-end per-batch pipeline latency by execution path.",
        batch_series,
    )
    _histogram(
        w,
        f"{_PREFIX}_phase_seconds",
        "Per-batch time spent in each pipeline phase.",
        phase_series,
    )
    if chain_series:
        _histogram(
            w,
            f"{_PREFIX}_chain_e2e_latency_seconds",
            "End-to-end per-batch latency by chain signature.",
            chain_series,
        )

    w.header(
        f"{_PREFIX}_batch_records_total",
        "Records processed, by execution path.",
        "counter",
    )
    for path, n in sorted(records.items()):
        w.sample(f"{_PREFIX}_batch_records_total", {"path": path}, n)

    w.header(
        f"{_PREFIX}_glz_heals_total",
        "Link-compression self-heal events (glz disabled + batch re-shipped raw).",
        "counter",
    )
    w.sample(f"{_PREFIX}_glz_heals_total", {}, heals)

    w.header(
        f"{_PREFIX}_stripe_fallbacks_total",
        "Wide batches spilled because the chain is outside the stripeable subset.",
        "counter",
    )
    w.sample(f"{_PREFIX}_stripe_fallbacks_total", {}, stripe)

    w.header(
        f"{_PREFIX}_spills_total",
        "Fused-path batches re-run on the interpreter, by reason.",
        "counter",
    )
    for reason, n in sorted(spills.items()):
        w.sample(f"{_PREFIX}_spills_total", {"reason": reason}, n)

    w.header(
        f"{_PREFIX}_declines_total",
        "Fast-path staging declines, by reason.",
        "counter",
    )
    for reason, n in sorted(declines.items()):
        w.sample(f"{_PREFIX}_declines_total", {"reason": reason}, n)

    w.header(
        f"{_PREFIX}_link_variants_total",
        "Dispatched batches by H2D link staging form "
        "(raw / glz-gather / glz-pallas).",
        "counter",
    )
    for variant, n in sorted(link_variants.items()):
        w.sample(f"{_PREFIX}_link_variants_total", {"variant": variant}, n)

    w.header(
        f"{_PREFIX}_retries_total",
        "Bounded-retry attempts on the fused path, by failing seam.",
        "counter",
    )
    for point, n in sorted(retries.items()):
        w.sample(f"{_PREFIX}_retries_total", {"point": point}, n)

    w.header(
        f"{_PREFIX}_quarantined_total",
        "Poison batches dead-lettered after failing fused and interpreter paths.",
        "counter",
    )
    w.sample(f"{_PREFIX}_quarantined_total", {}, quarantined)

    w.header(
        f"{_PREFIX}_sharded_inline_compress_shards_total",
        "Shard segments glz-compressed inline on the sharded staging "
        "path (not covered by the compress-ahead worker).",
        "counter",
    )
    w.sample(
        f"{_PREFIX}_sharded_inline_compress_shards_total",
        {},
        sharded_compress,
    )

    w.header(
        f"{_PREFIX}_slo_breaches_total",
        "SLO verdict transitions into breach, by chain/rule.",
        "counter",
    )
    for key, n in sorted(slo_breaches.items()):
        w.sample(f"{_PREFIX}_slo_breaches_total", {"key": key}, n)

    w.header(
        f"{_PREFIX}_admission_decisions_total",
        "Admission-controller decisions (admit plus shed/flush reasons).",
        "counter",
    )
    for reason, n in sorted(admission.items()):
        w.sample(
            f"{_PREFIX}_admission_decisions_total", {"outcome": reason}, n
        )

    w.header(
        f"{_PREFIX}_breaker_transitions_total",
        "Circuit-breaker state transitions, by entered state.",
        "counter",
    )
    for state, n in sorted(breaker_transitions.items()):
        w.sample(f"{_PREFIX}_breaker_transitions_total", {"state": state}, n)

    w.header(
        f"{_PREFIX}_breaker_state",
        "Current circuit-breaker state per chain (0=closed 1=half_open 2=open).",
        "gauge",
    )
    for name, state in sorted(breaker_states.items()):
        w.sample(
            f"{_PREFIX}_breaker_state",
            {"chain": name},
            {"closed": 0, "half_open": 1, "open": 2}.get(state, 0),
        )

    w.header(
        f"{_PREFIX}_breaker_short_circuits_total",
        "Batches routed straight to the interpreter by an open breaker.",
        "counter",
    )
    w.sample(f"{_PREFIX}_breaker_short_circuits_total", {}, breaker_shorts)

    for name, help_text, value in (
        ("interp_instance_calls_total",
         "Interpreter module-instance invocations.", interp[0]),
        ("interp_instance_seconds_total",
         "Wall seconds spent inside interpreter module instances.", interp[1]),
        ("interp_instance_records_total",
         "Records fed through interpreter module instances.", interp[2]),
    ):
        w.header(f"{_PREFIX}_{name}", help_text, "counter")
        w.sample(f"{_PREFIX}_{name}", {}, value)

    # -- build telemetry ----------------------------------------------------
    w.header(
        f"{_PREFIX}_compiles_total",
        "Native library builds (nvcc kernels, g++ codecs), by compiler.",
        "counter",
    )
    for kind, n in sorted(compiles.items()):
        w.sample(f"{_PREFIX}_compiles_total", {"kind": kind}, n)
    w.header(
        f"{_PREFIX}_compile_seconds_total",
        "Wall seconds spent building native libraries, by compiler.",
        "counter",
    )
    for kind, s in sorted(compile_seconds.items()):
        w.sample(f"{_PREFIX}_compile_seconds_total", {"kind": kind}, s)
    _histogram(
        w,
        f"{_PREFIX}_compile_latency_seconds",
        "Per-library build wall latency (a cached library: its load).",
        [({}, compile_hist)],
    )
    for name, help_text, value in (
        ("persistent_cache_hits_total",
         "Native libraries found built in their _build/ directory.",
         pc_hits),
        ("persistent_cache_misses_total",
         "Native libraries built by this process.", pc_misses),
        ("jit_cache_hits_total",
         "Jit trace-cache hits (the port has no jit: always 0).",
         jit_hits),
        ("spans_dropped_total",
         "Batch spans overwritten by the bounded ring (dump is lossy "
         "when nonzero).", spans_dropped),
    ):
        w.header(f"{_PREFIX}_{name}", help_text, "counter")
        w.sample(f"{_PREFIX}_{name}", {}, value)

    # -- slice flow / streaming lag ------------------------------------------
    _histogram(
        w,
        f"{_PREFIX}_slice_wait_seconds",
        "Per-slice lifecycle phase latency (queue-wait, batcher "
        "residence, arrival->served).",
        slice_series,
    )
    _histogram(
        w,
        f"{_PREFIX}_admission_hold_seconds",
        "Shed-held stream slice hold time before re-admission.",
        [({}, hold_hist)],
    )
    w.header(
        f"{_PREFIX}_consumer_lag",
        "Consumer lag (records behind the replica high watermark) per "
        "chain@topic/partition.",
        "gauge",
    )
    for key, v in sorted(consumer_lag.items()):
        w.sample(f"{_PREFIX}_consumer_lag", {"key": key}, v)
    w.header(
        f"{_PREFIX}_served_records_total",
        "Records served to consumers per chain@topic/partition.",
        "counter",
    )
    for key, v in sorted(served_records.items()):
        w.sample(f"{_PREFIX}_served_records_total", {"key": key}, v)
    if record_age:
        _histogram(
            w,
            f"{_PREFIX}_record_age_seconds",
            "End-to-end record age (append wall-time -> served) per "
            "chain@topic/partition.",
            [({"key": k}, h) for k, h in sorted(record_age.items())],
        )

    # -- per-tenant accounting plane -----------------------------------------
    w.header(
        f"{_PREFIX}_tenant_served_records_total",
        "Records served per tenant label (cardinality-capped; overflow "
        "folds into _overflow).",
        "counter",
    )
    for tenant, v in sorted(tenant_served.items()):
        w.sample(
            f"{_PREFIX}_tenant_served_records_total", {"tenant": tenant}, v
        )
    w.header(
        f"{_PREFIX}_tenant_shed_total",
        "Admission shed decisions per tenant label.",
        "counter",
    )
    for tenant, v in sorted(tenant_shed.items()):
        w.sample(f"{_PREFIX}_tenant_shed_total", {"tenant": tenant}, v)
    w.header(
        f"{_PREFIX}_tenant_held_total",
        "Shed-hold cycles entered per tenant label.",
        "counter",
    )
    for tenant, v in sorted(tenant_held.items()):
        w.sample(f"{_PREFIX}_tenant_held_total", {"tenant": tenant}, v)
    if tenant_age:
        _histogram(
            w,
            f"{_PREFIX}_tenant_record_age_seconds",
            "End-to-end record age (append wall-time -> served) per "
            "tenant label.",
            [({"tenant": k}, h) for k, h in sorted(tenant_age.items())],
        )

    # -- elastic rebalancer --------------------------------------------------
    w.header(
        f"{_PREFIX}_rebalance_moves_total",
        "Voluntary partition migrations by reason (lag | split | merge | "
        "manual | rollback).",
        "counter",
    )
    for reason, v in sorted(rebalance_moves.items()):
        w.sample(f"{_PREFIX}_rebalance_moves_total", {"reason": reason}, v)
    if migration_hist.count:
        _histogram(
            w,
            f"{_PREFIX}_migration_seconds",
            "Drain + replay duration of one voluntary partition migration.",
            [({}, migration_hist)],
        )

    # -- windowed state ------------------------------------------------------
    w.header(
        f"{_PREFIX}_windows_closed_total",
        "Windows whose close watermark passed (final value emitted).",
        "counter",
    )
    w.sample(f"{_PREFIX}_windows_closed_total", {}, windows_closed)
    w.header(
        f"{_PREFIX}_window_deltas_total",
        "Window delta rows by kind (upsert | close | resync | late — "
        "late rows are dropped, not shipped).",
        "counter",
    )
    for kind, v in sorted(window_deltas.items()):
        w.sample(f"{_PREFIX}_window_deltas_total", {"kind": kind}, v)
    w.header(
        f"{_PREFIX}_window_downlink_bytes_total",
        "Windowed downlink bytes: delta actually shipped vs the "
        "full-state counterfactual (their ratio is the d2h win).",
        "counter",
    )
    for form, v in zip(("delta", "full"), window_bytes):
        w.sample(
            f"{_PREFIX}_window_downlink_bytes_total", {"form": form}, v
        )

    # -- device-memory ledger ------------------------------------------------
    # per-owner family: the flat device_memory_bytes gauge is the sum
    # of these samples (rendered HERE, labeled, instead of through the
    # generic gauge loop below)
    w.header(
        f"{_PREFIX}_device_memory_bytes",
        "Device-memory ledger bytes by owner class "
        "(staged_batch | carry_bank | window_bank | emit_buffer | "
        "glz_tokens | shard_staging | compile_cache).",
        "gauge",
    )
    for owner, v in sorted(memory_owners.items()):
        w.sample(f"{_PREFIX}_device_memory_bytes", {"owner": owner}, v)
    w.header(
        f"{_PREFIX}_device_memory_peak_bytes",
        "High watermark of the device-memory ledger total.",
        "gauge",
    )
    w.sample(
        f"{_PREFIX}_device_memory_peak_bytes", {},
        gauges.get("device_memory_peak_bytes", 0),
    )
    w.header(
        f"{_PREFIX}_memory_leaks_total",
        "Ledger entries unreleased past TelemetryConfig.mem_leak_ttl_s, "
        "by owner.",
        "counter",
    )
    for owner, n in sorted(memory_leaks.items()):
        w.sample(f"{_PREFIX}_memory_leaks_total", {"owner": owner}, n)

    # -- gauges --------------------------------------------------------------
    for name, help_text in (
        ("hbm_staged_bytes",
         "Device-memory bytes currently staged by in-flight batches "
         "(ledger alias: staged_batch + glz_tokens + shard_staging)."),
        ("live_batch_handles",
         "Dispatched batches whose results have not been fetched."),
        ("inflight_queue_depth",
         "Pipelined broker slice chunks dispatched and not yet finished."),
        ("deadletter_entries",
         "Quarantined poison batches resident in the dead-letter dir."),
        ("admission_queue_depth",
         "Slices held in the admission fair queues, not yet dispatched."),
        ("warmed_buckets",
         "Shape buckets precompiled by the AOT warmup pass."),
        ("held_slices",
         "Stream slices currently shed-held by admission backpressure."),
    ):
        w.header(f"{_PREFIX}_{name}", help_text, "gauge")
        w.sample(f"{_PREFIX}_{name}", {}, gauges.get(name, 0))
    for name in sorted(set(gauges) - {
        "hbm_staged_bytes", "live_batch_handles",
        "inflight_queue_depth", "deadletter_entries",
        "admission_queue_depth", "warmed_buckets", "held_slices",
        # rendered above as the labeled/peak ledger families
        "device_memory_bytes", "device_memory_peak_bytes",
    }):
        w.header(f"{_PREFIX}_{name}", "Engine gauge.", "gauge")
        w.sample(f"{_PREFIX}_{name}", {}, gauges[name])

    if t is TELEMETRY:
        _render_slo(w)
    if spu_metrics is not None:
        _render_spu(w, spu_metrics)
    return w.text()


_VERDICT_VALUE = {"ok": 0, "warn": 1, "breach": 2}


def _render_slo(w: _Writer) -> None:
    """Windowed gauges + per-chain/rule verdict states from the
    process-global SLO engine (scrape-driven sampling: the scrape IS
    the tick). Only rendered for the global registry — a custom
    `PipelineTelemetry` has no engine bound to it. Guarded: a broken
    evaluation must never take the scrape surface with it."""
    try:
        from fluvio_tpu_torch.telemetry import slo as slo_mod

        doc = slo_mod.health_snapshot()
    except Exception:  # pragma: no cover — defensive scrape guard
        return
    if not doc.get("enabled"):
        return
    w.header(
        f"{_PREFIX}_slo_verdict",
        "Current SLO verdict per chain and rule (0=ok 1=warn 2=breach).",
        "gauge",
    )
    for chain, entry in sorted((doc.get("chains") or {}).items()):
        for rule, ev in sorted((entry.get("rules") or {}).items()):
            w.sample(
                f"{_PREFIX}_slo_verdict",
                {"chain": chain, "rule": rule},
                _VERDICT_VALUE.get(ev.get("verdict"), 0),
            )
    w.header(
        f"{_PREFIX}_slo_observed",
        "Short-window observed value per chain and rule (rule units).",
        "gauge",
    )
    for chain, entry in sorted((doc.get("chains") or {}).items()):
        for rule, ev in sorted((entry.get("rules") or {}).items()):
            if ev.get("observed") is not None:
                w.sample(
                    f"{_PREFIX}_slo_observed",
                    {"chain": chain, "rule": rule},
                    ev["observed"],
                )
    w.header(
        f"{_PREFIX}_slo_target",
        "Configured SLO target per rule (rule units).",
        "gauge",
    )
    for rule, tgt in sorted((doc.get("targets") or {}).items()):
        w.sample(f"{_PREFIX}_slo_target", {"rule": rule}, tgt["target"])
    window = doc.get("window") or {}
    w.header(
        f"{_PREFIX}_window_chain_rate",
        "Short-window per-chain batch rate (batches/s).",
        "gauge",
    )
    for chain, s in sorted((window.get("chains") or {}).items()):
        w.sample(
            f"{_PREFIX}_window_chain_rate", {"chain": chain}, s["rate_per_s"]
        )
    w.header(
        f"{_PREFIX}_window_chain_p99_seconds",
        "Short-window per-chain end-to-end p99 latency.",
        "gauge",
    )
    for chain, s in sorted((window.get("chains") or {}).items()):
        w.sample(
            f"{_PREFIX}_window_chain_p99_seconds",
            {"chain": chain},
            s["p99_ms"] / 1000.0,
        )


def _render_spu(w: _Writer, m: dict) -> None:
    for direction in ("inbound", "outbound"):
        d = m.get(direction) or {}
        w.header(
            f"{_PREFIX}_spu_{direction}_records_total",
            f"Broker {direction} records.",
            "counter",
        )
        w.sample(f"{_PREFIX}_spu_{direction}_records_total", {}, d.get("records", 0))
        w.header(
            f"{_PREFIX}_spu_{direction}_bytes_total",
            f"Broker {direction} bytes.",
            "counter",
        )
        w.sample(f"{_PREFIX}_spu_{direction}_bytes_total", {}, d.get("bytes", 0))
    sm = m.get("smartmodule") or {}
    scalar_fields = (
        ("bytes_in", "Bytes fed into SmartModule chains."),
        ("records_out", "Records produced by SmartModule chains."),
        ("invocation_count", "Chain invocations."),
        ("fuel_used", "Metered fuel units consumed."),
        ("fastpath_slices", "Read slices that ran the coalesced fast path on the card."),
        ("fallback_slices", "Read slices that fell back to the per-record loop."),
    )
    for field, help_text in scalar_fields:
        name = f"{_PREFIX}_smartmodule_{field}_total"
        w.header(name, help_text, "counter")
        w.sample(name, {}, sm.get(field, 0))
    w.header(
        f"{_PREFIX}_smartmodule_fallback_reasons_total",
        "Fast-path fallback slices by decline reason.",
        "counter",
    )
    for reason, n in sorted((sm.get("fallback_reasons") or {}).items()):
        w.sample(
            f"{_PREFIX}_smartmodule_fallback_reasons_total",
            {"reason": reason},
            n,
        )
