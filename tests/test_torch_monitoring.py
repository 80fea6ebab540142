"""The port's SPU monitoring socket and its telemetry seams against the
JAX package's, on the CPU, over real sockets.

The same stored log (seeded ``gen_json`` batches) is written to a JAX
`SpuServer` and to the port's (engine on the CPU), each with its
monitoring socket; each package's client consumes the north star (the
bench's AdHoc filter and map, dispatch-ahead, chunks of 64 rows) and then
``3_aggregate`` (one slice at a time); each SPU warms the north star's
fresh chain with one 2-record batch (`_schedule_chain_warmup`), a span
on each side, finished before the stream's first slice (the port's warm
takes the chain's lock first; the JAX SPU's, a cold jit on a thread of
its own, is made to finish before its handler goes on, so its span never
falls inside the first slice's window and both traces join the same
work). Then all seven modes are read from
both sockets and compared at tolerance 0: the families present, the
served records by key and by tenant, the span and flow counts by path and
chain label, the decline reasons and link forms, lag 0 at the end, the
transient ledger owners drained, the hook metering's quarantine state
(``hook_quarantine``). Wall-clock fields (latencies, ages, times, observed
SLO values) are left out by name.

Each package's breakers are numbered from 1 for the test (both packages
name a chain's breaker ``chain-<n>`` in creation order), so the
``breaker`` states are an equality too.

Pinned divergences (`ROADMAP.md` §3):

- compile events: the JAX package's are jit trace-cache misses, the
  port's its native library builds, so their counts differ, and with
  them the ``recompile-storm`` declines the storm detector counts;
- the ledger's peak: a batch books the bytes each package uploaded, and
  the port has no u16 link tiers, so the peaks differ (both drain to 0).

Also here: a `WindowedRuntime` run and a `PartitionRuntime` pass against
the JAX package's (window deltas, the ``window_bank`` and ``carry_bank``
owners against the banks' tensors, the rebalancer's default lag reader),
and the mode-line protocol (no line, or an unknown one: JSON after the
grace).
"""

from __future__ import annotations

import asyncio
import json
import re
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from fluvio_tpu.resilience import policy as ref_policy
from fluvio_tpu.spu import SpuConfig as RefSpuConfig
from fluvio_tpu.spu import SpuServer as RefSpuServer
from fluvio_tpu.spu import monitoring as ref_monitoring
from fluvio_tpu.spu import public_service as ref_public_service
from fluvio_tpu.storage.config import ReplicaConfig as RefReplicaConfig
from fluvio_tpu_torch.resilience import policy
from fluvio_tpu_torch.spu import monitoring
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.server import SpuServer
from fluvio_tpu_torch.storage.config import ReplicaConfig
from tests.test_torch_isolation import north_star_invocations, server_invocations
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import (  # noqa: F401
    _consume,
    _leaked_spin_threads_stopped,
    _port_batches,
    _stored,
    _write_port,
    _write_ref,
    small_chunks,
)
from tests.test_torch_telemetry import BOTH, PORT, REF, _reset

SIZES = [96, 64, 128, 80, 112]
MAX_BYTES = 6_000  # a few stored batches a slice
TOPIC = "acme.bench"  # tenant "acme"

# the fields of the documents that read a clock (left out by name)
WALL_CLOCK = {"t0", "t_end", "e2e_ms", "serve_ms", "sum_s", "p50_ms", "p90_ms", "p99_ms",
              "min_ms", "max_ms", "age_p50_ms", "age_p99_ms", "observed", "long_observed",
              "window_s", "long_window_s", "duration_s", "rate_per_s", "seconds",
              "seconds_by_kind", "latency", "ts", "dur"}


@pytest.fixture(autouse=True)
def _fresh_registries():
    for ns in BOTH:
        _reset(ns)
    yield
    for ns in BOTH:
        _reset(ns)


def _strip(doc):
    """``doc`` without its wall-clock fields."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in WALL_CLOCK}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


async def _start_servers(wires):
    """(JAX server, port server), each with its monitoring socket in the
    working directory (short relative paths: a unix socket's path is
    bounded)."""
    ref_cfg = RefSpuConfig(public_addr="127.0.0.1:0", private_addr="", log_base_dir="ref",
                           replication=RefReplicaConfig(base_dir="ref"),
                           cleaner_interval_seconds=0, monitoring_path="ref.sock")
    ref_cfg.smart_engine.backend = "tpu"
    ref = RefSpuServer(ref_cfg)
    await ref.start()
    await _write_ref(ref.ctx.create_replica(TOPIC, 0), wires)
    cfg = SpuConfig(public_addr="127.0.0.1:0", private_addr="", log_base_dir="port",
                    replication=ReplicaConfig(base_dir="port"), cleaner_interval_seconds=0,
                    monitoring_path="port.sock")
    cfg.smart_engine.device = "cpu"
    port = SpuServer(cfg)
    await port.start()
    await _write_port(port.ctx.create_replica(TOPIC, 0), wires)
    return ref, port


async def _settled(timeout: float = 20.0) -> None:
    """Wait until both servers' stream handlers have finished their slices
    (no batch in flight, every flow ended)."""
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while loop.time() < end:
        if all(ns.T.gauge_value("live_batch_handles") == 0
               and ns.T.gauge_value("inflight_queue_depth") == 0 for ns in BOTH):
            await asyncio.sleep(0.2)
            return
        await asyncio.sleep(0.05)
    raise AssertionError("stream handlers did not settle")


async def _read_all(mod, path):
    return {
        "json": await mod.read_metrics(path),
        "prom": await mod.read_prometheus(path),
        "spans": await mod.read_spans(path),
        "trace": await mod.read_trace(path),
        "health": await mod.read_health(path),
        "lag": await mod.read_lag(path),
        "memory": await mod.read_memory(path),
    }


async def _raw(path, line: bytes) -> bytes:
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        if line:
            writer.write(line)
            await writer.drain()
        return await reader.read()
    finally:
        writer.close()


def _families(prom: str):
    return {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE ")}


def _samples(prom: str, *names):
    """{sample line name+labels: value} of the families ``names`` (the
    compile storms' declines left out: compile events differ)."""
    out = {}
    for line in prom.splitlines():
        if line.startswith("#") or 'reason="recompile-storm"' in line:
            continue
        key, value = line.rsplit(" ", 1)
        if re.match(r"[a-z_]+", key).group(0) in names:
            out[key] = float(value)
    return out


def _span_counts(spans):
    return Counter((s["path"], s.get("chain", ""), s["records"]) for s in spans)


def _trace_counts(doc):
    events = doc["traceEvents"]
    return (Counter(e["cat"] for e in events if e.get("ph") == "X"),
            Counter(e["args"].get("chain", "") for e in events if e.get("cat") == "slice"),
            Counter(e["ph"] for e in events if e.get("cat") == "flow"))


def _warm_before_serving(monkeypatch) -> None:
    """The JAX SPU's tiny warm, run to its end before its stream handler
    goes on: in a thread with no event loop the reference warms inline."""
    warm = ref_public_service._schedule_chain_warmup

    def warm_now(chain):
        with ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(warm, chain).result()

    monkeypatch.setattr(ref_public_service, "_schedule_chain_warmup", warm_now)


def test_monitoring_modes_equal_reference(tmp_path, monkeypatch, small_chunks):
    monkeypatch.chdir(tmp_path)
    for mod in (ref_policy, policy):
        monkeypatch.setattr(mod, "_BREAKER_SEQ", [0])
    _warm_before_serving(monkeypatch)
    wires = _stored(SIZES, seed=61)

    async def main():
        ref, port = await _start_servers(wires)
        try:
            for invocations in (north_star_invocations(), server_invocations("3_aggregate")):
                want = await _consume(ref.public_addr, invocations, max_bytes=MAX_BYTES,
                                      topic=TOPIC, port_client=False)
                got = await _consume(port.public_addr, invocations, max_bytes=MAX_BYTES,
                                     topic=TOPIC)
                assert [b for _, b in got] == [b for _, b in want]
            await _settled()
            docs = (await _read_all(ref_monitoring, "ref.sock"),
                    await _read_all(monitoring, "port.sock"))
            legacy = []
            for path in ("ref.sock", "port.sock"):
                legacy.append((json.loads(await _raw(path, b"")),
                               json.loads(await _raw(path, b"bogus\n"))))
            return docs, legacy
        finally:
            await port.stop()
            await ref.stop()

    (ref, port), legacy = asyncio.run(asyncio.wait_for(main(), timeout=180))
    n = sum(SIZES)

    # prom: the families present, and the samples that count the traffic
    assert _families(port["prom"]) == _families(ref["prom"])
    counted = ("fluvio_tpu_batch_records_total", "fluvio_tpu_batch_latency_seconds_count",
               "fluvio_tpu_chain_e2e_latency_seconds_count", "fluvio_tpu_declines_total",
               "fluvio_tpu_link_variants_total", "fluvio_tpu_spills_total",
               "fluvio_tpu_served_records_total", "fluvio_tpu_consumer_lag",
               "fluvio_tpu_tenant_served_records_total", "fluvio_tpu_slice_wait_seconds_count",
               "fluvio_tpu_record_age_seconds_count",
               "fluvio_tpu_tenant_record_age_seconds_count", "fluvio_tpu_windows_closed_total",
               "fluvio_tpu_device_memory_bytes", "fluvio_tpu_hbm_staged_bytes",
               "fluvio_tpu_live_batch_handles", "fluvio_tpu_inflight_queue_depth",
               "fluvio_tpu_spu_outbound_records_total", "fluvio_tpu_spu_outbound_bytes_total",
               "fluvio_tpu_smartmodule_fastpath_slices_total",
               "fluvio_tpu_smartmodule_fallback_slices_total",
               "fluvio_tpu_smartmodule_records_out_total", "fluvio_tpu_spans_dropped_total")
    assert _samples(port["prom"], *counted) == _samples(ref["prom"], *counted)
    served = _samples(port["prom"], "fluvio_tpu_served_records_total")
    assert set(served) == {'fluvio_tpu_served_records_total{key="filter+map@acme.bench/0"}',
                           'fluvio_tpu_served_records_total{key="aggregate@acme.bench/0"}'}
    # the scrape pulls the lag join: both keys caught up
    assert set(_samples(port["prom"], "fluvio_tpu_consumer_lag").values()) == {0.0}
    assert len(_samples(port["prom"], "fluvio_tpu_consumer_lag")) == 2
    assert _samples(port["prom"], "fluvio_tpu_tenant_served_records_total") == {
        'fluvio_tpu_tenant_served_records_total{tenant="acme"}': sum(served.values())}

    # json: the telemetry snapshot's families; the traffic's counts
    rj, pj = ref["json"], port["json"]
    # both meter Python hooks: the same quarantine state (nothing abandoned)
    assert set(rj) == set(pj) and pj["hook_quarantine"] == rj["hook_quarantine"]
    for k in ("inbound", "outbound", "smartmodule"):
        assert pj[k] == rj[k], k
    rt, pt = rj["telemetry"], pj["telemetry"]
    assert set(pt) == set(rt)
    for section in ("counters", "compile", "lag", "tenants", "rebalance", "windows", "memory"):
        assert set(pt[section]) == set(rt[section]), section
    assert set(pt["phases"]) == set(rt["phases"])
    assert set(pt["gauges"]) == set(rt["gauges"])
    assert {k: v for k, v in pt["gauges"].items() if k != "device_memory_peak_bytes"} == {
        k: v for k, v in rt["gauges"].items() if k != "device_memory_peak_bytes"}
    assert {p: (h["count"], h["records"]) for p, h in pt["batches"].items()} == {
        p: (h["count"], h["records"]) for p, h in rt["batches"].items()}
    # both passes, and each SPU's 2-record warm of the fresh stateless chain
    assert pt["batches"]["fused"]["records"] == 2 * n + 2
    assert {c: h["count"] for c, h in pt["chains"].items()} == {
        c: h["count"] for c, h in rt["chains"].items()}
    for counters in (pt["counters"], rt["counters"]):
        counters["declines"].pop("recompile-storm", None)
    assert pt["counters"]["breaker"]["states"] == rt["counters"]["breaker"]["states"]
    assert pt["counters"]["breaker"]["states"]
    assert pt["counters"] == rt["counters"]
    assert pt["lag"]["served_records"] == rt["lag"]["served_records"]
    assert pt["lag"]["consumer_lag"] == rt["lag"]["consumer_lag"]
    assert pt["tenants"]["served"] == rt["tenants"]["served"]
    assert pt["windows"] == rt["windows"]
    assert {k: pt[k] for k in ("spans_total", "spans_dropped", "flows_total", "flows_dropped")} \
        == {k: rt[k] for k in ("spans_total", "spans_dropped", "flows_total", "flows_dropped")}
    assert pt["flows_total"] >= 4
    assert {k: v for k, v in pt["memory"].items() if k != "peak_bytes"} == {
        k: v for k, v in rt["memory"].items() if k != "peak_bytes"}
    assert pt["memory"]["peak_bytes"] > 0

    # spans: counts by path, chain label and records
    assert _span_counts(port["spans"]) == _span_counts(ref["spans"])
    assert {s["path"] for s in port["spans"]} == {"fused"}
    assert all("device" in s["phases_ms"] for s in port["spans"])

    # trace: batch and slice envelopes, flows by chain label, flow arrows
    assert _trace_counts(port["trace"]) == _trace_counts(ref["trace"])

    # health: the same chains and rules evaluated (verdicts read clocks)
    assert set(port["health"]["chains"]) == set(ref["health"]["chains"])
    for chain, entry in port["health"]["chains"].items():
        assert set(entry["rules"]) == set(ref["health"]["chains"][chain]["rules"]), chain
    assert port["health"]["targets"] == ref["health"]["targets"]

    # lag: every key caught up (lag 0), committed at the high watermark
    assert _strip(port["lag"]) == _strip(ref["lag"])
    parts = port["lag"]["partitions"]
    assert set(parts) == {"filter+map@acme.bench/0", "aggregate@acme.bench/0"}
    assert all(p["lag"] == 0 and p["committed"] == p["hw"] == n for p in parts.values())

    # memory: transient owners drained, the CPU backend unavailable
    pm, rm = port["memory"], ref["memory"]
    assert _strip({k: v for k, v in pm.items() if k != "peak_bytes"}) == _strip(
        {k: v for k, v in rm.items() if k != "peak_bytes"})
    assert all(pm["owners"][o]["bytes"] == 0 for o in ("staged_batch", "glz_tokens",
                                                       "emit_buffer", "shard_staging"))
    assert pm["reconcile"]["backend"] == "unavailable"

    # the mode line: none, or an unknown one, is the json document
    (ref_none, ref_bogus), (port_none, port_bogus) = legacy
    for doc in (port_none, port_bogus):
        assert set(doc) == set(pj) and doc["outbound"] == pj["outbound"]
    assert set(ref_none) == set(ref_bogus) == set(rj)


# ---------------------------------------------------------------------------
# the windowed runtime
# ---------------------------------------------------------------------------

def test_windowed_runtime_telemetry_equals_reference():
    from tests.test_torch_windows import _drive_both, _gen_batches, _padded, _pair

    rng = np.random.default_rng(71)
    batches = _gen_batches(rng, 9, 50, 10, 7, regress=150)
    ref_rt, port_rt = _pair(window_ms=100, slide_ms=50, keyed=True, emit_capacity=32)
    _drive_both(ref_rt, port_rt, batches)
    # the emit overflow's resync and a consumer attach's image
    ref_rows, port_rows = ref_rt.resync_rows(), port_rt.resync_rows()
    np.testing.assert_array_equal(port_rows[0], ref_rows[0])
    assert REF.T.window_counts() == PORT.T.window_counts()
    closed, deltas, delta_bytes, full_bytes = PORT.T.window_counts()
    assert closed > 0 and deltas.get("upsert") and deltas.get("late") and delta_bytes > 0 < full_bytes
    assert PORT.T.link_variant_counts() == REF.T.link_variant_counts() == {
        "down-packed": len(batches)}
    spans = (REF.T.spans_json(), PORT.T.spans_json())
    assert _span_counts(spans[1]) == _span_counts(spans[0])
    assert {(s["path"], s["chain"]) for s in spans[1]} == {("windowed", port_rt.spec.mode)}
    owners = (REF.T.snapshot()["memory"]["owners"], PORT.T.snapshot()["memory"]["owners"])
    assert owners[1] == owners[0]
    bank = port_rt.bank
    live = bank.occupancy * (bank.ids.element_size() + bank.accs.element_size()
                             + bank.counts.element_size()) + bank.wm.element_size()
    assert owners[1] == {"window_bank": live} and live == bank.state_bytes() > 8
    assert deltas.get("resync")  # the emit columns overflowed at least once
    # a bank overflow counts its decline on both, before it raises
    for rt in _pair(window_ms=100, keyed=True, capacity=2, emit_capacity=8):
        with pytest.raises(Exception, match="bank capacity"):
            rt.ingest_arrays(*_padded([(k, 1, 10) for k in range(8)])[:3], count=8)
    assert PORT.T.snapshot()["counters"]["declines"] == REF.T.snapshot()["counters"][
        "declines"] == {"window-capacity": 1}


# ---------------------------------------------------------------------------
# the partition runtime and the rebalancer's default lag reader
# ---------------------------------------------------------------------------

def test_partition_runtime_telemetry_equals_reference():
    from fluvio_tpu.partition import rebalancer as ref_rebalancer
    from fluvio_tpu_torch.partition import PartitionRebalancer, RebalanceConfig
    from tests.test_torch_chain import _port_buffer, _ref_buffer
    from tests.test_torch_isolation import gen_json, run_partitioned
    from tests.test_torch_partition import _runtimes

    parts = 3
    values = gen_json(240, seed=72)
    bufs = []
    for p in range(parts):
        ref = _ref_buffer(values[p::parts])
        bufs.append((ref, _port_buffer(ref)))
    keys = [f"acme.bench/{p}" for p in range(parts)]
    ref_rt, port_rt = _runtimes(keys=keys)
    run_partitioned(ref_rt, [b[0] for b in bufs], ref_rebalancer.PartitionRebalancer,
                    ref_rebalancer.RebalanceConfig, topic="acme.bench")
    run_partitioned(port_rt, [b[1] for b in bufs], PartitionRebalancer, RebalanceConfig,
                    topic="acme.bench")
    snaps = (REF.T.snapshot(), PORT.T.snapshot())
    assert snaps[1]["memory"]["owners"] == snaps[0]["memory"]["owners"]
    carry = sum(c.acc.nbytes + c.win.nbytes + c.has.nbytes
                for k in keys for c in port_rt._states[k].device_carries)
    assert snaps[1]["memory"]["owners"] == {"carry_bank": carry} and carry == 17 * parts
    assert {c: h["count"] for c, h in snaps[1]["chains"].items()} == {
        c: h["count"] for c, h in snaps[0]["chains"].items()}
    assert set(snaps[1]["chains"]) == {f"filter+aggregate@{k}" for k in keys}
    assert snaps[1]["counters"]["link_variants"] == snaps[0]["counters"]["link_variants"]
    # the sequence's rebalancer moved partition 0 through a bare-bool mover
    assert snaps[1]["rebalance"]["moves"] == snaps[0]["rebalance"]["moves"] == {"lag": 1}
    # the default lag reader: the registry's consumer-lag family after the
    # pull-join of each partition's leader against its committed offset
    readers = (ref_rebalancer.PartitionRebalancer(lambda: ref_rt.plan, lambda *a: True),
               PartitionRebalancer(lambda: port_rt.plan, lambda *a: True))
    lags = [r._lag_by_plan_key() for r in readers]
    assert lags[1] == lags[0] == {k: 1.0 for k in keys}
    assert PORT.T.lag_families()[0] == REF.T.lag_families()[0]
    # a bare-bool mover's move books the move families on both
    moved = []
    for reb, rt in zip(readers, (ref_rt, port_rt)):
        moved.append(reb.merge(1, 0))
    assert [d["moved"] for d in moved[1]] == [d["moved"] for d in moved[0]]
    assert sum(d["moved"] for d in moved[1]) > 0
    assert PORT.T.rebalance_families()[0] == REF.T.rebalance_families()[0] == {
        "lag": 1, "merge": sum(d["moved"] for d in moved[1])}
