"""The port's admission control against the JAX package's, on the CPU.

Both packages get the same inputs (a fake clock, ``random.Random(seed)``,
the same scripted SLO verdict documents, the same records from seeded
corpora) and are held to each other at tolerance 0:

- the controllers' `Decision` sequences (admitted, reason, verdict,
  ``retry_after_s``) across ok → warn → breach → ok, token exhaustion and
  refill, the cold-chain gate, migration grace and build storms
  (`note_compiles`), and the admission counters they book;
- `FairQueue`'s pop order, depths and queue-depth gauge;
- `ShapeBucketBatcher`'s flush sequence (cause, chain, bucket, rows);
- `coalesce_buffers` / `split_output`: the merged buffer's bytes and
  columns, and the survivors routed back after a chain runs on it;
- the warm-up: an aggregate's carries survive it (the next batch's
  output equals the JAX engine's), and a `warm_buffer` leaves no build
  event or new bucket to the real dispatch;
- both SPUs serving one stored log under one scripted shed sequence: the
  same records and offsets at the consumer, the same admission calls,
  the held-slice gauge back at 0;
- `AdmissionPipeline`: exactly once across sheds and resubmission.

The port's own: `AdmissionConfig` / `configure` / ``SpuConfig.admission``,
the serve gate's warm-up over the socket (consumers held ``cold-chain``,
then served), the gate lifted when the warm fails, a shed that leaves
``inflight_queue_depth`` unchanged, the work list. The dead-letter leg of
the JAX package's exactly-once test waits for the port's resilience
ladder.
"""

from __future__ import annotations

import random
from collections import Counter

import numpy as np
import pytest

from fluvio_tpu import admission as ref_admission
from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol.record import Record as RefRecord
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
from fluvio_tpu.smartmodule import SmartModuleInput as RefInput
from fluvio_tpu.spu import smart_chain as ref_sc
from fluvio_tpu_torch import admission
from fluvio_tpu_torch import telemetry as port_telemetry
from fluvio_tpu_torch.admission import AdmissionConfig, Rejected
from fluvio_tpu_torch.admission import warmup as port_warmup
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol.record import Record
from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartmodule import SmartModuleInput, dsl
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import SmartModuleKind
from fluvio_tpu_torch.spu import public_service
from fluvio_tpu_torch.spu import smart_chain as sc
from tests.test_torch_isolation import gen_json, north_star_invocations
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import (  # noqa: F401
    _aggregate,
    _both,
    _leaked_spin_threads_stopped,
    _run,
    _stored,
    small_chunks,
)
from tests.test_torch_telemetry import BOTH, PORT, REF, _reset

PKGS = {"ref": ref_admission, "port": admission}


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


class FakeSlo:
    """The verdict document the test pins, for either package's
    controller."""

    def __init__(self) -> None:
        self.doc = {"enabled": True, "chains": {}}
        self.calls = 0

    def evaluate(self, tick: bool = True) -> dict:
        self.calls += 1
        return self.doc

    def set(self, chain: str, verdict: str, engine: str = "ok") -> None:
        self.doc = {"enabled": True, "chains": {
            chain: {"verdict": verdict, "rules": {}},
            "_engine": {"verdict": engine, "rules": {}}}}

    def clear(self) -> None:
        self.doc = {"enabled": True, "chains": {}}


class ClosedBreaker:
    def allow_fused(self) -> bool:
        return False


@pytest.fixture(autouse=True)
def _fresh():
    port_telemetry.configure(port_telemetry.TelemetryConfig())
    for ns in BOTH:
        _reset(ns)
    prior = REF.T.enabled
    REF.T.enabled = True
    for pkg in PKGS.values():
        pkg.reset_gate()
        pkg.reset_warm_registry()
    admission.configure(AdmissionConfig())
    yield
    admission.configure(AdmissionConfig())
    for pkg in PKGS.values():
        pkg.reset_gate()
        pkg.reset_warm_registry()
    REF.T.enabled = prior
    for ns in BOTH:
        _reset(ns)


def _controllers(seed: int = 7, **kw):
    """(name, controller, clock, slo) for each package, alike."""
    kw.setdefault("refresh_s", 1.0)
    kw.setdefault("tokens", 1e9)
    kw.setdefault("refill", 1e9)
    out = []
    for name, pkg in PKGS.items():
        clk, slo = FakeClock(), FakeSlo()
        ctl = pkg.AdmissionController(slo_engine=slo, clock=clk, rng=random.Random(seed), **kw)
        out.append((name, ctl, clk, slo))
    return out


def _d(decision):
    return (decision.admitted, decision.chain, decision.reason, decision.verdict,
            decision.retry_after_s)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _health(ctl, clk, slo):
    """ok -> warn (probabilistic) -> breach -> engine breach -> ok, with
    the verdict cache refreshed only when stale, and a closed breaker."""
    out = [ctl.admit("c1"), ctl.admit("c2")]
    slo.set("c1", "warn")
    out.append(ctl.admit("c1"))  # the cache is fresh: still ok
    clk.advance(1.0)
    out += [ctl.admit("c1") for _ in range(24)]
    slo.set("c1", "breach")
    clk.advance(0.5)
    out.append(ctl.admit("c1"))  # cached warn
    clk.advance(0.5)
    out += [ctl.admit("c1"), ctl.admit("c2")]
    slo.set("c9", "ok", engine="breach")
    clk.advance(1.0)
    out += [ctl.admit("c1"), ctl.admit("c2"), ctl.admit("c3@t/0", tenant="acme")]
    slo.clear()
    clk.advance(1.0)
    out += [ctl.admit("c1"), ctl.admit("c2"), ctl.admit("c1", breaker=ClosedBreaker())]
    return [_d(x) for x in out]


def _tokens(ctl, clk, slo):
    """Exhaustion and refill, the refill halved under warn and stopped
    under breach, per-chain buckets."""
    out = [ctl.admit("c") for _ in range(5)]
    clk.advance(0.5)  # one token back at 2/s
    out += [ctl.admit("c"), ctl.admit("c"), ctl.admit("d")]
    slo.set("c", "warn")
    clk.advance(1.0)
    out += [ctl.admit("c") for _ in range(4)]
    clk.advance(2.0)
    out += [ctl.admit("c") for _ in range(4)]
    slo.clear()
    clk.advance(3.0)
    out += [ctl.admit("c", cost=2.0) for _ in range(3)]
    return [_d(x) for x in out]


def _cold_chain(ctl, clk, slo):
    """The serve gate: cold until warmed, read through the base signature
    for partition keys; ungated chains never shed cold."""
    ctl.require_warm("sig")
    out = [ctl.admit("sig"), ctl.admit("sig@t/0", tenant="t"), ctl.admit("other")]
    warmed = [ctl.warmed("sig")]
    ctl.note_warm("sig", [128, 1024])
    warmed.append(ctl.warmed("sig"))
    out += [ctl.admit("sig"), ctl.admit("sig@t/1")]
    ctl.require_warm("sig2")
    ctl.require_warm("sig2", False)
    out.append(ctl.admit("sig2"))
    return [_d(x) for x in out] + warmed


def _migration(ctl, clk, slo):
    """A moved partition re-admits inside its grace, sheds again after."""
    slo.set("c@t/0", "breach")
    out = [ctl.admit("c@t/0"), ctl.admit("c@t/1")]
    ctl.note_migrated("t/0", grace_s=5.0)
    out.append(ctl.admit("c@t/0"))
    clk.advance(2.0)
    out.append(ctl.admit("c@t/0"))  # refreshed: breach again, in grace
    clk.advance(4.0)
    out.append(ctl.admit("c@t/0"))  # grace over
    for k in range(130):
        ctl.note_migrated(f"x/{k}", grace_s=1.0)
    out.append(ctl.admit("c@t/0"))
    return [_d(x) for x in out]


def _storms(ctl, clk, slo):
    """Build attribution: the storm threshold inside the window, ageing
    out; n <= 0 never trips."""
    trips = [ctl.note_compiles("a", 0), ctl.note_compiles("a", 3), ctl.note_compiles("a", 5),
             ctl.note_compiles("a", 1), ctl.note_compiles("b", 9)]
    clk.advance(30.0)
    trips.append(ctl.note_compiles("a", 1))
    clk.advance(45.0)
    trips += [ctl.note_compiles("a", 8), ctl.note_compiles("a", 1), ctl.note_compiles("a", -2)]
    return trips


SCENARIOS = {
    "health": (_health, {}),
    "tokens": (_tokens, {"tokens": 3.0, "refill": 2.0}),
    "cold_chain": (_cold_chain, {}),
    "migration": (_migration, {}),
    "storms": (_storms, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_decisions_equal_reference(scenario):
    fn, kw = SCENARIOS[scenario]
    runs = {name: fn(ctl, clk, slo) for name, ctl, clk, slo in _controllers(**kw)}
    assert runs["port"] == runs["ref"]
    assert len(runs["port"]) >= 3
    assert PORT.T.admission == REF.T.admission
    assert PORT.T.tenant_families()[1] == REF.T.tenant_families()[1]
    if scenario == "health":
        reasons = Counter(r[2] for r in runs["port"])
        assert reasons["warn-shed"] and reasons["breach-shed"] and reasons["breaker-open"]
        assert reasons["admit"] >= 5
    if scenario == "tokens":
        assert Counter(r[2] for r in runs["port"])["no-tokens"] >= 4
    if scenario == "storms":
        assert True in runs["port"]


def test_health_failure_fails_open_on_both():
    class BrokenSlo:
        def evaluate(self, tick=True):
            raise RuntimeError("scrape died")

    for pkg in PKGS.values():
        ctl = pkg.AdmissionController(slo_engine=BrokenSlo(), clock=FakeClock(), tokens=1e9,
                                      refill=1e9)
        assert ctl.admit("c").admitted


# ---------------------------------------------------------------------------
# fair queues
# ---------------------------------------------------------------------------

def test_fair_queue_pop_order_and_depth_equal_reference():
    runs = {}
    for name, pkg in PKGS.items():
        clk = FakeClock()
        q = pkg.FairQueue(max_depth=6, clock=clk)
        q.set_weight("heavy", 3.0)
        q.set_weight("light", 1.0)
        pushed = [q.push(c, f"{c}-{i}") for c in ("heavy", "light", "other") for i in range(8)]
        depths = [q.depth(), q.depth("heavy"), q.depth("none")]
        order = [q.pop() for _ in range(6)]
        q.note_storm("heavy", 10.0)
        stormed = [q.stormed("heavy"), q.stormed("light")]
        order += [q.pop() for _ in range(4)]
        clk.advance(11.0)
        stormed.append(q.stormed("heavy"))
        order += [q.pop() for _ in range(2)]
        gauge = (REF if name == "ref" else PORT).T.gauge_value("admission_queue_depth")
        rest = q.drain()
        runs[name] = (pushed, depths, order, stormed, gauge, rest, sorted(q.chains()), q.pop())
    assert runs["port"] == runs["ref"]
    assert PORT.T.gauge_value("admission_queue_depth") == 0
    assert runs["port"][0].count(False) == 6


# ---------------------------------------------------------------------------
# the batcher, coalesce and split
# ---------------------------------------------------------------------------

def _buf(pkg: str, values, keys=None, offset_base: int = 0, ts=None):
    rec_cls, buf_cls = (RefRecord, RefBuffer) if pkg == "ref" else (Record, RecordBuffer)
    records = []
    for i, v in enumerate(values):
        r = rec_cls(value=v, key=None if keys is None else keys[i])
        r.offset_delta = offset_base + i
        if ts is not None:
            r.timestamp_delta = ts[i]
        records.append(r)
    return buf_cls.from_records(records)


def _flushes(name):
    pkg = PKGS[name]
    clk = FakeClock()
    seen = []

    def dispatch(flush):
        seen.append((flush.cause, flush.chain, flush.width_bucket, flush.buffer.count,
                     len(flush.items), list(flush.bases)))
        return flush.buffer.count

    bt = pkg.ShapeBucketBatcher(dispatch, row_target=10, deadline_s=0.045, clock=clk)
    bt.note_warm("a", [256])
    rng = np.random.default_rng(5)
    out = []
    for k in range(14):
        width = int(rng.choice([20, 300]))
        chain = "ab"[k % 2]
        n = int(rng.integers(1, 9))
        out.append([f.cause for f in bt.add(chain, _buf(name, [b"v" * width] * n))])
        out.append(bt.depth())
        clk.advance(0.01)
        if k % 5 == 4:
            out.append([f.cause for f in bt.poll()])
    big = _buf(name, [b"big"] * 3, offset_base=pkg.batcher.SLICE_STRIDE)
    out.append([f.cause for f in bt.add("a", big)])
    out.append([f.cause for f in bt.flush_all()])
    out.append((bt.warmed_cover("a", 100), bt.warmed_cover("a", 300), bt.warmed_cover("b", 1)))
    return seen, out


def test_batcher_flush_sequence_equal_reference():
    ref_seen, ref_out = _flushes("ref")
    seen, out = _flushes("port")
    assert seen == ref_seen and out == ref_out
    causes = Counter(s[0] for s in seen)
    assert causes["batch-full"] and causes["batch-deadline"] and causes["solo"] == 1
    assert causes["shutdown"]
    assert PORT.T.admission == REF.T.admission and PORT.T.admission.get("cold-bucket")


COALESCE_CASES = {
    "two-tenants": dict(sizes=[7, 5], keyed=False, target=None),
    "keyed-timestamps": dict(sizes=[3, 9, 4], keyed=True, target=None),
    "warmed-target": dict(sizes=[6, 6], keyed=False, target=512),
    "one-source": dict(sizes=[11], keyed=True, target=None),
}


def _coalesce_sources(pkg: str, sizes, keyed: bool, seed: int):
    rng = np.random.default_rng(seed)
    bufs = []
    docs = gen_json(sum(sizes), seed=seed)
    pos = 0
    for s in sizes:
        vals = docs[pos: pos + s]
        pos += s
        keys = [None if i % 3 == 0 else b"k%d" % i for i in range(s)] if keyed else None
        ts = [int(t) for t in rng.integers(0, 1000, s)]
        bufs.append(_buf(pkg, vals, keys=keys, ts=ts))
    return bufs


@pytest.mark.parametrize("case", sorted(COALESCE_CASES))
def test_coalesce_and_split_equal_reference(case):
    c = COALESCE_CASES[case]
    ref_merged, ref_bases = ref_admission.coalesce_buffers(
        _coalesce_sources("ref", c["sizes"], c["keyed"], 31), target_width=c["target"])
    merged, bases = admission.coalesce_buffers(
        _coalesce_sources("port", c["sizes"], c["keyed"], 31), target_width=c["target"])
    assert bases == ref_bases
    assert merged.values is None  # flat-backed: the upload form
    assert (merged.count, merged.rows, merged.width) == (ref_merged.count, ref_merged.rows,
                                                         ref_merged.width)
    np.testing.assert_array_equal(merged.dense_values(), ref_merged.values)
    for col in ("lengths", "keys", "key_lengths", "offset_deltas", "timestamp_deltas"):
        np.testing.assert_array_equal(getattr(merged, col), getattr(ref_merged, col), col)
    assert [r.value for r in merged.to_records()] == [
        bytes(r.value) for r in ref_merged.to_records()]
    # a row-preserving chain over the merge; survivors routed back
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu").builder()
    for name, params in (("regex-filter", {"regex": "fluvio"}), ("json-map", {"field": "name"})):
        rb.add_smart_module(RefConfig(params=params), ref_lookup(name))
        pb.add_smart_module(SmartModuleConfig(params=params), lookup(name))
    ref_out = rb.initialize().tpu_chain.process_buffer(ref_merged)
    out = pb.initialize().gpu_chain.process_buffer(merged)
    want = ref_admission.split_output(ref_out, ref_bases)
    got = admission.split_output(out, bases)
    assert got == [[(bytes(v), d) for v, d in part] for part in want]
    assert sum(map(len, got)) > 0


def test_coalesce_refuses_the_int32_stride_overflow():
    from fluvio_tpu_torch.admission import batcher

    for pkg, name in ((ref_admission, "ref"), (admission, "port")):
        with pytest.raises(ValueError, match="int32 offset-stride"):
            pkg.coalesce_buffers([_buf(name, [b"x"])] * (pkg.batcher.MAX_COALESCE + 1))
        big = _buf(name, [b"x"], offset_base=pkg.batcher.SLICE_STRIDE)
        with pytest.raises(ValueError, match="coalesce stride"):
            pkg.coalesce_buffers([_buf(name, [b"y"]), big])
    assert batcher.MAX_COALESCE == ref_admission.batcher.MAX_COALESCE


# ---------------------------------------------------------------------------
# warm-up
# ---------------------------------------------------------------------------

def _inputs(pkg: str, values):
    rec_cls, inp_cls = (RefRecord, RefInput) if pkg == "ref" else (Record, SmartModuleInput)
    records = [rec_cls(value=v) for v in values]
    for i, r in enumerate(records):
        r.offset_delta = i
    return inp_cls.from_records(records)


def test_warm_up_keeps_aggregate_carries_equal_reference():
    """An aggregate warmed mid-stream on both packages: the next batch's
    running totals are the JAX engine's (the probes' records never reach
    the carries), and the warm booked its bucket."""
    specs = [("aggregate-field", {"field": "n", "combine": "add"})]
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu").builder()
    for name, params in specs:
        rb.add_smart_module(RefConfig(params=params), ref_lookup(name))
        pb.add_smart_module(SmartModuleConfig(params=params), lookup(name))
    ref_chain, chain = rb.initialize(), pb.initialize()
    first = [b'{"n":%d}' % k for k in (5, 7, -3)]
    nxt = [b'{"n":%d}' % k for k in (1, 40, 2)]
    for pkg, ch in (("ref", ref_chain), ("port", chain)):
        assert ch.process(_inputs(pkg, first)).error is None
    carries = [tuple(c) for c in chain.gpu_chain.carries]
    ref_report = ref_admission.warm_executor(ref_chain.tpu_chain, widths=(64, 300))
    report = admission.warm_executor(chain.gpu_chain, widths=(64, 300))
    assert report.errors == [] and ref_report.errors == []
    assert report.buckets == ref_report.buckets == (64, 320)
    assert [tuple(c) for c in chain.gpu_chain.carries] == carries
    want = ref_chain.process(_inputs("ref", nxt))
    got = chain.process(_inputs("port", nxt))
    assert [r.value for r in got.successes] == [bytes(r.value) for r in want.successes]
    assert [r.value for r in got.successes] == [b"10", b"50", b"52"]
    assert PORT.T.gauge_value("warmed_buckets") == 2


def test_warm_buffer_leaves_no_build_and_no_new_bucket():
    """The exact-coverage warm: after `warm_buffer`, the real buffer's
    dispatch books no build event and its bucket is one the warm booked;
    the outputs equal the JAX engine's on the same buffer."""
    values = gen_json(200, seed=41)
    pb = SmartEngine(device="cpu").builder()
    rb = RefEngine(backend="tpu").builder()
    for name, params in (("regex-filter", {"regex": "flu[vV]io"}), ("json-map", {"field": "name"})):
        pb.add_smart_module(SmartModuleConfig(params=params), lookup(name))
        rb.add_smart_module(RefConfig(params=params), ref_lookup(name))
    ex, ref_ex = pb.initialize().gpu_chain, rb.initialize().tpu_chain
    buf = _buf("port", values)
    report = admission.warm_buffer(ex, buf)
    assert report.errors == [] and report.buckets == (buf.width,)
    assert report.entry_points == [] or report.entry_points  # advisory only
    builds = PORT.T.compile_totals()["compiles"]
    gauge = PORT.T.gauge_value("warmed_buckets")
    out = ex.process_buffer(buf)
    assert PORT.T.compile_totals()["compiles"] == builds
    assert PORT.T.gauge_value("warmed_buckets") == gauge == 1
    want = ref_ex.process_buffer(_buf("ref", values))
    assert [r.value for r in out.to_records()] == [bytes(r.value) for r in want.to_records()]


def test_work_list_lists_buckets_by_the_kernels_their_stages_launch():
    pb = SmartEngine(device="cpu").builder()
    for name, params in (("regex-filter", {"regex": "flu[vV]io"}), ("json-map", {"field": "name"})):
        pb.add_smart_module(SmartModuleConfig(params=params), lookup(name))
    ex = pb.initialize().gpu_chain
    wl = admission.work_list(ex, (100, 70_000), rows=60)
    assert {(e["kind"], e["signature"]) for e in wl} == {
        ("dfa_scan", "64 x 128 narrow"), ("json_span", "64 x 128 narrow"),
        ("extract", "64 x 128 narrow"), ("dfa_compose", "64 x 81920 striped"),
        ("json_span_striped", "64 x 81920 striped")}
    agg = SmartEngine(device="cpu").builder()
    agg.add_smart_module(SmartModuleConfig(params={"field": "n", "combine": "add"}),
                         lookup("aggregate-field"))
    agg_ex = agg.initialize().gpu_chain
    # past the threshold the JsonGet contribution runs on the striped span
    assert [(e["kind"], e["signature"]) for e in admission.work_list(agg_ex, (100, 70_000))] == [
        ("extract", "8 x 128 narrow"), ("json_span", "8 x 128 narrow"),
        ("json_span_striped", "8 x 81920 striped")]
    # a key rewrite is unstripeable: its wide bucket is skipped
    rekey = SmartModuleDef(name="rekey")
    rekey.dsl[SmartModuleKind.MAP] = dsl.MapProgram(value=dsl.Value(), key=dsl.Upper(arg=dsl.Key()))
    rekey_ex = SmartEngine(device="cpu").builder().add_smart_module(
        SmartModuleConfig(), rekey).initialize().gpu_chain
    report = admission.warm_executor(rekey_ex, widths=(100, 70_000))
    assert report.errors == [] and report.buckets == (128,)
    assert report.skipped == ["width 70000: record-too-wide-unstripeable"]
    lit = SmartEngine(device="cpu").builder()
    lit.add_smart_module(SmartModuleConfig(params={"regex": "fluvio"}), lookup("regex-filter"))
    assert {e["kind"] for e in admission.work_list(lit.initialize().gpu_chain, (10,))} == {
        "torch"}


def test_failed_probe_is_reported_logged_and_booked(monkeypatch, caplog):
    pb = SmartEngine(device="cpu").builder()
    pb.add_smart_module(SmartModuleConfig(params={"regex": "fluvio"}), lookup("regex-filter"))
    ex = pb.initialize().gpu_chain
    real = ex.process_buffer

    def flaky(buf):
        if buf.width > 100:
            raise RuntimeError("probe refused")
        return real(buf)

    monkeypatch.setattr(ex, "process_buffer", flaky)
    with caplog.at_level("WARNING", logger=port_warmup.__name__):
        report = admission.warm_executor(ex, widths=(50, 500))
    assert report.buckets == (64,)
    assert report.errors == ["width 500 rows 8: RuntimeError: probe refused"]
    assert any("probe refused" in r.getMessage() for r in caplog.records)
    assert [e["kind"] for e in PORT.T.events_json() if e["kind"] == "warmup-error"]
    assert port_warmup.recent_reports()[-1] is report


# ---------------------------------------------------------------------------
# the gate, the config and the broker seam
# ---------------------------------------------------------------------------

def test_configure_arms_and_disarms_the_gate():
    assert admission.gate() is None and sc._admission_gate() is None
    admission.configure(AdmissionConfig(enabled=True, tokens=5.0, refill=1.0, queue=3,
                                        batch_rows=99, batch_deadline_ms=7.0))
    ctl = admission.gate()
    assert isinstance(ctl, admission.AdmissionController) and admission.gate() is ctl
    assert (ctl.capacity, ctl.refill) == (5.0, 1.0)
    assert admission.FairQueue().max_depth == 3
    bt = admission.ShapeBucketBatcher(lambda f: None)
    assert (bt.row_target, bt.deadline_s) == (99, 0.007)
    assert admission.admission_enabled() and not admission.warmup_enabled()
    admission.configure(AdmissionConfig())
    assert admission.gate() is None
    defaults = AdmissionConfig()
    assert (defaults.refresh_s, defaults.warn_shed, defaults.tokens, defaults.refill,
            defaults.queue, defaults.batch_rows, defaults.batch_deadline_ms) == (
        1.0, 0.5, 64.0, 32.0, 64, 4096, 25.0)
    assert admission.default_widths() == (1024, 65537) and admission.default_rows() == (8,)
    admission.configure(AdmissionConfig(warmup_widths=(10, 20), warmup_rows=(4,)))
    assert admission.default_widths() == (10, 20) and admission.default_rows() == (4,)


def test_spu_config_admission_arms_the_process_gate(tmp_path):
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.server import SpuServer

    cfg = SpuConfig(public_addr="127.0.0.1:0", private_addr="", log_base_dir=str(tmp_path),
                    cleaner_interval_seconds=0, admission=AdmissionConfig(enabled=True))
    cfg.smart_engine.device = "cpu"
    SpuServer(cfg)
    assert admission.gate() is not None
    cfg2 = SpuConfig(public_addr="127.0.0.1:0", private_addr="",
                     log_base_dir=str(tmp_path / "b"), cleaner_interval_seconds=0)
    cfg2.smart_engine.device = "cpu"
    SpuServer(cfg2)  # None leaves the process's gate as it was
    assert admission.gate() is not None


def _port_chain(specs):
    pb = SmartEngine(device="cpu").builder()
    for name, params in specs:
        pb.add_smart_module(SmartModuleConfig(params=params), lookup(name))
    return pb.initialize()


def test_shed_slice_leaves_inflight_queue_depth_unchanged():
    """A breach shed comes before the staging: at the broker seam on both
    packages, and in `stream_slices`, whose held step reads nothing and
    dispatches nothing; the next step serves the same offsets."""
    chain = _port_chain([("regex-filter", {"regex": "fluvio"})])
    rb = RefEngine(backend="tpu").builder()
    rb.add_smart_module(RefConfig(params={"regex": "fluvio"}), ref_lookup("regex-filter"))
    ref_chain = rb.initialize()
    for (name, ctl, clk, slo), (seam, ch, ns) in zip(
            _controllers(), ((ref_sc, ref_chain, REF), (sc, chain, PORT))):
        PKGS[name].set_gate(ctl)
        slo.set(seam.admission_chain_sig(ch), "breach")
        g0 = ns.T.gauge_value("inflight_queue_depth")
        rej = seam.admission_check(ch, tenant="acme")
        assert rej.reason == "breach-shed" and ns.T.gauge_value("inflight_queue_depth") == g0
        assert ns.T.tenant_families()[1] == {"acme": 1}
    from tests.test_torch_isolation import broker_log, slice_reader

    wires, batches = broker_log(gen_json(96, seed=3), 32)
    read = slice_reader(wires, batches, 2000)
    answers = iter([Rejected(chain="x", reason="no-tokens", retry_after_s=0.03), None, None,
                    Rejected(chain="x", reason="breach-shed", retry_after_s=1.0)])
    seen = []

    def admit(flow):
        seen.append(PORT.T.gauge_value("inflight_queue_depth"))
        return next(answers, None)

    steps = list(sc.stream_slices(chain, read, 0, 96, 2000, admit=admit))
    kinds = [type(s).__name__ for s in steps]
    assert kinds[0] == "SliceHold" and steps[0].retry_after_s == 0.03
    assert "SliceHold" in kinds[1:] and kinds.count("BatchProcessResult") >= 2
    assert seen[0] == 0 and PORT.T.gauge_value("inflight_queue_depth") == 0
    results = [s for s in steps if isinstance(s, sc.BatchProcessResult)]
    assert results[-1].next_offset == 96
    plain = [s for s in sc.stream_slices(chain, read, 0, 96, 2000)]
    assert [r.records.total_records() for r in results] == [
        r.records.total_records() for r in plain]


def test_failed_serve_gate_warm_up_lifts_the_gate(monkeypatch):
    admission.configure(AdmissionConfig(enabled=True, warmup=True))
    (_, ctl, clk, slo) = _controllers()[1]
    admission.set_gate(ctl)

    def boom(*a, **k):
        raise RuntimeError("warm-up exploded")

    monkeypatch.setattr(port_warmup, "warm_executor", boom)
    chain = _port_chain([("regex-filter", {"regex": "fluvio"})])
    public_service._schedule_chain_warmup(chain)  # no loop: warms inline
    assert sc.admission_check(chain) is None


class ScriptedGate:
    """A duck-typed controller (`set_gate`) answering from a script, then
    admitting: the same decisions for both SPUs."""

    def __init__(self, pkg, script):
        self.pkg = pkg
        self.script = list(script)
        self.calls = []

    def admit(self, chain, cost=1.0, breaker=None):
        self.calls.append(chain)
        reason = self.script.pop(0) if self.script else "admit"
        if reason == "admit":
            return self.pkg.Decision(True, chain=chain)
        return self.pkg.Rejected(chain=chain, reason=reason, retry_after_s=0.001)

    def note_warm(self, chain, buckets):
        pass

    def require_warm(self, chain, required=True):
        pass


SHED_SCRIPT = ["no-tokens", "admit", "breach-shed", "no-tokens", "admit", "warn-shed", "admit",
               "admit", "cold-chain", "admit", "no-tokens", "no-tokens", "admit"]


def test_both_spus_serve_alike_under_one_scripted_shed_sequence(tmp_path, small_chunks):
    """The north star (dispatch-ahead, chunks of 64 rows) and
    `3_aggregate` (a slice at a time) under one shed script on both SPUs:
    the consumers get the same batches (records, offsets, wire bytes), the
    gates are asked the same number of times with the same keys, the
    tenants' held counts are equal, and no slice stays held."""
    wires = _stored([300, 0, 250, 280, 310, 200], seed=63)
    gates = {}

    async def body(servers):
        for invocations in (north_star_invocations(), _aggregate()):
            for name in PKGS:
                gates[name] = ScriptedGate(PKGS[name], SHED_SCRIPT)
                PKGS[name].set_gate(gates[name])
            served = await _both(servers, invocations, max_bytes=5_000)
            assert len(served) >= 3
            assert gates["port"].calls == gates["ref"].calls
            assert len(gates["port"].calls) >= len(SHED_SCRIPT)

    _run(tmp_path, wires, body)
    for ns in BOTH:
        assert ns.T.gauge_value("held_slices") == 0
    assert PORT.T.tenant_families()[2] == REF.T.tenant_families()[2]
    assert PORT.T.tenant_families()[2]["bench"] >= 2 * 4
    held = [f for f in PORT.T.flows_json() if f.get("phases_ms", {}).get("hold")]
    assert held and {f["decision"] for f in PORT.T.flows_json()} == {"admit"}


def test_serve_gate_warm_up_holds_consumers_cold_then_serves(tmp_path, small_chunks):
    """With the warm-up armed, the first consumer of a fresh chain is held
    ``cold-chain`` while its chain warms on a worker thread under the
    chain's lock, then served the same batches as the JAX server (no
    admission there); the warm's report has no error."""
    wires = _stored([300, 250, 280], seed=64)

    async def body(servers):
        admission.configure(AdmissionConfig(enabled=True, warmup=True,
                                            warmup_widths=(100, 400), warmup_rows=(8, 64)))
        for invocations in (north_star_invocations(), _aggregate()):
            await _both(servers, invocations)

    _run(tmp_path, wires, body)
    reports = port_warmup.recent_reports()
    assert len(reports) == 2 and [r.errors for r in reports] == [[], []]
    assert {r.chain for r in reports} == {"filter+map", "aggregate"}
    assert [r.buckets for r in reports] == [(128, 448), (128, 448)]
    assert PORT.T.admission.get("cold-chain", 0) >= 2 and PORT.T.admission["admit"] >= 2
    assert PORT.T.gauge_value("held_slices") == 0
    assert PORT.T.gauge_value("warmed_buckets") == 4
    assert not public_service._warm_tasks


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _pipeline_run(name: str):
    """64 records in 8 slices through each package's pipeline (json-map,
    coalescing, row target 16), a breach hitting mid-run: every shed slice
    is resubmitted until admitted."""
    pkg = PKGS[name]
    clk, slo = FakeClock(), FakeSlo()
    if name == "ref":
        b = RefEngine(backend="tpu").builder()
        b.add_smart_module(RefConfig(params={"field": "name"}), ref_lookup("json-map"))
        ex = b.initialize().tpu_chain
    else:
        ex = _port_chain([("json-map", {"field": "name"})]).gpu_chain
    served = []

    def dispatch(flush):
        out = ex.process_buffer(flush.buffer)
        for k, part in enumerate(pkg.split_output(out, flush.bases)):
            served.extend((flush.cause, k, bytes(v), d) for v, d in part)

    ctl = pkg.AdmissionController(slo_engine=slo, clock=clk, rng=random.Random(3),
                                  refresh_s=1.0, tokens=1e9, refill=1e9)
    pipe = pkg.AdmissionPipeline(dispatch, controller=ctl,
                                 queue=pkg.FairQueue(max_depth=1000, clock=clk),
                                 batcher=pkg.ShapeBucketBatcher(dispatch, row_target=16,
                                                                deadline_s=0.05, clock=clk),
                                 clock=clk)
    pipe.register_chain("map", coalesce=True)
    ids = [f"rec-{i:04d}" for i in range(64)]
    sheds = []
    for idx in range(8):
        buf = _buf(name, [b'{"name":"%s"}' % i.encode() for i in ids[idx * 8: idx * 8 + 8]])
        clk.advance(1.1)
        if idx == 2:
            slo.set("map", "breach")
        for _attempt in range(50):
            d = pipe.submit("map", buf, tenant=f"t{idx % 2}")
            if d:
                break
            sheds.append(_d(d))
            clk.advance(max(d.retry_after_s, 1.1))
            slo.clear()
        else:
            pytest.fail("slice never admitted")
        pipe.pump()
    pipe.drain()
    return served, sheds, ids


def test_pipeline_exactly_once_across_shed_and_resubmit_equal_reference():
    ref_served, ref_sheds, ids = _pipeline_run("ref")
    served, sheds, _ = _pipeline_run("port")
    assert served == ref_served and sheds == ref_sheds
    assert sheds and sheds[0][2] == "breach-shed"
    assert Counter(v.decode().lower() for _, _, v, _ in served) == Counter(ids)
    assert PORT.T.admission == REF.T.admission
    assert PORT.T.tenant_families()[1] == REF.T.tenant_families()[1]
    assert PORT.T.gauge_value("admission_queue_depth") == 0
    flows = PORT.T.flows_json()
    assert len(flows) == 8 and all("batcher" in f.get("phases_ms", {}) for f in flows)
