"""The port's resilience ladder (`fluvio_tpu_torch.resilience` and its
seams) against the JAX package's, on the CPU: the counterpart of
``tests/test_resilience.py``, class by class.

Each chaos test arms the same schedule in both fault registries and runs
the same seeded slabs through the JAX engine (``backend="tpu"``, JAX on
the CPU) and the port's (``device="cpu"``), at tolerance 0: records,
transform errors, retries by point, spills by reason, breaker states and
transitions, quarantine counts. Both packages retry without sleeping (the
JAX side's ``FLUVIO_RETRY_BASE_MS=0``, the port's
``ResilienceConfig(retry_base_ms=0)``).

The port has no second execution path: its re-run of a failed batch runs
the same kernels on the card and passes the card's seams again, where the
JAX package re-runs the batch in its interpreter. So the equality tests
arm schedules both packages survive, and each says why: ``first=1`` or
``first=2`` armed for one batch (the re-run's hit does not fire), or
``every=N`` with N above the port's hits a batch. A fault that fires on
every dispatch is the kept divergence (`ROADMAP.md` §3): the JAX package
delivers through its interpreter, the port quarantines the batch
(`TestQuarantine.test_every_dispatch_fault_divergence_is_pinned`).
"""

from __future__ import annotations

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol.record import Record as RefRecord
from fluvio_tpu.resilience import deadletter as ref_deadletter
from fluvio_tpu.resilience import faults as ref_faults
from fluvio_tpu.resilience import policy as ref_policy
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartmodule.types import SmartModuleInput as RefInput
from fluvio_tpu.telemetry import TELEMETRY as REF_TELEMETRY
from fluvio_tpu.telemetry import render_prometheus as ref_render_prometheus
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol.record import Record
from fluvio_tpu_torch.resilience import faults
from fluvio_tpu_torch.resilience.deadletter import load_entry, quarantine_batch
from fluvio_tpu_torch.resilience.faults import FaultRegistry, InjectedFault
from fluvio_tpu_torch.resilience.policy import (
    CLOSED,
    DETERMINISTIC,
    FATAL,
    OPEN,
    TRANSIENT,
    CircuitBreaker,
    ResilienceConfig,
    RetryPolicy,
    classify,
)
from fluvio_tpu_torch.smartengine import (
    GpuSpill,
    LinkParams,
    SmartEngine,
    SmartModuleConfig,
)
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartmodule.types import SmartModuleInput
from fluvio_tpu_torch.telemetry import TELEMETRY, render_prometheus
from fluvio_tpu_torch.telemetry import memory
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

GENERIC_POINTS = ("stage", "h2d", "dispatch", "device", "fetch")
HEADLINE = (("regex-filter", {"regex": "fluvio"}), ("json-map", {"field": "name"}))
AGG = (("aggregate-sum", {}),)
FAST = ResilienceConfig(retry_base_ms=0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # the JAX side reads its retry knob when a chain is built, and runs its
    # Pallas kernels in interpret mode on the CPU
    monkeypatch.setenv("FLUVIO_RETRY_BASE_MS", "0")
    monkeypatch.setenv("FLUVIO_TPU_PALLAS", "interpret")
    monkeypatch.setenv("FLUVIO_DFA_PALLAS", "interpret")
    for reg in (ref_faults.FAULTS, faults.FAULTS):
        reg.clear()
    REF_TELEMETRY.reset()
    TELEMETRY.reset()
    memory.reset_engine()
    yield
    for reg in (ref_faults.FAULTS, faults.FAULTS):
        reg.clear()
    REF_TELEMETRY.reset()
    TELEMETRY.reset()


def _arm(point, **kw):
    """The same rule in both registries; returns (JAX rule, port rule)."""
    return ref_faults.FAULTS.inject(point, **kw), faults.FAULTS.inject(point, **kw)


def _disarm():
    ref_faults.FAULTS.clear()
    faults.FAULTS.clear()


def _ref_build(modules=HEADLINE, backend="tpu"):
    b = RefEngine(backend=backend).builder()
    for name, params in modules:
        cfg = RefConfig(params=dict(params))
        if name.startswith("aggregate"):
            cfg.initial_data = b"0"
        b.add_smart_module(cfg, ref_lookup(name))
    chain = b.initialize()
    if backend == "tpu":
        assert chain.backend_in_use == "tpu"
    return chain


def _port_build(modules=HEADLINE, resilience=FAST, **engine):
    b = SmartEngine(device="cpu", resilience=resilience, **engine).builder()
    for name, params in modules:
        cfg = SmartModuleConfig(params=dict(params))
        if name.startswith("aggregate"):
            cfg.initial_data = b"0"
        b.add_smart_module(cfg, lookup(name))
    chain = b.initialize()
    assert chain.gpu_chain is not None
    return chain


def _values(k: int, rows: int, agg: bool):
    if agg:
        return [b"%d" % (k * 100 + i) for i in range(rows)]
    names = (b"fluvio", b"kafka", b"fluvio-tpu", b"pulsar")
    return [b'{"name":"%s-%d","n":%d}' % (names[(k + i) % 4], i, i) for i in range(rows)]


def _slabs(n=3, rows=96, agg=False):
    """(JAX inputs, port inputs) of the same seeded records."""
    ref, port = [], []
    for k in range(n):
        vals = _values(k, rows, agg)
        ref.append(RefInput.from_records(
            [RefRecord(value=v, offset_delta=i) for i, v in enumerate(vals)]))
        port.append(SmartModuleInput.from_records(
            [Record(value=v, offset_delta=i) for i, v in enumerate(vals)]))
    return ref, port


def _run(chain, slabs):
    outs = []
    for s in slabs:
        out = chain.process(s)
        assert out.error is None
        outs.append([(r.key, r.value) for r in out.successes])
    return outs


def _counters(tel) -> dict:
    c = tel.snapshot()["counters"]
    return {
        "retries": dict(c["retries"]),
        "spills": dict(c["spills"]),
        "quarantined": c["quarantined"],
        "transitions": dict(c["breaker"]["transitions"]),
        "short_circuits": c["breaker"]["short_circuits"],
    }


def _both_counters_equal() -> dict:
    port = _counters(TELEMETRY)
    assert port == _counters(REF_TELEMETRY)
    return port


def _acc(chain) -> int:
    ex = chain.gpu_chain if hasattr(chain, "gpu_chain") else chain.tpu_chain
    ex._ensure_host_state()
    return ex.carries[0][0]


def _drained() -> None:
    """No batch handle left live, every transient ledger owner at 0."""
    assert TELEMETRY.gauge_value("live_batch_handles") == 0
    memory.engine().assert_drained()


def _bufs(slabs):
    return [RecordBuffer.from_smartmodule_input(s) for s in slabs]


def _values_of(out_bufs):
    return [[(r.key, r.value) for r in b.to_records()] for b in out_bufs]


# ---------------------------------------------------------------------------
# harness: spec grammar, trigger modes, classifier, budgets
# ---------------------------------------------------------------------------


class TestFaultHarness:
    def test_spec_grammar_matches_the_reference(self):
        spec = "device:first=2;fetch:every=3,exc=deterministic;h2d:prob=0.5,seed=1"
        ref, port = ref_faults.FaultRegistry(), FaultRegistry()
        ref.load_env_spec(spec)
        port.load_env_spec(spec)
        for point in ("device", "fetch", "h2d"):
            a, b = ref.rule(point), port.rule(point)
            assert (b.every, b.first, b.prob, b.exc) == (a.every, a.first, a.prob, a.exc)
        assert faults.FAULT_POINTS == ref_faults.FAULT_POINTS

    @pytest.mark.parametrize("spec", [
        "bogus-point:first=1",
        "device:first=1,every=2",  # two trigger modes
        "device:exc=weird,first=1",
        "device:nope=3",
    ])
    def test_spec_rejects_malformed(self, spec):
        for reg in (ref_faults.FaultRegistry(), FaultRegistry()):
            with pytest.raises(ValueError):
                reg.load_env_spec(spec)

    @pytest.mark.parametrize("trigger", [{"first": 2}, {"every": 3}, {"prob": 0.4, "seed": 9}])
    def test_trigger_modes_match_the_reference(self, trigger):
        fired = []
        for reg, exc in ((ref_faults.FaultRegistry(), ref_faults.InjectedFault),
                         (FaultRegistry(), InjectedFault)):
            rule = reg.inject("device", **trigger)
            seq = []
            for _ in range(12):
                try:
                    reg.fire("device")
                    seq.append(False)
                except exc:
                    seq.append(True)
            assert rule.hits == 12 and rule.fired == sum(seq)
            fired.append(seq)
        assert fired[0] == fired[1]

    def test_spec_arms_all_or_nothing(self):
        reg = FaultRegistry()
        with pytest.raises(ValueError):
            reg.load_env_spec("device:first=1;fetch:evry=3")
        assert not reg.armed
        with pytest.raises(ValueError):
            reg.load_env_spec("device:first=1;bogus-point:first=1")
        assert not reg.armed

    def test_unarmed_seam_is_noop(self):
        assert not faults.FAULTS.armed
        faults.maybe_fire("device")  # must not raise
        assert faults._ARMED is None

    def test_instance_template_yields_fresh_exception_per_fire(self):
        reg = FaultRegistry()
        reg.inject("device", every=1, exc=InjectedFault("device", transient=False))
        raised = []
        for _ in range(2):
            try:
                reg.fire("device")
            except InjectedFault as e:
                raised.append(e)
        assert raised[0] is not raised[1], "the template is copied a fire"
        assert all(not e.transient for e in raised)

    @pytest.mark.parametrize("exc, want", [
        (InjectedFault("device"), TRANSIENT),
        (InjectedFault("device", transient=False), DETERMINISTIC),
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
         TRANSIENT),
        (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), TRANSIENT),
        (ConnectionResetError(), TRANSIENT),
        (TimeoutError("download"), TRANSIENT),
        (OSError("pinned host alloc failed"), TRANSIENT),
        (ValueError("bad lowering"), DETERMINISTIC),
        (RuntimeError("plain bug"), DETERMINISTIC),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), FATAL),
        (RuntimeError("CUDA error: device-side assert triggered"), FATAL),
        (RuntimeError("CUDA error: unspecified launch failure"), FATAL),
        (RuntimeError("CUDA error: misaligned address"), FATAL),
    ])
    def test_classifier(self, exc, want):
        assert classify(exc) == want
        assert RetryPolicy().should_retry(exc, 0) == (want == TRANSIENT)

    def test_classifier_agrees_with_the_reference_outside_the_card_vocabulary(self):
        for exc in (InjectedFault("x"), InjectedFault("x", transient=False),
                    ConnectionResetError(), ValueError("bad"), RuntimeError("plain bug")):
            ref_exc = (ref_faults.InjectedFault(exc.point, exc.transient)
                       if isinstance(exc, InjectedFault) else exc)
            assert classify(exc) == ref_policy.classify(ref_exc)

    def test_retry_policy_backoff_monotone_and_capped(self):
        p = RetryPolicy(ResilienceConfig(retry_max=3, retry_base_ms=2, retry_cap_ms=8,
                                         retry_jitter=0.0))
        ref = ref_policy.RetryPolicy(max_retries=3, base_ms=2, cap_ms=8, jitter=0.0)
        assert [p.backoff_s(a) for a in range(4)] == [0.002, 0.004, 0.008, 0.008]
        assert [p.backoff_s(a) for a in range(4)] == [ref.backoff_s(a) for a in range(4)]
        assert p.should_retry(InjectedFault("x"), 2)
        assert not p.should_retry(InjectedFault("x"), 3)
        assert not p.should_retry(InjectedFault("x", transient=False), 0)

    def test_config_defaults_are_the_references(self, monkeypatch):
        monkeypatch.delenv("FLUVIO_RETRY_BASE_MS")
        ref_r, port_r = ref_policy.RetryPolicy(), RetryPolicy()
        assert ((port_r.max_retries, port_r.base_ms, port_r.cap_ms, port_r.jitter)
                == (ref_r.max_retries, ref_r.base_ms, ref_r.cap_ms, ref_r.jitter))
        ref_b, port_b = ref_policy.CircuitBreaker(name="r"), CircuitBreaker(name="p")
        assert ((port_b.threshold, port_b.window_s, port_b.cooldown_s, port_b.probes)
                == (ref_b.threshold, ref_b.window_s, ref_b.cooldown_s, ref_b.probes))
        cfg = ResilienceConfig()
        assert cfg.deadletter_dir == ref_deadletter.deadletter_dir()
        assert cfg.deadletter_max == ref_deadletter.deadletter_max()
        custom = ResilienceConfig(retry_max=5, breaker_probes=4)
        assert RetryPolicy(custom).max_retries == 5
        assert CircuitBreaker(custom, name="c").probes == 4


# ---------------------------------------------------------------------------
# chaos: one transient fault a point, zero divergence
# ---------------------------------------------------------------------------


class TestChaosZeroDivergence:
    @pytest.mark.parametrize("point", GENERIC_POINTS)
    def test_transient_fault_is_invisible(self, point):
        """first=1: the first hit fires, the retry's hit does not, in both
        packages."""
        ref_slabs, port_slabs = _slabs()
        ref_chain, port_chain = _ref_build(), _port_build()
        truth = _run(_ref_build(backend="python"), ref_slabs)
        _arm(point, first=1)
        ref_out, port_out = _run(ref_chain, ref_slabs), _run(port_chain, port_slabs)
        assert port_out == ref_out == truth
        counters = _both_counters_equal()
        assert counters["retries"] == {point: 1} and not counters["spills"]
        assert port_chain.breaker.state == ref_chain.breaker.state == CLOSED
        # the retry's own time is booked at its point
        assert set(TELEMETRY.retry_seconds) == {point} and TELEMETRY.retry_seconds[point] > 0

    @pytest.mark.parametrize("point", GENERIC_POINTS)
    def test_transient_fault_in_a_pipelined_stream(self, point):
        """`process_stream` with two batches in flight, first=2: two
        retries at the point, the stream exact."""
        ref_slabs, port_slabs = _slabs(n=4)
        ref_ex, port_ex = _ref_build().tpu_chain, _port_build().gpu_chain
        truth = _values_of(port_ex.process_stream(_bufs(port_slabs)))
        _arm(point, first=2)
        from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer

        ref_out = _values_of(ref_ex.process_stream(
            [RefBuffer.from_smartmodule_input(s) for s in ref_slabs]))
        port_out = _values_of(port_ex.process_stream(_bufs(port_slabs)))
        assert port_out == ref_out == truth
        assert _both_counters_equal()["retries"] == {point: 2}
        assert set(TELEMETRY.retry_seconds) == {point} and TELEMETRY.retry_seconds[point] > 0
        _drained()

    def test_deterministic_fault_reruns_on_the_card(self):
        """first=1, deterministic: the fused attempt fails, the re-run's hit
        does not fire; no retry, one ``fused-error`` spill."""
        ref_slabs, port_slabs = _slabs()
        ref_chain, port_chain = _ref_build(), _port_build()
        _arm("device", first=1, exc="deterministic")
        assert _run(port_chain, port_slabs) == _run(ref_chain, ref_slabs)
        counters = _both_counters_equal()
        assert counters["spills"] == {"fused-error": 1}
        assert not counters["retries"], "deterministic faults are not retried"

    @pytest.mark.parametrize("point", ["glz_decode", "glz_encode"])
    def test_link_seams_retry_the_same_kernels(self, point):
        """With the glz link on, a transient fault at its seam retries the
        same link form (the JAX package demotes its decode or encode rung
        instead; the port has no rung to give way to)."""
        rng = np.random.default_rng(7)
        vals = [b'{"name":"fluvio-%d","pad":"%s"}' % (int(i), b"ab" * int(i % 40))
                for i in rng.integers(0, 1000, 4000)]
        inp = SmartModuleInput.from_records([Record(value=v, offset_delta=i)
                                             for i, v in enumerate(vals)])
        link = LinkParams(compress=True, result_compress=True, chunk=1 << 14)
        truth = _run(_port_build(), [inp])
        chain = _port_build(link=link)
        faults.FAULTS.inject(point, first=1)
        assert _run(chain, [inp]) == truth
        assert _counters(TELEMETRY)["retries"] == {point: 1}
        assert chain.gpu_chain.link_counts["glz"] >= 1

    def test_card_out_of_memory_is_retried(self, monkeypatch):
        """A `torch.cuda.OutOfMemoryError` in the chain's run is transient:
        the dispatch retries once and the output is exact."""
        ref_slabs, port_slabs = _slabs(n=1)
        chain = _port_build()
        ex = chain.gpu_chain
        inner, calls = ex._run, [0]

        def run(*a, **kw):
            calls[0] += 1
            if calls[0] == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")
            return inner(*a, **kw)

        monkeypatch.setattr(ex, "_run", run)
        assert _run(chain, port_slabs) == _run(_ref_build(), ref_slabs)
        assert _counters(TELEMETRY)["retries"] == {"dispatch": 1}

    def test_sticky_cuda_error_is_fatal_and_propagates(self, monkeypatch, tmp_path):
        """A sticky CUDA context error at the first wait is never retried,
        re-run or quarantined: it ends the stream."""
        _ref_slabs, port_slabs = _slabs(n=1)
        chain = _port_build(resilience=ResilienceConfig(retry_base_ms=0,
                                                        deadletter_dir=str(tmp_path)))
        ex = chain.gpu_chain

        def finish(buf, handle):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(ex, "_finish", finish)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            chain.process(port_slabs[0])
        counters = _counters(TELEMETRY)
        assert not counters["retries"] and counters["quarantined"] == 0
        assert counters["spills"] == {"fused-error": 1}
        assert not os.listdir(tmp_path)
        assert chain.breaker.state == CLOSED  # a fatal error is no breaker failure


# ---------------------------------------------------------------------------
# aggregate carries: a retry never counts a batch twice
# ---------------------------------------------------------------------------


class TestCarrySafety:
    def test_carry_exact_across_mid_stream_retry(self):
        """every=3 at ``device``: one hit a batch in both packages, so the
        third batch's first wait fires, after the carry holds two batches."""
        ref_slabs, port_slabs = _slabs(n=4, agg=True)
        py = _ref_build(AGG, backend="python")
        truth = _run(py, ref_slabs)
        ref_chain, port_chain = _ref_build(AGG), _port_build(AGG)
        _arm("device", every=3)
        assert _run(port_chain, port_slabs) == _run(ref_chain, ref_slabs) == truth
        assert str(_acc(port_chain)).encode() == py.instances[0].accumulator
        assert _both_counters_equal()["retries"] == {"device": 1}

    @pytest.mark.parametrize("point", ["device", "fetch"])
    def test_running_totals_exact_across_a_retry_in_a_pipelined_stream(self, point):
        """A transient fault at the third batch's finish in a 4-batch
        `process_stream` (every=3: one hit a finish): the fourth batch, in
        flight from the third's old result, runs again from the repaired
        one; every batch's running totals are the interpreter's."""
        ref_slabs, port_slabs = _slabs(n=4, agg=True)
        truth = _run(_ref_build(AGG, backend="python"), ref_slabs)
        ex = _port_build(AGG).gpu_chain
        faults.FAULTS.inject(point, every=3)
        outs = _values_of(ex.process_stream(_bufs(port_slabs)))
        assert outs == truth
        assert _counters(TELEMETRY)["retries"] == {point: 1}
        ex._ensure_host_state()
        assert ex.carries[0][0] == int(truth[-1][-1][1])
        _drained()
        assert not ex._inflight

    def test_a_failed_re_dispatch_of_the_later_batch_is_retried_at_its_finish(self):
        """Two batches in flight; the first's finish fails at ``fetch`` and
        its retry re-runs the second from the repaired tip, whose ``stage``
        fails there (first=1 each): the second's own finish retries it."""
        ref_slabs, port_slabs = _slabs(n=2, agg=True)
        truth = _run(_ref_build(AGG, backend="python"), ref_slabs)
        ex = _port_build(AGG).gpu_chain
        bufs = _bufs(port_slabs)
        h0, h1 = ex.dispatch_buffer(bufs[0]), ex.dispatch_buffer(bufs[1])
        faults.FAULTS.inject("fetch", first=1)
        faults.FAULTS.inject("stage", first=1)
        outs = _values_of([ex.finish_buffer(bufs[0], h0), ex.finish_buffer(bufs[1], h1)])
        assert outs == truth
        assert _counters(TELEMETRY)["retries"] == {"fetch": 1, "stage": 1}
        ex._ensure_host_state()
        assert ex.carries[0][0] == int(truth[-1][-1][1])

    def test_abandoned_batch_leaves_the_later_one_its_starting_carries(self):
        """The first of two in-flight batches is given up (a deterministic
        ``fetch`` fault): the second, dispatched from its result, runs
        again from where the first found the carries."""
        ref_slabs, port_slabs = _slabs(n=2, agg=True)
        truth_second = _run(_ref_build(AGG, backend="python"), ref_slabs[1:])
        ex = _port_build(AGG).gpu_chain
        bufs = _bufs(port_slabs)
        h0, h1 = ex.dispatch_buffer(bufs[0]), ex.dispatch_buffer(bufs[1])
        faults.FAULTS.inject("fetch", first=1, exc="deterministic")
        with pytest.raises(InjectedFault):
            ex.finish_buffer(bufs[0], h0)
        assert _values_of([ex.finish_buffer(bufs[1], h1)]) == truth_second

    def test_pipelined_stateless_stream_retry(self):
        """every=2 at ``fetch`` through the pipelined loop: every yielded
        batch is the fault-free one."""
        _ref_slabs, port_slabs = _slabs(n=4)
        ex = _port_build().gpu_chain
        ref = _values_of(ex.process_stream(_bufs(port_slabs)))
        faults.FAULTS.inject("fetch", every=2)
        assert _values_of(ex.process_stream(_bufs(port_slabs))) == ref
        assert _counters(TELEMETRY)["retries"]["fetch"] >= 1

    def test_partition_retry_lands_in_the_partition_slot(self):
        """The partition runtime, two partitions interleaved two deep: a
        retried batch's carries land in its own partition's slot."""
        from fluvio_tpu_torch.partition import PartitionRuntime, parse_placement_rules
        from fluvio_tpu_torch.partition import plan_placement

        ref_slabs, port_slabs = _slabs(n=4, agg=True)
        ex = _port_build(AGG).gpu_chain
        plan = plan_placement(parse_placement_rules(".*=spread"), [], 2)
        rt = PartitionRuntime(ex, plan, devices=[torch.device("cpu")])
        faults.FAULTS.inject("fetch", every=2)
        items = [("t", k % 2, b) for k, b in enumerate(_bufs(port_slabs))]
        outs = {k: [] for k in (0, 1)}
        for _t, p, _b, out in rt.process_interleaved(items, depth=2):
            outs[p].append([(r.key, r.value) for r in out.to_records()])
        for p in (0, 1):
            truth = _run(_ref_build(AGG, backend="python"), ref_slabs[p::2])
            assert outs[p] == truth
            assert rt.carry_snapshot("t", p)[0][0] == int(truth[-1][-1][1])
        assert _counters(TELEMETRY)["retries"]["fetch"] >= 1


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class TestCircuitBreaker:
    def _breakers(self, **kw):
        """The JAX package's and the port's breaker on one fake clock."""
        t = [0.0]
        kw = {"threshold": 3, "window_s": 10.0, "cooldown_s": 5.0, "probes": 2, **kw}
        cfg = ResilienceConfig(breaker_threshold=kw["threshold"], breaker_window_s=kw["window_s"],
                               breaker_cooldown_s=kw["cooldown_s"], breaker_probes=kw["probes"])
        return (ref_policy.CircuitBreaker(clock=lambda: t[0], name="ref", **kw),
                CircuitBreaker(cfg, name="port", clock=lambda: t[0]), t)

    def _drive(self, steps, **kw):
        ref, port, t = self._breakers(**kw)
        for step in steps:
            if isinstance(step, float):
                t[0] = step
                continue
            outs = [getattr(b, step)() for b in (ref, port)]
            assert outs[0] == outs[1], step
            assert port.state == ref.state, step
        assert (TELEMETRY.snapshot()["counters"]["breaker"]["transitions"]
                == REF_TELEMETRY.snapshot()["counters"]["breaker"]["transitions"])
        return port

    def test_opens_at_threshold_within_window(self):
        port = self._drive(["record_failure"] * 3 + ["allow_fused"])
        assert port.state == OPEN

    def test_window_expiry_forgives_old_failures(self):
        port = self._drive(["record_failure", "record_failure", 11.0, "record_failure"])
        assert port.state == CLOSED

    def test_half_open_probe_cycle(self):
        port = self._drive(["record_failure"] * 3 + [4.9, "allow_fused", 5.1, "allow_fused",
                                                     "record_success", "record_success"])
        assert port.state == CLOSED
        assert TELEMETRY.snapshot()["counters"]["breaker"]["transitions"] == {
            "open": 1, "half_open": 1, "closed": 1}

    def test_probe_failure_reopens(self):
        port = self._drive(["record_failure"] * 3 + [6.0, "allow_fused", "record_failure",
                                                     10.0, "allow_fused"])
        assert port.state == OPEN

    def test_spills_do_not_trip_the_breaker(self, monkeypatch):
        """A `GpuSpill` is a capability gap, not card health: it propagates
        and is no breaker failure."""
        chain = _port_build()
        chain.breaker.threshold = 2

        def spill(inp, metrics=None):
            raise GpuSpill("record too wide", reason="record-too-wide-unstripeable")

        monkeypatch.setattr(chain.gpu_chain, "process", spill)
        for _ in range(4):
            with pytest.raises(GpuSpill):
                chain.process(_slabs(n=1)[1][0])
        assert chain.breaker.state == CLOSED
        assert _counters(TELEMETRY)["spills"] == {"record-too-wide-unstripeable": 4}

    def test_chain_demotes_and_repromotes(self):
        """The reference's demote-and-repromote sequence, with ``device``
        armed first=1 (deterministic) before each failing batch: its re-run
        hit does not fire in either package. While the breaker is open the
        fused attempt is skipped (a short circuit) and the re-run is exact;
        a transient ``spill_rerun`` fault retries there."""
        ref_slabs, port_slabs = _slabs(n=1)
        ref_chain, port_chain = _ref_build(), _port_build()
        t = [0.0]
        for br in (ref_chain.breaker, port_chain.breaker):
            br.threshold, br.window_s, br.cooldown_s, br.probes = 2, 100.0, 50.0, 1
            br.clock = lambda: t[0]
        truth = _run(_ref_build(backend="python"), ref_slabs)

        def step(state):
            assert _run(port_chain, port_slabs) == _run(ref_chain, ref_slabs) == truth
            assert port_chain.breaker.state == ref_chain.breaker.state == state
            return _both_counters_equal()

        _arm("device", first=1, exc="deterministic")
        step(CLOSED)  # failure 1
        _arm("device", first=1, exc="deterministic")
        step(OPEN)  # failure 2 trips it
        _disarm()
        assert step(OPEN)["short_circuits"] == 1
        _arm("spill_rerun", first=1)
        counters = step(OPEN)
        assert counters["retries"] == {"spill_rerun": 1} and counters["quarantined"] == 0
        assert counters["short_circuits"] == 2
        _disarm()
        t[0] = 51.0
        counters = step(CLOSED)
        assert counters["transitions"] == {"open": 1, "half_open": 1, "closed": 1}
        assert counters["spills"] == {"fused-error": 2}
        states = TELEMETRY.snapshot()["counters"]["breaker"]["states"]
        assert states[port_chain.breaker.name] == CLOSED

    def test_every_card_segment_has_its_breaker(self):
        """A DSL run cut in two is two card segments, each with a breaker,
        named as the reference names its breakers (``chain-<n>``)."""
        chain = SmartEngine(device="cpu").builder()
        for name in ("array-map-lines", "array-map-lines"):
            chain.add_smart_module(SmartModuleConfig(), lookup(name))
        chain = chain.initialize()
        names = [b.name for b in chain.breakers]
        assert len(set(names)) == 2 and all(n.startswith("chain-") for n in names)
        states = TELEMETRY.snapshot()["counters"]["breaker"]["states"]
        assert all(states[n] == CLOSED for n in names)


# ---------------------------------------------------------------------------
# poison-batch quarantine
# ---------------------------------------------------------------------------


def _arm_poison(**kw):
    """``device`` and ``spill_rerun`` both failing deterministically on
    every hit: the fused attempt and the re-run fail."""
    _arm("device", every=1, exc="deterministic", **kw)
    _arm("spill_rerun", every=1, exc="deterministic", **kw)


def _dl(tmp_path, **kw):
    return ResilienceConfig(retry_base_ms=0, deadletter_dir=str(tmp_path), **kw)


class TestQuarantine:
    def test_round_trip_and_stream_advances(self, monkeypatch, tmp_path):
        monkeypatch.setenv("FLUVIO_DEADLETTER_DIR", str(tmp_path / "ref"))
        ref_slabs, port_slabs = _slabs(n=2)
        ref_chain = _ref_build()
        port_chain = _port_build(resilience=_dl(tmp_path / "port"))
        _arm_poison()
        outs = [ref_chain.process(ref_slabs[0]), port_chain.process(port_slabs[0])]
        assert all(o.error is None and not o.successes for o in outs)
        _disarm()
        assert _run(port_chain, port_slabs[1:]) == _run(ref_chain, ref_slabs[1:])
        assert _both_counters_equal()["quarantined"] == 1
        _drained()
        (entry,) = os.listdir(tmp_path / "port")
        spec, inp = load_entry(str(tmp_path / "port" / entry))
        (ref_entry,) = os.listdir(tmp_path / "ref")
        ref_spec, _ = ref_deadletter.load_entry(str(tmp_path / "ref" / ref_entry))
        assert spec == ref_spec
        doc = json.loads((tmp_path / "port" / entry).read_text())
        assert "device" in doc["errors"]["fused"]
        assert "spill_rerun" in doc["errors"]["interpreter"]
        assert _run(_port_build(), [inp]) == _run(_ref_build(), ref_slabs[:1])

    def test_dead_letter_dir_is_bounded(self, tmp_path):
        chain = _port_build(resilience=_dl(tmp_path, deadletter_max=2))
        _arm_poison()
        for s in _slabs(n=3, rows=8)[1]:
            chain.process(s)
        _disarm()
        assert _counters(TELEMETRY)["quarantined"] == 3
        assert len(os.listdir(tmp_path)) == 2, "the oldest entry is evicted"
        assert TELEMETRY.snapshot()["gauges"]["deadletter_entries"] == 2

    def test_unserializable_chain_spec_never_crashes(self, tmp_path):
        inp = _slabs(n=1, rows=2)[1][0]
        path = quarantine_batch(
            [{"name": "m", "kind": "filter", "params": {"pat": b"\xff\x00"}}],
            inp, RuntimeError("fused"), RuntimeError("re-run"),
            ResilienceConfig(deadletter_dir=str(tmp_path)))
        assert path is not None, "a repr-degraded spec still writes"
        spec, _ = load_entry(path)
        assert spec[0]["name"] == "m"
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    def test_spu_keeps_its_dead_letter_dir_under_its_log_dir(self, tmp_path):
        """An SPU's default dead-letter directory is its own, under
        ``log_base_dir``; one set explicitly stays as it is."""
        from fluvio_tpu_torch.spu.config import SmartEngineConfig, SpuConfig

        cfg = SpuConfig(log_base_dir=str(tmp_path / "spu"))
        assert cfg.smart_engine.resilience.deadletter_dir == str(tmp_path / "spu" / "deadletter")
        assert ResilienceConfig().deadletter_dir == ref_deadletter.deadletter_dir()
        shared = SmartEngineConfig()
        SpuConfig(log_base_dir=str(tmp_path / "a"), smart_engine=shared)
        assert shared.resilience.deadletter_dir == ResilienceConfig().deadletter_dir
        own = SmartEngineConfig(resilience=ResilienceConfig(deadletter_dir=str(tmp_path / "x")))
        assert (SpuConfig(log_base_dir=str(tmp_path / "b"), smart_engine=own)
                .smart_engine.resilience.deadletter_dir == str(tmp_path / "x"))

    def test_unwritable_dir_still_counts(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        chain = _port_build(resilience=_dl(blocker / "dl"))
        _arm_poison()
        out = chain.process(_slabs(n=1)[1][0])
        _disarm()
        assert out.error is None and not out.successes
        assert _counters(TELEMETRY)["quarantined"] == 1

    def test_quarantined_aggregate_batch_leaves_every_carry(self, tmp_path):
        """The poison batch contributes nothing: the batch after it
        aggregates from where the batch before it left the sum, as the
        JAX package's does."""
        ref_slabs, port_slabs = _slabs(n=3, agg=True)
        ref_chain, port_chain = _ref_build(AGG), _port_build(AGG, resilience=_dl(tmp_path))
        outs = [_run(port_chain, port_slabs[:1]), _run(ref_chain, ref_slabs[:1])]
        assert outs[0] == outs[1]
        before = _acc(port_chain)
        _arm_poison()
        assert not port_chain.process(port_slabs[1]).successes
        assert not ref_chain.process(ref_slabs[1]).successes
        _disarm()
        assert _acc(port_chain) == before
        assert _run(port_chain, port_slabs[2:]) == _run(ref_chain, ref_slabs[2:])
        truth = _run(_ref_build(AGG, backend="python"), [ref_slabs[0], ref_slabs[2]])
        assert _run(_port_build(AGG), [port_slabs[0], port_slabs[2]]) == truth
        assert _acc(port_chain) == _acc(ref_chain)

    def test_quarantine_rolls_back_a_half_advanced_re_run(self, tmp_path, monkeypatch):
        """A re-run that moves the carries before it fails contributes
        nothing: the quarantine restores the pass's starting state."""
        ref_slabs, port_slabs = _slabs(n=2, agg=True)
        chain = _port_build(AGG, resilience=_dl(tmp_path))
        ex = chain.gpu_chain
        inner = ex.process

        def evil(inp, metrics=None):
            inner(inp, metrics)  # advances the carries on the card
            raise RuntimeError("re-run dies after its run")

        faults.FAULTS.inject("device", first=1, exc="deterministic")
        monkeypatch.setattr(ex, "process", lambda inp, metrics=None: (
            monkeypatch.setattr(ex, "process", evil) or inner(inp, metrics)))
        assert not chain.process(port_slabs[0]).successes
        monkeypatch.setattr(ex, "process", inner)
        assert _acc(chain) == 0
        truth = _run(_ref_build(AGG, backend="python"), ref_slabs[1:])
        assert _run(chain, port_slabs[1:]) == truth

    def test_entries_cross_packages(self, tmp_path):
        """A port entry reads back through the JAX package's `load_entry`,
        and a JAX entry through the port's: the same records either way."""
        ref_slabs, port_slabs = _slabs(n=1, rows=5)
        spec = [{"name": "regex-filter", "kind": "filter", "params": {"regex": "fluvio"}}]
        p_path = quarantine_batch(spec, port_slabs[0], RuntimeError("a"), RuntimeError("b"),
                                  ResilienceConfig(deadletter_dir=str(tmp_path / "p")))
        r_path = ref_deadletter.quarantine_batch(spec, ref_slabs[0], RuntimeError("a"),
                                                 RuntimeError("b"), directory=str(tmp_path / "r"))
        r_spec, r_inp = ref_deadletter.load_entry(p_path)
        p_spec, p_inp = load_entry(r_path)
        assert r_spec == p_spec == spec
        assert ([(r.value, r.key, r.offset_delta) for r in r_inp.into_records()]
                == [(r.value, r.key, r.offset_delta) for r in p_inp.into_records()]
                == [(r.value, r.key, r.offset_delta) for r in port_slabs[0].into_records()])
        assert (set(json.loads(open(p_path).read()))
                == set(json.loads(open(r_path).read())))

    def test_every_dispatch_fault_divergence_is_pinned(self, monkeypatch, tmp_path):
        """The kept divergence (`ROADMAP.md` §3): a deterministic fault on
        every first wait. The JAX package re-runs the batch in its
        interpreter and delivers it; the port's re-run is the card, meets
        the fault again and quarantines the batch."""
        monkeypatch.setenv("FLUVIO_DEADLETTER_DIR", str(tmp_path / "ref"))
        ref_slabs, port_slabs = _slabs(n=1)
        ref_chain = _ref_build()
        port_chain = _port_build(resilience=_dl(tmp_path / "port"))
        _arm("device", every=1, exc="deterministic")
        ref_out = ref_chain.process(ref_slabs[0])
        port_out = port_chain.process(port_slabs[0])
        assert [r.value for r in ref_out.successes] == [
            v for _k, v in _run(_ref_build(backend="python"), ref_slabs)[0]]
        assert port_out.error is None and not port_out.successes
        assert _counters(TELEMETRY)["quarantined"] == 1
        assert _counters(REF_TELEMETRY)["quarantined"] == 0
        assert len(os.listdir(tmp_path / "port")) == 1


# ---------------------------------------------------------------------------
# the consume path's fused-error decline
# ---------------------------------------------------------------------------


class TestConsumeDecline:
    def _served(self, chain, wires, batches, arm=None):
        """Every served record as (offset, value) through `stream_slices`
        over 8 stored batches in read slices of <= 1,600 stored bytes;
        ``arm`` is armed as the third slice is read."""
        from fluvio_tpu_torch.spu import smart_chain as sc
        from tests.test_torch_isolation import slice_reader

        read_slice, reads = slice_reader(wires, batches, 1_600), [0]

        def read(offset):
            reads[0] += 1
            if arm is not None and reads[0] == 3:
                faults.FAULTS.inject(*arm[:1], **arm[1])
            return read_slice(offset)

        out = []
        try:
            for res in sc.stream_slices(chain, read, 0, 320, 1 << 20):
                assert res.error is None
                out.extend((b.base_offset + r.offset_delta, r.value)
                           for b in res.records.batches for r in b.memory_records())
        finally:
            faults.FAULTS.clear()
        return out

    @pytest.mark.parametrize("point", ["dispatch", "fetch"])
    @pytest.mark.parametrize("name", ["north_star", "3_aggregate"])
    def test_a_failed_slice_declines_and_is_served_per_batch(self, name, point, monkeypatch):
        """A deterministic fault at a slice's dispatch (or at the finish the
        pipelined loop reaches next) declines that slice ``fused-error``;
        it is served batch by batch through the chain's ladder (the re-run
        on the card), and every offset is served once, as without the
        fault. Stateless and aggregate chains."""
        from fluvio_tpu_torch.protocol.codec import ByteReader
        from fluvio_tpu_torch.protocol.record import Batch
        from fluvio_tpu_torch.spu import smart_chain as sc
        from tests.test_torch_isolation import broker_log, gen_json, server_invocations

        monkeypatch.setattr(sc, "_DISPATCH_CHUNK_ROWS", 64)
        wires, _ = broker_log(gen_json(320, seed=77), 40)

        def batches():
            return [Batch.decode(ByteReader(w), parse_records=False) for w in wires]

        def chain():
            return sc.build_chain(server_invocations(name), SmartEngine(device="cpu",
                                                                        resilience=FAST))

        clean = self._served(chain(), wires, batches())
        d0 = dict(TELEMETRY.declines)
        got = self._served(chain(), wires, batches(),
                           (point, {"first": 1, "exc": "deterministic"}))
        assert got == clean and len({o for o, _ in got}) == len(got)
        assert {k: v - d0.get(k, 0) for k, v in TELEMETRY.declines.items()
                if v != d0.get(k, 0)} == {"fused-error": 1}
        # the decline counts the slice once; its batches then run clean
        assert not _counters(TELEMETRY)["spills"]
        _drained()


# ---------------------------------------------------------------------------
# counter surfaces
# ---------------------------------------------------------------------------


class TestCounterSurfaces:
    FAMILIES = ("retries_total", "quarantined_total", "breaker_transitions_total",
                "breaker_state", "breaker_short_circuits_total")

    def _populate(self):
        for tel in (TELEMETRY, REF_TELEMETRY):
            tel.add_retry("device")
            tel.add_retry("fetch")
            tel.add_quarantine()
            tel.record_breaker("chain-t", OPEN)
            tel.add_breaker_short_circuit()

    @staticmethod
    def _lines(text: str, families) -> list:
        return sorted(line for line in text.splitlines()
                      if any(f"_{f}" in line for f in families) and not line.startswith("#"))

    def test_families_in_prometheus_equal_the_reference(self):
        self._populate()
        port = self._lines(render_prometheus(), self.FAMILIES)
        assert port == self._lines(ref_render_prometheus(), self.FAMILIES)
        assert 'fluvio_tpu_breaker_state{chain="chain-t"} 2' in port

    def test_families_in_the_snapshot_equal_the_reference(self):
        self._populate()
        port = TELEMETRY.snapshot()["counters"]
        ref = REF_TELEMETRY.snapshot()["counters"]
        for key in ("retries", "quarantined", "breaker"):
            assert port[key] == ref[key], key

    def test_families_scrape_over_socket(self, tmp_path, monkeypatch):
        from fluvio_tpu_torch.spu.metrics import SpuMetrics
        from fluvio_tpu_torch.spu.monitoring import MonitoringServer, read_prometheus

        self._populate()
        monkeypatch.chdir(tmp_path)  # a short socket path

        class _Ctx:
            metrics = SpuMetrics()

        async def run():
            server = MonitoringServer(_Ctx(), "m.sock")
            await server.start()
            try:
                return await read_prometheus(server.path)
            finally:
                await server.stop()

        text = asyncio.run(run())
        for family in ("retries_total", "quarantined_total", "breaker_transitions_total"):
            assert f"fluvio_tpu_{family}" in text


# ---------------------------------------------------------------------------
# monitoring socket: a client that goes away
# ---------------------------------------------------------------------------


class TestMonitoringSocket:
    def test_client_gone_does_not_kill_accept_loop(self, tmp_path, monkeypatch):
        from fluvio_tpu_torch.spu.metrics import SpuMetrics
        from fluvio_tpu_torch.spu.monitoring import MonitoringServer, read_metrics

        monkeypatch.chdir(tmp_path)

        class _Ctx:
            metrics = SpuMetrics()

        async def run():
            server = MonitoringServer(_Ctx(), "m.sock")
            await server.start()
            try:
                # client 1 meets an armed accept fault (it stands in for a
                # mid-write disconnect: the same except path)
                faults.FAULTS.inject("socket_accept", first=1)
                reader, writer = await asyncio.open_unix_connection(server.path)
                try:
                    writer.write(b"json\n")
                    await writer.drain()
                    await reader.read()
                except ConnectionError:
                    pass  # the server dropped us: the scenario
                finally:
                    writer.close()
                # client 2 goes away without reading its payload
                _, w2 = await asyncio.open_unix_connection(server.path)
                w2.write(b"prom\n")
                w2.close()
                await asyncio.sleep(0.05)
                # client 3: the server still answers
                return await read_metrics(server.path)
            finally:
                await server.stop()

        data = asyncio.run(run())
        assert "telemetry" in data or "smartmodule" in data
        assert TELEMETRY.snapshot()["counters"]["declines"].get("client-gone", 0) >= 1


# ---------------------------------------------------------------------------
# operator interrupts propagate through every rung
# ---------------------------------------------------------------------------


class TestInterruptPropagation:
    @pytest.mark.parametrize("point", ["stage", "dispatch", "device", "fetch"])
    def test_keyboard_interrupt_is_never_swallowed(self, point):
        chain = _port_build()
        faults.FAULTS.inject(point, first=1, exc=KeyboardInterrupt)
        with pytest.raises(KeyboardInterrupt):
            chain.process(_slabs(n=1)[1][0])
        counters = _counters(TELEMETRY)
        assert not counters["retries"], "interrupts are not retried"
        assert not counters["spills"], "interrupts are no spills"
        _drained()

    def test_system_exit_propagates_from_spill_rerun(self):
        chain = _port_build()
        faults.FAULTS.inject("device", first=1, exc="deterministic")
        faults.FAULTS.inject("spill_rerun", first=1, exc=SystemExit)
        with pytest.raises(SystemExit):
            chain.process(_slabs(n=1)[1][0])
        assert _counters(TELEMETRY)["quarantined"] == 0


# ---------------------------------------------------------------------------
# the windowed runtime's seams and its one retry
# ---------------------------------------------------------------------------


class TestWindowedRetry:
    def _batches(self):
        from tests.test_torch_isolation import gen_ints

        out = []
        for k, n in enumerate((250, 140, 200)):
            values = gen_ints(n, seed=30 + k)
            ts = (np.arange(n, dtype=np.int64) * 4 + 1200 * k).tolist()
            out.append((values, ts))
        return out

    @pytest.mark.parametrize("point", ["stage", "dispatch", "device", "fetch"])
    def test_one_transient_retry_against_the_untouched_bank(self, point):
        """first=1 at the point: one retry; the bank equals the host
        reference's after every batch, and the deltas are the JAX
        runtime's under the same schedule."""
        from tests.test_torch_windows import _assert_delta_equal, _buffer, _pair
        from fluvio_tpu_torch.windows import HostWindowReference

        ref_rt, port_rt = _pair(window_ms=1000, slide_ms=250)
        host = HostWindowReference(port_rt.spec)
        _arm(point, first=1)
        for values, ts in self._batches():
            ref_buf, port_buf = _buffer(values, ts, base_ts=1_000_000)
            _assert_delta_equal(ref_rt.process_buffer(ref_buf), port_rt.process_buffer(port_buf))
            host.process_batch([(0, int(v), t + 1_000_000) for v, t in zip(values, ts)])
            assert port_rt.bank.snapshot() == host.bank_entries() == ref_rt.bank.snapshot()
        assert _both_counters_equal()["retries"] == {point: 1}
        assert set(TELEMETRY.retry_seconds) == {point} and TELEMETRY.retry_seconds[point] > 0

    def test_a_second_fault_raises_and_leaves_the_bank(self):
        from tests.test_torch_windows import _buffer, _pair

        _ref_rt, port_rt = _pair(window_ms=1000, slide_ms=250)
        (values, ts), *_ = self._batches()
        before = port_rt.bank.snapshot()
        faults.FAULTS.inject("fetch", first=2)
        with pytest.raises(InjectedFault):
            port_rt.process_buffer(_buffer(values, ts, base_ts=1_000_000)[1])
        assert port_rt.bank.snapshot() == before
        faults.FAULTS.clear()
        faults.FAULTS.inject("device", first=1, exc="deterministic")
        with pytest.raises(InjectedFault):
            port_rt.process_buffer(_buffer(values, ts, base_ts=1_000_000)[1])
        assert port_rt.bank.snapshot() == before
        assert _counters(TELEMETRY)["retries"] == {"fetch": 1}
        assert not TELEMETRY.retry_seconds, "a retry that failed books no time"
