"""The slice as a whole: the port's SmartEngine (on the CPU) against the
JAX package's ``backend="tpu"`` SmartEngine (JAX on the CPU), over the
same staged columns.

Each input batch is staged once by the JAX package's `RecordBuffer` and
carried into the port with `interop.buffer_from_reference`; the two output
buffers must be equal exactly: count, each record's value and key bytes,
the value and key lengths, offset and timestamp deltas, and the base
offset and timestamp.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol.record import Record
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu.smartmodule.sdk import SmartModuleDef as RefModule
from fluvio_tpu.smartmodule.types import SmartModuleInput as RefInput
from fluvio_tpu.smartmodule.types import SmartModuleKind as RefKind
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.smartengine import (
    EngineError,
    GpuSpill,
    SmartEngine,
    SmartModuleConfig,
)
from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import SmartModuleKind
from tests.test_torch_isolation import gen_json
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_tpu_kernels import JSON_DOCS

HEADLINE = [("regex-filter", {"regex": "fluvio"}), ("json-map", {"field": "name"})]
JSON_REGEX = [("json-regex-filter", {"key": "name", "regex": "^(fluvio|kafka|pulsar)-[0-3]$"})]


def _module_pair(kind: str, build):
    """The same DSL program as a JAX-package module and a port module;
    ``build(dsl_module)`` makes the program from either DSL."""
    ref_kind, port_kind = RefKind(kind), SmartModuleKind(kind)
    ref_m = RefModule(name="adhoc")
    ref_m.dsl[ref_kind] = build(ref_dsl)
    port_m = SmartModuleDef(name="adhoc")
    port_m.dsl[port_kind] = build(dsl)
    return ref_m, port_m


def _chains(specs):
    """specs: [(registry name | (kind, build), params)] -> (ref chain, port chain)."""
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu").builder()
    for spec, params in specs:
        if isinstance(spec, str):
            ref_m, port_m = ref_lookup(spec), lookup(spec)
        else:
            ref_m, port_m = _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(params)), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(params)), port_m)
    ref_chain = rb.initialize()
    assert ref_chain.backend_in_use == "tpu"
    return ref_chain.tpu_chain, pb.initialize().gpu_chain


def _ref_buffer(values, keys=None, offsets=None, ts=None, base_offset=0, base_ts=-1):
    records = []
    for i, v in enumerate(values):
        records.append(
            Record(
                value=v,
                key=None if keys is None else keys[i],
                offset_delta=i if offsets is None else offsets[i],
                timestamp_delta=0 if ts is None else ts[i],
            )
        )
    return RefBuffer.from_records(records, base_offset=base_offset, base_timestamp=base_ts)


def _port_buffer(ref_buf):
    return interop.buffer_from_reference(
        ref_buf.values, ref_buf.lengths, ref_buf.count, ref_buf.keys, ref_buf.key_lengths,
        ref_buf.offset_deltas, ref_buf.timestamp_deltas, ref_buf.base_offset,
        ref_buf.base_timestamp,
    )


def _assert_equal(ref_out, port_out):
    n = ref_out.count
    assert port_out.count == n
    assert (port_out.base_offset, port_out.base_timestamp) == (
        ref_out.base_offset, ref_out.base_timestamp,
    )
    ref_recs = ref_out.to_records()
    assert port_out.value_list() == [r.value for r in ref_recs]
    assert port_out.key_list() == [r.key for r in ref_recs]
    np.testing.assert_array_equal(port_out.lengths[:n], ref_out.lengths[:n])
    np.testing.assert_array_equal(port_out.key_lengths[:n], ref_out.key_lengths[:n])
    np.testing.assert_array_equal(port_out.offset_deltas[:n], ref_out.offset_deltas[:n])
    np.testing.assert_array_equal(port_out.timestamp_deltas[:n], ref_out.timestamp_deltas[:n])


def _run_both(specs, ref_bufs):
    ref_chain, port_chain = _chains(specs)
    port_bufs = [_port_buffer(b) for b in ref_bufs]
    ref_outs = list(ref_chain.process_stream(ref_bufs))
    port_outs = list(port_chain.process_stream(port_bufs))
    assert len(port_outs) == len(ref_outs)
    for r, p in zip(ref_outs, port_outs):
        _assert_equal(r, p)
    return port_outs


ADVERSARIAL = list(JSON_DOCS) + [
    b'{"name":123\x0b,"m":1}', b'{"name":"fluvio" }', b'{"name" {"name":"fluvio-9"}}',
]


def test_headline_chain():
    values = gen_json(1500) + ADVERSARIAL
    outs = _run_both(HEADLINE, [_ref_buffer(values, ts=list(range(len(values))), base_ts=7)])
    assert outs[0].count > 0
    assert all(v.startswith(b"FLUVIO") for v in outs[0].value_list()[:10])


def test_json_regex_filter_chain():
    values = gen_json(3000, seed=5) + ADVERSARIAL + [b'{"name":"kafka-2"}', b'{"name":"pulsar-0"}']
    outs = _run_both(JSON_REGEX, [_ref_buffer(values)])
    assert outs[0].count > 2


def test_filter_only():
    values = gen_json(600, seed=9) + [b"fluVio", b"", b"FLUVIO"]
    _run_both([("regex-filter", {"regex": "flu[vV]io-(1|2)"})], [_ref_buffer(values)])
    _run_both([("regex-filter", {"regex": "^a"})], [_ref_buffer([b"apple", b"banana", b"avocado"])])


def test_value_upper_map():
    upper = ("map", lambda d: d.MapProgram(value=d.Upper(arg=d.Value())))
    values = [b"abc", b"", b"MiXeD 123 {}", b"z" * 40]
    _run_both([(upper, {})], [_ref_buffer(values, offsets=[3, 9, 11, 12], ts=[5, 0, 70000, 2])])


def test_byte_mode_concat_with_keys():
    """A map whose value is no view of the record (Concat/Const) and that
    rewrites keys runs in byte mode: compacted columns download."""
    prog = (
        "filter_map",
        lambda d: d.FilterMapProgram(
            predicate=d.RegexMatch(arg=d.Value(), pattern="fl(u|i)"),
            value=d.Concat(args=[d.Const(data=b"<"), d.JsonGet(arg=d.Value(), key="name"),
                                 d.Const(data=b">")]),
            key=d.Upper(arg=d.Key()),
        ),
    )
    values = gen_json(200, seed=3) + [b'{"name":"flink"}']
    keys = [None if i % 3 == 0 else b"k%d" % i for i in range(len(values))]
    _run_both([(prog, {})], [_ref_buffer(values, keys=keys)])


def test_stream_crosses_width_buckets():
    batches = [
        _ref_buffer(gen_json(100, seed=1)),  # width 64
        _ref_buffer([b'{"name":"fluvio-1"}', b"fluvio", b'{"n":1}']),  # width 32
        _ref_buffer([b'{"name":"fluvio-x","pad":"' + b"p" * 90 + b'"}'] * 5),  # width 128
        _ref_buffer(gen_json(50, seed=2), base_offset=4000),
    ]
    widths = [b.width for b in batches]
    assert len(set(widths)) == 3
    _run_both(HEADLINE, batches)


def test_reference_executor_chains():
    """The chains of tests/test_tpu_executor.py::TestEquivalence
    (regex-filter alone; the north-star chain with base offset/timestamp)."""
    outs = _run_both(
        [("regex-filter", {"regex": "^a"})],
        [_ref_buffer([b"apple", b"banana", b"avocado", b"cherry"])],
    )
    assert outs[0].value_list() == [b"apple", b"avocado"]
    outs = _run_both(
        HEADLINE,
        [_ref_buffer(
            [b'{"name":"fluvio","n":1}', b'{"name":"kafka","n":2}',
             b'{"name":"fluvio-tpu","n":3}', b"not json at all"],
            base_offset=100, base_ts=5000,
        )],
    )
    assert outs[0].value_list() == [b"FLUVIO", b"FLUVIO-TPU"]
    assert list(outs[0].offset_deltas[:2]) == [0, 2]


def test_unported_kinds_spill():
    """What the port still spills: a batch of a map that keeps the whole
    record beside a rewritten key, wider than the narrow layout (no
    striped lowering), spills at dispatch. A word count's wide batch runs
    striped (its tokens counted once across the stripes' overlap). An
    ``IntToBytes`` of bytes and a comparison of bytes, once refused, run:
    each equal to the JAX engine at ``backend="auto"`` (its native
    backend; its interpreter raises on some of these inputs, ROADMAP 3)."""
    wide = _port_buffer(_ref_buffer([b"1"]))
    wide.values = np.zeros((8, (1 << 16) + 32), dtype=np.uint8)
    rekey = ("map", lambda d: d.MapProgram(value=d.Value(), key=d.Upper(arg=d.Key())))
    _, port_m = _module_pair(*rekey)
    chain = SmartEngine(device="cpu").builder().add_smart_module(SmartModuleConfig(), port_m).initialize().gpu_chain
    with pytest.raises(GpuSpill) as e:
        chain.process_buffer(wide)
    assert e.value.reason == "record-too-wide-unstripeable"
    agg = ("aggregate", lambda d: d.AggregateProgram(kind="word_count"))
    _, port_m = _module_pair(*agg)
    chain = SmartEngine(device="cpu").builder().add_smart_module(SmartModuleConfig(), port_m).initialize().gpu_chain
    assert chain.process_buffer(wide).value_list() == [b"%d" % len(b"\0".split())]
    values = [b"12", b"7", b"abc", b" 5", b"1_0", b"-3", b"9" * 20, b"\xff", b"ab"]
    keys = [b"7", b"7", b"abd", b"5", b"10", b"-3", b"1", b"\x7f", b"abc"]
    for kind, build, want in (
        ("map", lambda d: d.MapProgram(value=d.IntToBytes(arg=d.Value())),
         [b"12", b"7", b"0", b"5", b"1", b"-3", b"%d" % ((int(b"9" * 20) + (1 << 63)) % (1 << 64) - (1 << 63)), b"0", b"0"]),
        ("filter", lambda d: d.FilterProgram(
            predicate=d.Cmp(cmp="eq", left=d.Value(), right=d.Key())), [b"7", b"-3"]),
    ):
        ref_m, port_m = _module_pair(kind, build)
        ref_chain = RefEngine(backend="auto").builder().add_smart_module(
            RefConfig(), ref_m).initialize()
        port_chain = SmartEngine(device="cpu").builder().add_smart_module(
            SmartModuleConfig(), port_m).initialize()
        ref_out, port_out = _process_both(ref_chain, port_chain, values, keys=keys)
        assert [r.value for r in port_out.successes] == [r.value for r in ref_out.successes]
        assert [r.value for r in port_out.successes] == want


def test_stream_delivers_the_batch_before_a_failed_dispatch():
    """A batch wider than the narrow layout spills at dispatch when the
    chain has no striped lowering (a byte-mode Concat map); the batch
    dispatched before it is still delivered first."""
    concat = ("map", lambda d: d.MapProgram(
        value=d.Concat(args=[d.Const(data=b"<"), d.Value(), d.Const(data=b">")])))
    _, port_chain = _chains([(concat, {})])
    ok = _port_buffer(_ref_buffer(gen_json(20, seed=4)))
    wide = _port_buffer(_ref_buffer([b"x"]))
    wide.values = np.zeros((8, (1 << 16) + 32), dtype=np.uint8)
    stream = port_chain.process_stream([ok, wide])
    first = next(stream)
    assert first.value_list() == [b"<" + v + b">" for v in gen_json(20, seed=4)]
    with pytest.raises(GpuSpill) as e:
        next(stream)
    assert e.value.reason == "record-too-wide-unstripeable"


# ---------------------------------------------------------------------------
# a DSL run that does not lower as a whole: cut into card segments
# ---------------------------------------------------------------------------

CUT_CHAINS = {
    "lines_lines": ["array-map-lines", "array-map-lines"],
    "json_lines": ["array-map-json", "array-map-lines"],
}


def _cut_values(seed: int, n: int = 40):
    """JSON arrays of strings holding escaped newlines, arrays of numbers,
    multi-line text, empty values, and (for the JSON explode) records that
    are no JSON array."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pick = int(rng.integers(0, 6))
        words = [b"w%d" % int(rng.integers(0, 99)) for _ in range(int(rng.integers(0, 4)))]
        if pick == 0:
            out.append(b"[" + b",".join(b'"%s\\n%s"' % (w, w) for w in words) + b"]")
        elif pick == 1:
            out.append(b"[" + b",".join(b"%d" % len(w) for w in words) + b"]")
        elif pick == 2:
            out.append(b"\n".join(words))
        elif pick == 3:
            out.append(b"")
        elif pick == 4:
            out.append(b'["a\\nb", "c"]')
        else:
            out.append(b'{"no":%d}' % i)
    return out


def _cut_chains(names, backend="auto", params=None):
    params = params or [{}] * len(names)
    rb = RefEngine(backend=backend).builder()
    pb = SmartEngine(device="cpu").builder()
    for name, p in zip(names, params):
        rb.add_smart_module(RefConfig(params=dict(p)), ref_lookup(name))
        pb.add_smart_module(SmartModuleConfig(params=dict(p)), lookup(name))
    return rb.initialize(), pb.initialize()


def _process_both(ref_chain, port_chain, values, base_offset=100, base_ts=5000, ts=None,
                  keys=None):
    from fluvio_tpu_torch.protocol.record import Record as PortRecord
    from fluvio_tpu_torch.smartmodule.types import SmartModuleInput

    ts = ts or [0] * len(values)
    keys = keys or [None] * len(values)
    ref_out = ref_chain.process(RefInput.from_records(
        [Record(value=v, key=keys[i], offset_delta=i, timestamp_delta=ts[i])
         for i, v in enumerate(values)], base_offset=base_offset, base_timestamp=base_ts))
    port_out = port_chain.process(SmartModuleInput.from_records(
        [PortRecord(value=v, key=keys[i], offset_delta=i, timestamp_delta=ts[i])
         for i, v in enumerate(values)], base_offset=base_offset, base_timestamp=base_ts))
    return ref_out, port_out


def _records(out):
    return [(r.key, r.value, r.offset_delta, r.timestamp_delta) for r in out.successes]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CUT_CHAINS))
def test_cut_dsl_run_equals_the_reference_auto_engine(name, seed):
    """Two explodes in a row: the port cuts the run into two card segments
    (each `GpuChainExecutor`, records handed between them on the host);
    its outputs equal the JAX engine's at ``backend="auto"`` (the SPU's
    default) byte for byte, and its first error the interpreter's."""
    ref_chain, port_chain = _cut_chains(CUT_CHAINS[name])
    assert ref_chain.tpu_chain is None
    assert port_chain.gpu_chain is None and len(port_chain.segments) == 2
    assert port_chain.backend_in_use == "gpu"
    interp, _ = _cut_chains(CUT_CHAINS[name], backend="python")
    for k in range(3):
        values = _cut_values(seed * 10 + k)
        if name == "lines_lines" or k == 0:
            values = [v for v in values if not v.startswith(b"{")] or [b"x"]
        ref_out, port_out = _process_both(ref_chain, port_chain, values)
        assert _records(port_out) == _records(ref_out)
        want = interp.process(RefInput.from_records(
            [Record(value=v, offset_delta=i) for i, v in enumerate(values)],
            base_offset=100, base_timestamp=5000))
        assert _records(port_out) == _records(want)
        if want.error is None:
            assert port_out.error is None and ref_out.error is None
        else:
            e, w = port_out.error, want.error
            assert (e.offset, e.kind.value, e.record_value, e.record_key) == (
                w.offset, w.kind.value, w.record_value, w.record_key)
            assert (ref_out.error.offset, ref_out.error.kind.value) == (w.offset, w.kind.value)


def test_two_line_explodes_over_a_two_line_record():
    """The smallest input of the repaired divergence: ``b"a\\nb"`` through
    two line explodes gives ``a``, ``b``, as the JAX engine does."""
    ref_chain, port_chain = _cut_chains(CUT_CHAINS["lines_lines"])
    ref_out, port_out = _process_both(ref_chain, port_chain, [b"a\nb"])
    assert [r.value for r in port_out.successes] == [b"a", b"b"]
    assert _records(port_out) == _records(ref_out)


def test_windowed_aggregate_after_an_explode_follows_the_interpreter():
    """A windowed aggregate after an explode runs as two card segments. It
    equals the JAX interpreter (``backend="python"``): the explode's
    records carry timestamp delta 0 at the input's base, so every element
    keys the base's window. The JAX engine at ``backend="auto"`` runs
    its native backend, which leaves the key unset and restarts the sum at
    each input record (a reference fault, `ROADMAP.md` §3); the port
    follows the interpreter."""
    names, params = ["array-map-lines", "windowed-sum"], [{}, {"window_ms": "100"}]
    native, port_chain = _cut_chains(names, params=params)
    interp, _ = _cut_chains(names, backend="python", params=params)
    assert native.backend_in_use == "native"
    assert [s._chain_sig for s in port_chain.segments] == ["arraymap", "aggregate"]
    values, ts = [b"1\n2\n3", b"4", b"5\n6"], [5, 250, 470]
    _n_out, port_out = _process_both(native, port_chain, values, base_ts=1000, ts=ts)
    want = interp.process(RefInput.from_records(
        [Record(value=v, offset_delta=i, timestamp_delta=ts[i]) for i, v in enumerate(values)],
        base_offset=100, base_timestamp=1000))
    assert _records(port_out) == _records(want)
    assert [r.value for r in port_out.successes] == [b"1", b"3", b"6", b"10", b"15", b"21"]
    assert {r.key for r in port_out.successes} == {b"1000"}
    assert [(r.key, r.value) for r in _n_out.successes] != [
        (r.key, r.value) for r in port_out.successes]


def test_a_module_that_does_not_lower_alone_is_still_refused():
    """Cutting needs every module to lower on its own: a ``median_int``
    aggregate after an explode has no card lowering and no interpreter."""
    median = ("aggregate", lambda d: d.AggregateProgram(kind="median_int"))
    _, port_m = _module_pair(*median)
    b = SmartEngine(device="cpu").builder().add_smart_module(SmartModuleConfig(),
                                                             lookup("array-map-lines"))
    with pytest.raises(EngineError, match="does not"):
        b.add_smart_module(SmartModuleConfig(), port_m).initialize()


LINES_SM = b"""
@smartmodule.array_map(dsl=dsl.ArrayMapProgram(mode="split", sep=b"\\n"))
def explode(record):
    return [(record.key, part) for part in record.value.split(b"\\n") if part]
"""


def test_cut_chain_is_served_per_batch_over_a_socket(tmp_path):
    """The JSON explode then the line explode, AdHoc over each package's
    SPU socket (the JAX server at ``backend="auto"``): the port serves the
    cut chain one stored batch at a time, and the pushed batches equal the
    JAX server's, wire bytes included."""
    from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocationKind
    from tests.test_torch_server import EXPLODE_SM, _adhoc, _both, _run, _stored

    arrays = [b'["%s\\n%s", "z%d"]' % (b"x" * (i % 5), b"y" * (i % 3), i) for i in range(300)]
    wires = _stored([100, 120, 80], seed=9, values=arrays)
    invocations = [_adhoc(EXPLODE_SM, SmartModuleInvocationKind.ARRAY_MAP),
                   _adhoc(LINES_SM, SmartModuleInvocationKind.ARRAY_MAP)]

    async def body(servers):
        servers.ref.ctx.engine.backend = "auto"
        got = await _both(servers, invocations, max_bytes=4000)
        assert sum(len(v[3]) for v, _ in got) > 300
        assert servers.port.ctx.metrics.smartmodule.to_dict()["fastpath_slices"] == 0

    _run(tmp_path, wires, body)


# ---------------------------------------------------------------------------
# admission: exactly once across shed, retry and dead-letter
# ---------------------------------------------------------------------------


def _pipeline_chaos(pkg: str, tmp_path, monkeypatch):
    """The sequence of ``tests/test_admission.py::TestPipelineChaos::
    test_exactly_once_across_shed_retry_deadletter`` through one package's
    `AdmissionPipeline`: 64 records in 8 slices, a breach from slice 2
    (shed, held, resubmitted), transient ``device`` faults every third hit
    (the reference test's every fifth never fires in its 7 clean dispatches;
    one hit a batch in both packages, so the same batches retry), and a
    poison interval at slice 4 (``device`` and ``spill_rerun``
    deterministic on every hit: quarantined). Returns (served ids,
    quarantined ids, sheds, retries, quarantines)."""
    import json as _json
    import os as _os

    from tests.test_torch_admission import FakeClock, FakeSlo

    if pkg == "ref":
        from fluvio_tpu import admission as adm
        from fluvio_tpu.resilience import faults as flt
        from fluvio_tpu.resilience.deadletter import load_entry
        from fluvio_tpu.smartmodule.types import SmartModuleInput as Inp
        from fluvio_tpu.telemetry import TELEMETRY as tel

        monkeypatch.setenv("FLUVIO_DEADLETTER_DIR", str(tmp_path))
        chain = RefEngine(backend="tpu").builder().add_smart_module(
            RefConfig(params={"field": "name"}), ref_lookup("json-map")).initialize()
        rec, buf_cls = Record, RefBuffer
    else:
        from fluvio_tpu_torch import admission as adm
        from fluvio_tpu_torch.protocol.record import Record as rec
        from fluvio_tpu_torch.resilience import ResilienceConfig
        from fluvio_tpu_torch.resilience import faults as flt
        from fluvio_tpu_torch.resilience.deadletter import load_entry
        from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer as buf_cls
        from fluvio_tpu_torch.smartmodule.types import SmartModuleInput as Inp
        from fluvio_tpu_torch.telemetry import TELEMETRY as tel

        engine = SmartEngine(device="cpu",
                             resilience=ResilienceConfig(deadletter_dir=str(tmp_path)))
        chain = engine.builder().add_smart_module(
            SmartModuleConfig(params={"field": "name"}), lookup("json-map")).initialize()
    tel.reset()
    clk, slo = FakeClock(), FakeSlo()
    served = []

    def dispatch(flush):
        out = chain.process(Inp.from_records(flush.buffer.to_records()[: flush.buffer.count]))
        assert out.error is None
        served.extend(bytes(r.value).decode().lower() for r in out.successes)

    ctl = adm.AdmissionController(slo_engine=slo, clock=clk, rng=random.Random(7),
                                  refresh_s=1.0, tokens=1e9, refill=1e9)
    pipe = adm.AdmissionPipeline(
        dispatch, controller=ctl, queue=adm.FairQueue(max_depth=1000, clock=clk),
        batcher=adm.ShapeBucketBatcher(dispatch, row_target=8, deadline_s=0.05, clock=clk),
        clock=clk)
    pipe.register_chain("map", coalesce=True)
    ids = [f"rec-{i:04d}" for i in range(64)]

    def make_buf(values):
        records = [rec(value=v) for v in values]
        for i, r in enumerate(records):
            r.offset_delta = i
        return buf_cls.from_records(records)

    slices = [make_buf([b'{"name":"%s"}' % i.encode() for i in ids[k: k + 8]])
              for k in range(0, 64, 8)]
    flt.FAULTS.inject("device", every=3)
    shed = 0
    try:
        for idx, buf in enumerate(slices):
            clk.advance(1.1)
            if idx == 2:
                slo.set("map", "breach")
            for _attempt in range(50):
                d = pipe.submit("map", buf)
                if d:
                    break
                shed += 1
                clk.advance(max(d.retry_after_s, 1.1))
                slo.clear()
            else:
                pytest.fail("slice never admitted")
            if idx == 4:
                flt.FAULTS.clear()
                flt.FAULTS.inject("device", every=1, exc="deterministic")
                flt.FAULTS.inject("spill_rerun", every=1, exc="deterministic")
            pipe.pump()
            if idx == 4:
                flt.FAULTS.clear()
                flt.FAULTS.inject("device", every=3)
        pipe.drain()
    finally:
        flt.FAULTS.clear()
    quarantined = []
    for fname in sorted(_os.listdir(tmp_path)):
        _spec, inp = load_entry(str(tmp_path / fname))
        quarantined.extend(_json.loads(bytes(r.value).decode())["name"]
                           for r in inp.into_records())
    counters = tel.snapshot()["counters"]
    return served, quarantined, shed, dict(counters["retries"]), counters["quarantined"], ids


def test_exactly_once_across_shed_retry_deadletter(tmp_path, monkeypatch):
    """Every input record lands exactly once in served ∪ dead-letter, in
    both packages, across breach sheds with resubmission, transient card
    faults retried by the executor and a poison batch quarantined; the
    two packages serve, retry and quarantine the same records."""
    from collections import Counter

    ref = _pipeline_chaos("ref", tmp_path / "ref", monkeypatch)
    port = _pipeline_chaos("port", tmp_path / "port", monkeypatch)
    served, quarantined, shed, retries, n_quarantined, ids = port
    assert quarantined, "the poison window dead-letters"
    assert shed > 0, "the breach interval sheds"
    assert Counter(served) + Counter(quarantined) == Counter(ids)
    assert retries.get("device", 0) >= 1 and n_quarantined >= 1
    assert (sorted(served), sorted(quarantined), shed, retries, n_quarantined) == (
        sorted(ref[0]), sorted(ref[1]), ref[2], ref[3], ref[4])
