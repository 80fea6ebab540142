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

import numpy as np
import pytest

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol.record import Record
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu.smartmodule.sdk import SmartModuleDef as RefModule
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
    return ref_chain.tpu_chain, pb.initialize()


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
    """What the port still spills or refuses: a batch of a word-count
    aggregate chain wider than the narrow layout (per-stripe word counts
    would double-count the overlap, so it has no striped lowering) spills
    at dispatch, and an expression outside the lowering (``IntToBytes`` of
    bytes, a comparison of bytes) makes no chain."""
    agg = ("aggregate", lambda d: d.AggregateProgram(kind="word_count"))
    _, port_m = _module_pair(*agg)
    chain = SmartEngine(device="cpu").builder().add_smart_module(SmartModuleConfig(), port_m).initialize()
    wide = _port_buffer(_ref_buffer([b"1"]))
    wide.values = np.zeros((8, (1 << 16) + 32), dtype=np.uint8)
    with pytest.raises(GpuSpill) as e:
        chain.process_buffer(wide)
    assert e.value.reason == "record-too-wide-unstripeable"
    for kind, prog in (
        (SmartModuleKind.MAP, dsl.MapProgram(value=dsl.IntToBytes(arg=dsl.Value()))),
        (SmartModuleKind.FILTER, dsl.FilterProgram(
            predicate=dsl.Cmp(cmp="eq", left=dsl.Value(), right=dsl.Key()))),
    ):
        with pytest.raises(EngineError):
            SmartEngine(device="cpu").builder().add_smart_module(
                SmartModuleConfig(), SmartModuleDef(dsl={kind: prog})
            ).initialize()


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
