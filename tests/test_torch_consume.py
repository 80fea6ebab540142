"""The broker's consume path of the port against the JAX package's, on the
CPU: `SmartModuleChainInstance.process` and `spu/smart_chain.py`.

Both packages get the same stored batches (encoded once by the JAX
package, decoded raw by each) and the same chain (registry modules, or
the bench's AdHoc payloads from wire invocations). The JAX chains are
``SmartEngine(backend="tpu")`` on the CPU, built as
``tests/test_torch_chain.py`` builds them. Tolerance 0 everywhere: equal
records, and `process_batches` must encode the same `RecordSet` bytes
and the same ``next_offset``.

A transform error: the JAX package reruns the slice in its interpreter,
the port re-dispatches the stages up to the explode on the card; both
return the partial output with the same error.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import bench
from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol import codec as ref_codec
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartengine.metrics import SmartModuleChainMetrics as RefMetrics
from fluvio_tpu.smartmodule import types as ref_types
from fluvio_tpu.spu import smart_chain as ref_sc
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol import codec, record
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocation, SmartModuleInvocationWasm
from fluvio_tpu_torch.smartengine import (
    GpuSpill,
    SmartEngine,
    SmartModuleChainMetrics,
    SmartModuleConfig,
    StoreMemoryExceeded,
)
from fluvio_tpu_torch.smartmodule.types import SmartModuleInput
from fluvio_tpu_torch.spu import smart_chain as sc
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_chain import _module_pair
from tests.test_torch_isolation import gen_arrays, gen_json, north_star_invocations, slice_reader
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

AGGREGATE = [("aggregate-field", {"field": "n", "combine": "add"}, b"")]
EXPLODE = [("array-map-json", {}, b"")]


def _chains(specs):
    """specs: [(registry name | (kind, build) | source bytes, params,
    initial_data)] -> (JAX chain instance, port chain instance)."""
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu").builder()
    for spec, params, initial in specs:
        if isinstance(spec, bytes):
            ref_m = port_m = spec
        elif isinstance(spec, str):
            ref_m, port_m = ref_lookup(spec), lookup(spec)
        else:
            ref_m, port_m = _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(params), initial_data=initial), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(params), initial_data=initial), port_m)
    ref_chain, port_chain = rb.initialize(), pb.initialize()
    assert ref_chain.backend_in_use == "tpu" and port_chain.backend_in_use == "gpu"
    return ref_chain, port_chain


def _north_star():
    """The bench's broker chain: the port's from its wire invocations
    (`build_chain`), the JAX package's from the same payloads."""
    port_chain = sc.build_chain(north_star_invocations(), SmartEngine(device="cpu"))
    ref_chain, _ = _chains([(bench.NORTH_STAR_FILTER_SM, {}, b""),
                            (bench.NORTH_STAR_MAP_SM, {"field": "name"}, b"")])
    return ref_chain, port_chain


def _stored(groups, bases, first_ts, keys=None, ts_step=3):
    """Wire bytes of one stored batch per group of values, encoded by the
    JAX package: offset deltas 0.., timestamp deltas ``i * ts_step``."""
    out = []
    for g, (values, base, ts) in enumerate(zip(groups, bases, first_ts)):
        recs = [ref_record.Record(value=v, key=None if keys is None else keys[g][i],
                                  offset_delta=i, timestamp_delta=i * ts_step)
                for i, v in enumerate(values)]
        b = ref_record.Batch.from_records(recs, base_offset=base, first_timestamp=ts,
                                          preserve_offsets=True)
        w = ref_codec.ByteWriter()
        b.encode(w)
        out.append(w.bytes())
    return out


def _decode(wires):
    """(JAX batches, port batches): each wire batch decoded raw, as
    storage hands a read slice over."""
    return ([ref_record.Batch.decode(ref_codec.ByteReader(w), parse_records=False) for w in wires],
            [record.Batch.decode(codec.ByteReader(w), parse_records=False) for w in wires])


def _set_bytes(rs, writer) -> bytes:
    w = writer()
    rs.encode(w)
    return w.bytes()


def _same(ref_res, port_res):
    assert port_res.next_offset == ref_res.next_offset
    assert _set_bytes(port_res.records, codec.ByteWriter) == _set_bytes(
        ref_res.records, ref_codec.ByteWriter)
    assert port_res.error is None and ref_res.error is None


def _both(ref_chain, port_chain, wires, max_bytes=1 << 20, start_offset=None):
    ref_b, port_b = _decode(wires)
    ref_m, port_m = RefMetrics(), SmartModuleChainMetrics()
    ref_res = ref_sc.process_batches(ref_chain, ref_b, max_bytes, ref_m, start_offset)
    port_res = sc.process_batches(port_chain, port_b, max_bytes, port_m, start_offset)
    _same(ref_res, port_res)
    for k in ("fastpath_slices", "fallback_slices", "fallback_reasons", "records_out"):
        assert port_m.to_dict()[k] == ref_m.to_dict()[k], k
    return port_res


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(ref_sc, "_DISPATCH_CHUNK_ROWS", 64)
    monkeypatch.setattr(sc, "_DISPATCH_CHUNK_ROWS", 64)


def _json_groups(sizes, seed):
    docs = gen_json(sum(sizes), seed=seed)
    starts = np.cumsum([0] + list(sizes))
    return [docs[a:b] for a, b in zip(starts[:-1], starts[1:])]


def test_chunked_slice_cut_and_resume(small_chunks):
    """The north-star chain over 6 stored batches (chunks of 64 rows),
    then a ``max_bytes`` cut mid-slice and the resume from that offset:
    bytes and next offsets equal at every step."""
    ref_chain, port_chain = _north_star()
    groups = _json_groups([120, 80, 100, 90, 110, 60], seed=31)
    bases = np.cumsum([0] + [len(g) for g in groups])[:-1].tolist()
    wires = _stored(groups, bases, [1_000_000 + 7 * k for k in range(6)])
    _, port_b = _decode(wires)
    pending = sc.gpu_stage_dispatch(port_chain, port_b)
    assert len(pending.chunks) == 9 and pending.count == 560
    assert set(pending.phase_ms) == {"decompress", "decode", "stage", "dispatch"}
    full = sc.gpu_finish(port_chain, pending, 1 << 20)
    assert {"finish", "encode"} <= set(full.phase_ms)
    _same(_both(ref_chain, port_chain, wires), full)
    cut = _both(ref_chain, port_chain, wires, max_bytes=700)
    assert 0 < cut.next_offset < 560 and cut.next_offset not in bases  # mid-batch
    rest = [k for k in range(6) if bases[k] + len(groups[k]) > cut.next_offset]
    resumed = _both(ref_chain, port_chain, [wires[k] for k in rest], start_offset=cut.next_offset)
    got = cut.records.batches[0].memory_records() + resumed.records.batches[0].memory_records()
    want = [v for g in groups for v in g if b"fluvio" in v]
    assert [r.value for r in got] == [json.loads(v)["name"].upper().encode() for v in want]


def test_keyed_records_and_an_empty_batch(small_chunks):
    groups = _json_groups([70, 0, 90], seed=32)
    keys = [[None if i % 4 == 0 else f"k{i}".encode() * (i % 3) for i in range(len(g))]
            for g in groups]
    wires = _stored(groups, [0, 70, 70], [5, 5, 5], keys=keys)
    ref_chain, port_chain = _chains([("regex-filter", {"regex": "fluvio"}, b""),
                                     ("json-map", {"field": "name"}, b"")])
    out = _both(ref_chain, port_chain, wires)
    assert any(r.key for r in out.records.batches[0].memory_records())
    empty = _both(ref_chain, port_chain, [wires[1]])
    # no output batch; the next offset is the stored batch's (its header
    # says last_offset_delta 0: `Batch.from_records` of no records)
    assert empty.records.batches == [] and empty.next_offset == 71


def test_aggregate_across_two_slices_and_carries_from_the_reference():
    """Running sums continue from slice to slice; a port chain seeded with
    the JAX chain's carries after the first slice encodes the second as
    the JAX chain does."""
    groups = _json_groups([50, 60, 40, 70], seed=33)
    wires = _stored(groups, [0, 50, 110, 150], [1_000, 1_010, 1_020, 1_030])
    ref_chain, port_chain = _chains(AGGREGATE)
    _both(ref_chain, port_chain, wires[:2])
    _both(ref_chain, port_chain, wires[2:])
    ref2, port2 = _chains([("aggregate-field", {"field": "n", "combine": "add"}, b"17")])
    ref_b, _ = _decode(wires[:2])
    ref_sc.process_batches(ref2, ref_b, 1 << 20)
    ref2.tpu_chain._ensure_host_state()
    interop.carries_from_reference(port2.gpu_chain, ref2.tpu_chain.carries)
    _both(ref2, port2, wires[2:])
    with pytest.raises(ValueError, match="aggregates"):
        interop.carries_from_reference(port2.gpu_chain, [])


def test_explode_over_batches_with_different_bases():
    """Explode outputs are fresh records of their source record's batch:
    they take that batch's rebase deltas (offsets and timestamps)."""
    arrays = gen_arrays(60, seed=34)
    groups = [arrays[:20], arrays[20:45], arrays[45:]]
    wires = _stored(groups, [0, 1_000, 5_000], [2_000, 2_500, 9_000])
    ref_chain, port_chain = _chains(EXPLODE)
    out = _both(ref_chain, port_chain, wires)
    deltas = {r.offset_delta for r in out.records.batches[0].memory_records()}
    assert deltas == {0, 1_000, 5_000}


def test_mixed_base_timestamps_decline_to_the_per_batch_path():
    groups = _json_groups([30, 40, 20], seed=35)
    wires = _stored(groups, [0, 30, 70], [-1, 4_000, -1])
    ref_chain, port_chain = _chains([("regex-filter", {"regex": "fluvio"}, b"")])
    ref_b, port_b = _decode(wires)
    ref_m, port_m = RefMetrics(), SmartModuleChainMetrics()
    ref_res = ref_sc.process_batches(ref_chain, ref_b, 1 << 20, ref_m)
    port_res = sc.process_batches(port_chain, port_b, 1 << 20, port_m)
    assert port_m.fallback_reasons == ref_m.fallback_reasons == {"mixed-base-timestamps": 1}
    assert port_res.next_offset == ref_res.next_offset == 90
    assert len(port_res.records.batches) == len(ref_res.records.batches) == 3
    for pb, rb in zip(port_res.records.batches, ref_res.records.batches):
        assert (pb.base_offset, pb.header.last_offset_delta) == (
            rb.base_offset, rb.header.last_offset_delta)
        if rb.header.first_timestamp == 4_000:  # an absent one is the clock's
            assert pb.header.first_timestamp == 4_000
        assert [(r.value, r.key, r.offset_delta, r.timestamp_delta) for r in pb.records] == [
            (r.value, r.key, r.offset_delta, r.timestamp_delta) for r in rb.records]


@pytest.mark.parametrize("guard", ["staging-cap", "store-memory"])
def test_staging_guards_decline_and_the_per_batch_path_serves(guard, monkeypatch):
    groups = _json_groups([30, 30], seed=36)
    wires = _stored(groups, [0, 30], [10, 20])
    ref_chain, port_chain = _chains([("regex-filter", {"regex": "fluvio"}, b"")])
    if guard == "staging-cap":
        monkeypatch.setattr(ref_sc, "_MAX_STAGING_BYTES", 64)
        monkeypatch.setattr(sc, "_MAX_STAGING_BYTES", 64)
    else:
        monkeypatch.setattr(ref_chain.engine, "store_max_memory", 2_000)
        monkeypatch.setattr(port_chain.engine, "store_max_memory", 2_000)
    out = _both(ref_chain, port_chain, wires)
    assert len(out.records.batches) == 2
    if guard == "store-memory":
        big = SmartModuleInput.from_records(record.Batch.decode(
            codec.ByteReader(_stored([gen_json(200)], [0], [0])[0])).records)
        with pytest.raises(StoreMemoryExceeded):
            port_chain.process(big)


def test_a_too_wide_slice_declines_and_the_card_path_raises():
    """A record wider than the narrow layout, for a chain with no striped
    lowering: the slice declines before any dispatch, and the per-batch
    path's `process` raises `GpuSpill` (no interpreter reruns it)."""
    wires = _stored([[b"[" + b"1," * 40_000 + b"1]"]], [0], [0])
    _, port_chain = _chains(EXPLODE)
    assert port_chain.gpu_chain.max_stageable_width() == 1 << 16
    m = SmartModuleChainMetrics()
    with pytest.raises(GpuSpill) as e:
        sc.process_batches(port_chain, _decode(wires)[1], 1 << 20, m)
    assert e.value.reason == "record-too-wide-unstripeable"
    assert m.fallback_reasons == {"record-too-wide": 1}


def test_transform_error_divergence_is_pinned():
    """An explode meets a record that is no JSON array in the second of two
    stored batches: the JAX package reruns the slice in its interpreter,
    the port re-dispatches the explode on the card, and both return the
    first batch's elements, the failing batch's elements before the
    record, the same error (hint, offset, kind, key, value) and the next
    offset at the failing batch's end. The port's coalesced slice declines
    (``transform-error-spill``) and is served batch by batch."""
    arrays = gen_arrays(10, seed=37)
    wires = _stored([arrays[:4], arrays[4:6] + [b'{"no":1}'] + arrays[6:]], [0, 4], [1, 1])
    ref_chain, port_chain = _chains(EXPLODE)
    ref_b, port_b = _decode(wires)
    m = SmartModuleChainMetrics()
    ref_res = ref_sc.process_batches(ref_chain, ref_b, 1 << 20)
    port_res = sc.process_batches(port_chain, port_b, 1 << 20, m)
    assert ref_res.error is not None
    assert ref_res.error.kind == ref_types.SmartModuleKind.ARRAY_MAP
    assert ref_res.records.total_records() == sum(len(json.loads(a)) for a in arrays[:6])
    assert port_res.next_offset == ref_res.next_offset == 11
    assert _set_bytes(port_res.records, codec.ByteWriter) == _set_bytes(
        ref_res.records, ref_codec.ByteWriter)
    e, w = port_res.error, ref_res.error
    assert (e.hint, e.offset, e.kind.value, e.record_key, e.record_value) == (
        w.hint, w.offset, w.kind.value, w.record_key, w.record_value) == (
        "input record is not a JSON array", 6, "array_map", None, b'{"no":1}')
    assert m.fallback_reasons == {"transform-error-spill": 1}


@pytest.mark.parametrize("kind", ["filter", "map", "filter_map", "array_map", "aggregate"])
def test_chain_instance_process_matches_the_reference(kind):
    specs = {
        "filter": [("regex-filter", {"regex": "fluvio"}, b"")],
        "map": [("json-map", {"field": "name"}, b"")],
        "filter_map": [(("filter_map", lambda d: d.FilterMapProgram(
            predicate=d.RegexMatch(arg=d.Value(), pattern="kafka"),
            value=d.JsonGet(arg=d.Value(), key="n"), key=d.Value())), {}, b"")],
        "array_map": EXPLODE,
        "aggregate": [("aggregate-field", {"field": "n", "combine": "max"}, b"5")],
    }[kind]
    ref_chain, port_chain = _chains(specs)
    docs = gen_arrays(90, seed=38) if kind == "array_map" else gen_json(90, seed=38)
    ref_m, port_m = RefMetrics(), SmartModuleChainMetrics()
    for k in range(3):
        part = docs[30 * k: 30 * (k + 1)]
        keys = [None if i % 2 else b"key%d" % i for i in range(30)]
        ref_in = ref_types.SmartModuleInput.from_records(
            [ref_record.Record(value=v, key=keys[i], offset_delta=i, timestamp_delta=i)
             for i, v in enumerate(part)], base_offset=100 * k, base_timestamp=50)
        port_in = SmartModuleInput.from_records(
            [record.Record(value=v, key=keys[i], offset_delta=i, timestamp_delta=i)
             for i, v in enumerate(part)], base_offset=100 * k, base_timestamp=50)
        ref_out = ref_chain.process(ref_in, ref_m)
        port_out = port_chain.process(port_in, port_m)
        assert port_out.error is None and ref_out.error is None
        assert [(r.value, r.key, r.offset_delta, r.timestamp_delta)
                for r in port_out.successes] == [
            (r.value, r.key, r.offset_delta, r.timestamp_delta) for r in ref_out.successes]
    for k in ("bytes_in", "records_out", "invocation_count", "fuel_used"):
        assert port_m.to_dict()[k] == ref_m.to_dict()[k], k
    if kind == "aggregate":
        ref_chain.tpu_chain._ensure_host_state()
        port_chain.gpu_chain._ensure_host_state()
        assert port_chain.gpu_chain.carries == ref_chain.tpu_chain.carries
    assert port_chain.chain_spec == ref_chain.chain_spec


def test_apply_chain_and_the_empty_chain():
    ref_chain, port_chain = _north_star()
    groups = _json_groups([40, 25], seed=39)
    port_set, ref_set = record.RecordSet(), ref_record.RecordSet()
    for g, ts in zip(groups, (100, 200)):
        port_set.add(record.Batch.from_records([record.Record(value=v) for v in g],
                                               first_timestamp=ts))
        ref_set.add(ref_record.Batch.from_records([ref_record.Record(value=v) for v in g],
                                                  first_timestamp=ts))
    port_out, port_err = sc.apply_chain(port_chain, port_set)
    ref_out, ref_err = ref_sc.apply_chain(ref_chain, ref_set)
    assert port_err is None and ref_err is None
    assert _set_bytes(port_out, codec.ByteWriter) == _set_bytes(ref_out, ref_codec.ByteWriter)
    empty = SmartEngine(device="cpu").builder().initialize()
    assert empty.gpu_chain is None and empty.backend_in_use == "passthrough"
    out = sc.process_batches(empty, _decode(_stored(groups, [0, 40], [1, 2]))[1], 1 << 20)
    assert out.records.total_records() == 65


def test_build_chain_resolves_predefined_names():
    inv = SmartModuleInvocation(wasm=SmartModuleInvocationWasm.predefined("ns-filter"))
    chain = sc.build_chain([inv], SmartEngine(device="cpu"),
                           {"ns-filter": bench.NORTH_STAR_FILTER_SM})
    assert chain.chain_spec == [{"name": "ns-filter", "kind": "filter", "params": {}}]
    with pytest.raises(sc.SmartModuleResolutionError) as e:
        sc.build_chain([inv], SmartEngine(device="cpu"), {})
    assert e.value.code == ErrorCode.SMARTMODULE_NOT_FOUND
    bad = SmartModuleInvocation(wasm=SmartModuleInvocationWasm.adhoc(b"x = 1"))
    with pytest.raises(sc.SmartModuleResolutionError) as e:
        sc.build_chain([bad], SmartEngine(device="cpu"))
    assert e.value.code == ErrorCode.SMARTMODULE_INVALID


@pytest.mark.parametrize("max_bytes", [1 << 20, 300])
def test_stream_slices_pipelined_equals_the_serial_loop(max_bytes, small_chunks):
    """The dispatch-ahead loop serves what one slice at a time serves, on
    the JAX package's path too, ``max_bytes`` cuts (and the discarded
    speculative slices) included; read slices hold up to 1,600 stored
    bytes."""
    ref_chain, port_chain = _north_star()
    groups = _json_groups([40] * 8, seed=40)
    wires = _stored(groups, [40 * k for k in range(8)], [10] * 8)
    ref_b, port_b = _decode(wires)
    port_read, ref_read = slice_reader(wires, port_b, 1_600), slice_reader(wires, ref_b, 1_600)
    got = list(sc.stream_slices(port_chain, port_read, 0, 320, max_bytes))
    assert sc.gpu_pipelinable(port_chain)
    current, want = 0, []
    while current < 320:
        res = ref_sc.process_batches(ref_chain, ref_read(current), max_bytes,
                                     start_offset=current)
        want.append(res)
        current = res.next_offset
    assert len(got) == len(want) > 1
    for ref_res, port_res in zip(want, got):
        _same(ref_res, port_res)
    agg_ref, agg_port = _chains(AGGREGATE)
    served = list(sc.stream_slices(agg_port, port_read, 0, 320, max_bytes))
    assert not sc.gpu_pipelinable(agg_port)
    current = 0
    for port_res in served:
        _same(ref_sc.process_batches(agg_ref, ref_read(current), max_bytes, start_offset=current),
              port_res)
        current = port_res.next_offset
    assert current == 320


def test_stream_slices_closed_mid_stream_discards_what_is_in_flight(small_chunks, monkeypatch):
    """A consumer that stops after slice k closes the generator while
    slice k+1 is dispatched: its chunks are discarded, nothing else is,
    and every served slice carries its storage ``read`` time."""
    _, port_chain = _north_star()
    groups = _json_groups([40] * 8, seed=41)
    wires = _stored(groups, [40 * k for k in range(8)], [10] * 8)
    _, port_b = _decode(wires)
    discarded = []
    real = sc.PendingSlice.discard

    def discard(self, gpu):
        discarded.append(self.read_from)
        real(self, gpu)

    monkeypatch.setattr(sc.PendingSlice, "discard", discard)
    slices = sc.stream_slices(port_chain, slice_reader(wires, port_b, 1_600), 0, 320, 1 << 20)
    first = next(slices)
    assert "read" in first.phase_ms and discarded == []
    slices.close()
    assert discarded == [first.next_offset]
