"""The port's wire layer against the JAX package's, on the CPU.

- `Record` / `Batch` / `RecordSet`, the varint and primitive codecs, the
  SmartModule input, output and invocation types: each encoded by one
  package decodes in the other, byte-equal re-encoded (tolerance 0), with
  null and present keys and timestamps; a batch of each compression codec
  written by one package reads in the other (their compressors' bytes may
  differ, so the decompressed records are compared).
- The native record codec (`native/records.cpp`) against the JAX
  package's native decoder and encoder on the same slab: equal arrays,
  equal bytes, and the ``parsed`` contract on a truncated slab.
- A codec library that does not build raises, on the consume path too.
- `RecordBuffer.from_flat` / `from_columns` / `from_records` and
  `to_columns` / `to_records` against the JAX buffer's.
- `load_source` on the bench's AdHoc payloads: the same DSL programs as
  the JAX package's loader makes.

Inputs are made with numpy from fixed seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import bench
from fluvio_tpu.protocol import codec as ref_codec
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.protocol import varint as ref_varint
from fluvio_tpu.protocol.compression import Compression as RefCompression
from fluvio_tpu.protocol.error import ErrorCode as RefErrorCode
from fluvio_tpu.schema import smartmodule as ref_schema
from fluvio_tpu.smartengine import native_backend
from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
from fluvio_tpu.smartmodule import sdk as ref_sdk
from fluvio_tpu.smartmodule import types as ref_types
from fluvio_tpu_torch.native import records as native_records
from fluvio_tpu_torch.protocol import codec, record, varint
from fluvio_tpu_torch.protocol.compression import Compression
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.schema import smartmodule as schema
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartmodule import sdk
from fluvio_tpu_torch.smartmodule import types as sm_types
from fluvio_tpu_torch.types import NO_TIMESTAMP
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401


def _records(pkg, n: int, seed: int, keyed: bool = True):
    """``n`` records of the package's `Record`: random values (empty ones
    included), every third key null, signed offset and timestamp deltas."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None
        if keyed and i % 3:
            key = rng.integers(0, 256, rng.integers(0, 12)).astype(np.uint8).tobytes()
        out.append(pkg.Record(
            value=rng.integers(0, 256, rng.integers(0, 50)).astype(np.uint8).tobytes(),
            key=key,
            offset_delta=int(rng.integers(0, 1 << 30)),
            timestamp_delta=int(rng.integers(-(1 << 40), 1 << 40)),
        ))
    return out


def _encode(obj, writer_cls) -> bytes:
    w = writer_cls()
    obj.encode(w)
    return w.bytes()


def _fields(rec):
    return (rec.value, rec.key, rec.attributes, rec.offset_delta, rec.timestamp_delta)


@pytest.mark.parametrize("keyed", [True, False])
@pytest.mark.parametrize("first_ts", [1_000_000, NO_TIMESTAMP])
def test_batch_and_record_set_round_trip_byte_equal(keyed, first_ts):
    port_set = record.RecordSet()
    ref_set = ref_record.RecordSet()
    for k in range(3):
        port_recs = _records(record, 40 + k, seed=k, keyed=keyed)
        ref_recs = _records(ref_record, 40 + k, seed=k, keyed=keyed)
        port_set.add(record.Batch.from_records(port_recs, base_offset=100 * k,
                                               first_timestamp=first_ts, preserve_offsets=True))
        ref_set.add(ref_record.Batch.from_records(ref_recs, base_offset=100 * k,
                                                  first_timestamp=first_ts, preserve_offsets=True))
    wire = _encode(port_set, codec.ByteWriter)
    assert wire == _encode(ref_set, ref_codec.ByteWriter)
    # each side decodes the other's bytes and writes them back unchanged
    ref_back = ref_record.RecordSet.decode(ref_codec.ByteReader(wire))
    port_back = record.RecordSet.decode(codec.ByteReader(wire))
    assert _encode(ref_back, ref_codec.ByteWriter) == wire
    assert _encode(port_back, codec.ByteWriter) == wire
    # the raw form (storage passthrough) keeps the section, count and size
    raw = record.RecordSet.decode(codec.ByteReader(wire), parse_records=False)
    assert _encode(raw, codec.ByteWriter) == wire
    for pb, rb in zip(raw.batches, ref_back.batches):
        assert pb.records_len() == rb.records_len()
        assert pb.write_size() == rb.write_size()
        assert pb.computed_last_offset() == rb.computed_last_offset()
        assert [_fields(r) for r in pb.memory_records()] == [_fields(r) for r in rb.records]
    assert port_set.total_records() == ref_set.total_records() == 123
    assert port_set.last_offset() == ref_set.last_offset()
    # the CRC check passes on the other package's batch, and fails on a flip
    r = codec.ByteReader(wire, 4)
    batch = record.Batch.decode(r, check_crc=True)
    bad = bytearray(wire)
    bad[r.pos - 1] ^= 1  # the first batch's last byte
    with pytest.raises(codec.DecodeError, match="crc"):
        record.Batch.decode(codec.ByteReader(bytes(bad), 4), check_crc=True)
    assert batch.header.crc == ref_back.batches[0].header.crc


@pytest.mark.parametrize("name", ["GZIP", "LZ4", "SNAPPY", "ZSTD"])
def test_compressed_batches_read_in_both_packages(name):
    port_recs = _records(record, 60, seed=5)
    ref_recs = _records(ref_record, 60, seed=5)
    port_b = record.Batch.from_records(port_recs, base_offset=7, first_timestamp=9,
                                       compression=Compression[name])
    ref_b = ref_record.Batch.from_records(ref_recs, base_offset=7, first_timestamp=9,
                                          compression=RefCompression[name])
    want = [_fields(r) for r in ref_recs]
    from_port = ref_record.Batch.decode(ref_codec.ByteReader(_encode(port_b, codec.ByteWriter)),
                                        check_crc=True)
    from_ref = record.Batch.decode(codec.ByteReader(_encode(ref_b, ref_codec.ByteWriter)),
                                   check_crc=True)
    assert from_port.header.compression().name == from_ref.header.compression().name == name
    assert [_fields(r) for r in from_port.records] == want
    assert [_fields(r) for r in from_ref.records] == want


def test_varints_and_primitives_match():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.integers(-(1 << 62), 1 << 62, 200), [0, -1, 1, 63, -64, 64,
                           2**63 - 1, -2**63]]).astype(np.int64)
    for v in vals.tolist():
        assert varint.varint_size(v) == ref_varint.varint_size(v)
        a, b = bytearray(), bytearray()
        varint.varint_encode(a, v)
        ref_varint.varint_encode(b, v)
        assert a == b and varint.varint_decode(a, 0) == ref_varint.varint_decode(b, 0)
    np.testing.assert_array_equal(varint.varint_encoded_sizes(vals),
                                  ref_varint.varint_encoded_sizes(vals))
    w, rw = codec.ByteWriter(), ref_codec.ByteWriter()
    for writer in (w, rw):
        writer.write_bool(True)
        writer.write_i8(-5)
        writer.write_u16(65535)
        writer.write_i32(-7)
        writer.write_u64(2**64 - 1)
        writer.write_f64(1.5)
        writer.write_varint(-300)
        writer.write_string("flüvio")
        writer.write_option_string(None)
        writer.write_bytes(None)
        writer.write_bytes(b"abc")
        writer.write_vec([1, 2], writer.write_i16)
    assert w.bytes() == rw.bytes()
    r = codec.ByteReader(w.bytes())
    got = [r.read_bool(), r.read_i8(), r.read_u16(), r.read_i32(), r.read_u64(), r.read_f64(),
           r.read_varint(), r.read_string(), r.read_option_string(), r.read_bytes(),
           r.read_bytes(), r.read_vec(r.read_i16)]
    assert got == [True, -5, 65535, -7, 2**64 - 1, 1.5, -300, "flüvio", None, None, b"abc",
                   [1, 2]]
    assert r.remaining() == 0
    with pytest.raises(codec.DecodeError):
        r.read_u8()
    assert {c.name: int(c) for c in ErrorCode} == {c.name: int(c) for c in RefErrorCode}
    err = FluvioError(ErrorCode.SMARTMODULE_NOT_FOUND, "x")
    assert str(err) == "SMARTMODULE_NOT_FOUND: x" and err.code == 5001


def test_smartmodule_input_output_and_invocation_wire_forms():
    port_recs = _records(record, 20, seed=8)
    ref_recs = _records(ref_record, 20, seed=8)
    port_in = sm_types.SmartModuleInput.from_records(port_recs, base_offset=50, base_timestamp=77)
    ref_in = ref_types.SmartModuleInput.from_records(ref_recs, base_offset=50, base_timestamp=77)
    wire = _encode(port_in, codec.ByteWriter)
    assert wire == _encode(ref_in, ref_codec.ByteWriter)
    back = sm_types.SmartModuleInput.decode(codec.ByteReader(wire))
    assert [_fields(r) for r in back.into_records()] == [_fields(r) for r in ref_recs]
    assert back.byte_size() == port_in.byte_size() == ref_in.byte_size()
    body = wire[12:-8]
    raw = sm_types.SmartModuleInput.from_raw(body, 20, base_offset=50, base_timestamp=77)
    assert raw.byte_size() == len(body) and raw.record_count() == 20
    assert [r.offset for r in raw.into_smartmodule_records()] == [
        50 + r.offset_delta for r in ref_recs]

    err = sm_types.SmartModuleTransformRuntimeError(
        hint="bad", offset=9, kind=sm_types.SmartModuleKind.ARRAY_MAP, record_key=None,
        record_value=b"v")
    ref_err = ref_types.SmartModuleTransformRuntimeError(
        hint="bad", offset=9, kind=ref_types.SmartModuleKind.ARRAY_MAP, record_key=None,
        record_value=b"v")
    out = sm_types.SmartModuleOutput(successes=port_recs[:3], error=err)
    ref_out = ref_types.SmartModuleOutput(successes=ref_recs[:3], error=ref_err)
    wire = _encode(out, codec.ByteWriter)
    assert wire == _encode(ref_out, ref_codec.ByteWriter)
    assert str(sm_types.SmartModuleOutput.decode(codec.ByteReader(wire)).error) == str(ref_err)

    for kw in ({}, {"lookback_last": 5}, {"lookback_last": 3, "lookback_age_ms": 1000}):
        port_inv = schema.SmartModuleInvocation(
            wasm=schema.SmartModuleInvocationWasm.adhoc(bench.NORTH_STAR_MAP_SM),
            kind=schema.SmartModuleInvocationKind.MAP, params={"field": "name", "a": "b"},
            accumulator=b"10", name="m", **kw)
        ref_inv = ref_schema.SmartModuleInvocation(
            wasm=ref_schema.SmartModuleInvocationWasm.adhoc(bench.NORTH_STAR_MAP_SM),
            kind=ref_schema.SmartModuleInvocationKind.MAP, params={"field": "name", "a": "b"},
            accumulator=b"10", name="m", **kw)
        wire = _encode(port_inv, codec.ByteWriter)
        assert wire == _encode(ref_inv, ref_codec.ByteWriter)
        back = schema.SmartModuleInvocation.decode(codec.ByteReader(wire))
        assert back == port_inv
        config, ref_config = back.to_config(), ref_inv.to_config()
        assert (config.params, config.initial_data) == (ref_config.params, ref_config.initial_data)
        lb, ref_lb = back.lookback(), ref_inv.lookback()
        assert (lb is None) == (ref_lb is None)
        if lb is not None:
            assert (lb.last, lb.age_ms) == (ref_lb.last, ref_lb.age_ms)
    pre = schema.SmartModuleInvocation(wasm=schema.SmartModuleInvocationWasm.predefined("x"))
    wire = _encode(pre, codec.ByteWriter)
    assert ref_schema.SmartModuleInvocation.decode(ref_codec.ByteReader(wire)).wasm.name == "x"


def _slab(n: int, seed: int) -> bytes:
    w = ref_codec.ByteWriter()
    for rec in _records(ref_record, n, seed):
        rec.encode(w)
    return w.bytes()


@pytest.mark.parametrize("align", [1, 4])
def test_native_record_codec_matches_the_reference(align):
    raw = _slab(300, seed=11)
    got = native_records.decode_record_columns(raw, align=align)
    ref = (native_backend.decode_record_columns_aligned(raw) if align == 4
           else native_backend.decode_record_columns(raw))
    assert got["count"] == ref["count"] == 300 and got["parsed"] == ref["parsed"] == len(raw)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    exact = native_records.decode_record_columns(raw, align=1)
    args = [exact[k] for k in ("val_flat", "val_off", "key_flat", "key_off", "key_present",
                               "off_delta", "ts_delta")]
    assert native_records.encode_record_columns(*args) == native_backend.encode_record_columns(
        *args) == raw
    # a truncated slab: whole records before the cut, `parsed` short of it
    for cut in (len(raw) - 1, len(raw) // 2, 3, 0):
        got = native_records.decode_record_columns(raw[:cut], align=align)
        ref = native_backend.decode_record_columns_aligned(raw[:cut])
        assert (got["count"], got["parsed"]) == (ref["count"], ref["parsed"])
        assert got["parsed"] < cut or cut == 0
    with pytest.raises(ValueError, match="disagree"):
        native_records.encode_record_columns(*args[:4], args[4][:-1], *args[5:])


def test_record_buffer_constructors_and_columns_match_the_reference():
    raw = _slab(100, seed=13)
    ref_cols = native_backend.decode_record_columns_aligned(raw)
    port_cols = native_records.decode_record_columns(raw, align=4)
    ref_flat = RefBuffer.from_flat(ref_cols, base_offset=3, base_timestamp=4)
    port_flat = RecordBuffer.from_flat(port_cols, base_offset=3, base_timestamp=4)
    assert port_flat.values is None and port_flat._flat is port_cols["val_flat"]
    ref_exact = native_backend.decode_record_columns(raw)
    for ref_buf, port_buf in (
        (ref_flat, port_flat),
        (RefBuffer.from_columns(ref_exact), RecordBuffer.from_columns(
            native_records.decode_record_columns(raw, align=1))),
        (RefBuffer.from_records(ref_flat.to_records(), 3, 4),
         RecordBuffer.from_records(port_flat.to_records(), 3, 4)),
    ):
        assert (port_buf.rows, port_buf.width, port_buf.count) == (
            ref_buf.rows, ref_buf.width, ref_buf.count)
        for name in ("lengths", "keys", "key_lengths", "offset_deltas", "timestamp_deltas"):
            np.testing.assert_array_equal(getattr(port_buf, name), getattr(ref_buf, name),
                                          err_msg=name)
        got, want = port_buf.to_columns(), ref_buf.to_columns()
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
        assert [_fields(r) for r in port_buf.to_records()] == [
            _fields(r) for r in ref_buf.to_records()]
        np.testing.assert_array_equal(port_buf.dense_values(), ref_buf.dense_values())
    # the columns re-encode to the slab
    cols = port_flat.to_columns()
    assert native_records.encode_record_columns(
        cols["val_flat"], cols["val_off"], cols["key_flat"], cols["key_off"],
        cols["key_present"], cols["off_delta"], cols["ts_delta"]) == raw
    empty = RecordBuffer.from_flat(native_records.decode_record_columns(b""))
    assert empty.count == 0 and empty.to_records() == []


def test_load_source_builds_the_reference_programs():
    for payload in (bench.NORTH_STAR_FILTER_SM, bench.NORTH_STAR_MAP_SM):
        port_m = sdk.load_source(payload, name="n")
        ref_m = ref_sdk.load_source(payload, name="n")
        kind = port_m.transform_kind()
        assert kind.value == ref_m.transform_kind().value and port_m.name == "n"
        assert repr(port_m.dsl_program(kind)) == repr(ref_m.dsl_program(ref_m.transform_kind()))
        assert type(port_m.dsl_program(kind)).__module__ == "fluvio_tpu_torch.smartmodule.dsl"
    with pytest.raises(ValueError, match="exports no transform"):
        sdk.load_source("x = 1")
    with pytest.raises(ValueError, match="duplicate"):
        sdk.load_source("@smartmodule.map\ndef a(r): pass\n@smartmodule.map\ndef b(r): pass\n")
    # a transform without a DSL program loads, and the engine refuses it
    m = sdk.load_source("@smartmodule.filter\ndef f(record):\n    return True\n")
    assert m.dsl_program(m.transform_kind()) is None


def test_record_codec_build_failure_raises(monkeypatch, tmp_path):
    """A codec library that does not build raises, and the consume path
    raises with it (no Python decoder or decline takes its place)."""
    from fluvio_tpu_torch.smartengine import SmartEngine
    from fluvio_tpu_torch.spu import smart_chain
    from tests.test_torch_isolation import broker_log, gen_json, north_star_invocations

    _wires, batches = broker_log(gen_json(16), 8)
    chain = smart_chain.build_chain(north_star_invocations(), SmartEngine(device="cpu"))
    bad = tmp_path / "records.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_records, "_SOURCE", bad)
    monkeypatch.setattr(native_records, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_records, "_lib", None)
    with pytest.raises(native_records.RecordCodecUnavailable, match="did not build"):
        native_records.decode_record_columns(b"")
    with pytest.raises(native_records.RecordCodecUnavailable):
        smart_chain.process_batches(chain, batches, 1 << 20)


_DELTAS = st.one_of(st.integers(-70, 70), st.integers(-(1 << 63), (1 << 63) - 1),
                    st.sampled_from([8191, 8192, -8192, 1 << 20]))
# fields of 8,180-8,200 bytes, built from a small draw (a seed string
# repeated to a drawn length): drawing them whole can overrun hypothesis's
# draw buffer (``data_too_large``)
_WIDE_FIELD = st.tuples(st.binary(min_size=1, max_size=16), st.integers(8180, 8200)).map(
    lambda t: (t[0] * (t[1] // len(t[0]) + 1))[:t[1]])
_FIELD = st.one_of(st.binary(max_size=8), st.binary(min_size=60, max_size=70), _WIDE_FIELD)
_RECORDS = st.lists(st.tuples(_FIELD, st.one_of(st.none(), _FIELD), st.integers(-128, 127),
                              _DELTAS, _DELTAS), max_size=5)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(fields=_RECORDS, cuts=st.lists(st.tuples(st.integers(0, 1 << 16), st.integers(0, 255)),
                                      max_size=3), truncate=st.integers(0, 1 << 16))
def test_record_section_codec_matches_the_record_codec_and_the_reference(fields, cuts, truncate):
    """A batch's record section (`record._encode_records` /
    `_decode_records`, the produce path's codec) writes the bytes the JAX
    package's `Record.encode` writes for each record, and each record's
    `write_size` equals the reference's; it reads them back as the
    records. On the section with bytes changed and cut short, it returns
    what `Record.decode` record by record returns, or raises the same
    error type."""
    port = [record.Record(value=v, key=k, attributes=a, timestamp_delta=t, offset_delta=o)
            for v, k, a, t, o in fields]
    ref = [ref_record.Record(value=v, key=k, attributes=a, timestamp_delta=t, offset_delta=o)
           for v, k, a, t, o in fields]
    w = ref_codec.ByteWriter()
    for r in ref:
        r.encode(w)
    section = record._encode_records(port)
    assert section == bytes(w.buf)
    assert [r.write_size() for r in port] == [r.write_size() for r in ref]
    assert record._decode_records(section, len(port)) == port
    broken = bytearray(section)
    for at, byte in cuts:
        if broken:
            broken[at % len(broken)] = byte
    del broken[truncate % (len(broken) + 1):]

    def outcome(decode):
        try:
            return "ok", decode()
        except Exception as e:  # noqa: BLE001 — the error's type is compared
            return "error", type(e)

    def one_by_one():
        r = codec.ByteReader(bytes(broken))
        return [record.Record.decode(r) for _ in port]

    assert outcome(lambda: record._decode_records(bytes(broken), len(port))) == outcome(one_by_one)
