"""The port's native lz4 / snappy codecs and its deferred finish, against
the JAX package, on the CPU (tolerance 0).

- ``fluvio_tpu_torch/native/codecs.cpp`` through
  ``protocol/native_codecs.py`` compresses every input to the JAX native
  codec's bytes (hypothesis draws, empty, past 64 KiB, incompressible,
  runs); each package's output decodes through the other's native and
  pure-Python codecs; malformed frames raise in both; with the library
  unbuildable ``compress`` / ``decompress`` raise, nothing falls back.
- A stored lz4 or snappy batch decodes through the port's consume slice
  to the JAX package's bytes.
- The deferred finish (`GpuChainExecutor.finish_buffer_deferred`, the
  fetch worker in `gpu_finish` and ``process_stream``): outputs equal to
  the finish run inline and to the JAX engine, over slices of several
  chunks and streams of several batches; a `GpuSpill` in chunk 2 of 3
  (batch 2 of 3) leaves the carries and the discarded handles, and the
  batches delivered, as the inline finish does.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fluvio_tpu.protocol import compression as ref_compression
from fluvio_tpu.protocol import lz4_py as ref_lz4_py
from fluvio_tpu.protocol import native_codecs as ref_native
from fluvio_tpu.protocol import snappy_py as ref_snappy_py
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.protocol import codec as ref_codec
from fluvio_tpu_torch.protocol import lz4_py, native_codecs, snappy_py
from fluvio_tpu_torch.protocol.compression import Compression, compress, decompress
from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import executor as gpu_executor
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartengine.gpu.executor import GpuSpill
from fluvio_tpu_torch.spu import smart_chain as sc
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_consume import _both, _chains, _decode, _north_star, small_chunks  # noqa: F401
from tests.test_torch_isolation import gen_json
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401

CODECS = {
    "lz4": (native_codecs.lz4_compress, native_codecs.lz4_decompress, lz4_py, ref_lz4_py,
            ref_native.lz4_module, lz4_py.Lz4Error, ref_lz4_py.Lz4Error),
    "snappy": (native_codecs.snappy_compress, native_codecs.snappy_decompress, snappy_py,
               ref_snappy_py, ref_native.snappy_module, snappy_py.SnappyError,
               ref_snappy_py.SnappyError),
}


def _fixed_inputs():
    rng = np.random.default_rng(17)
    runs = b"".join(bytes([k]) * int(n) for k, n in zip(rng.integers(0, 4, 300),
                                                         rng.integers(1, 700, 300)))
    return {
        "empty": b"",
        "one": b"x",
        "past_64k": b"".join(gen_json(3000, seed=5)),
        "incompressible": rng.integers(0, 256, 90_000, dtype=np.uint8).tobytes(),
        "runs": runs,
        "zeros_1m": bytes(1 << 20),
    }


def _round_trip(codec: str, data: bytes) -> None:
    comp, decomp, plain, ref_plain, ref_module, _, _ = CODECS[codec]
    ref = ref_module()
    assert ref is not None, "the JAX package's native codec did not build"
    out = comp(data)
    assert out == ref.compress(data)
    assert decomp(out) == data
    assert ref.decompress(out) == data
    assert plain.decompress(out) == data
    assert ref_plain.decompress(out) == data
    # and the pure-Python codecs' frames decode natively
    assert decomp(plain.compress(data)) == data


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("name", sorted(_fixed_inputs()))
def test_native_codec_equals_the_jax_native_codec(codec, name):
    _round_trip(codec, _fixed_inputs()[name])


@pytest.mark.parametrize("codec", sorted(CODECS))
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.one_of(st.binary(max_size=2048),
                      st.lists(st.sampled_from([b"fluvio", b"ab", b"\x00", b"xyz" * 9]),
                               max_size=400).map(b"".join)))
def test_native_codec_equals_the_jax_native_codec_on_drawn_bytes(codec, data):
    _round_trip(codec, data)


def _malformed(codec: str):
    comp = CODECS[codec][0]
    good = comp(b"".join(gen_json(400, seed=9)))
    return [b"\x05", b"\xff" * 9, good[: len(good) // 2], good[:-1], good[:5],
            bytes([good[0] ^ 0x5A]) + good[1:]]


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_malformed_frames_raise_in_both_packages(codec):
    _, decomp, _, _, ref_module, err, ref_err = CODECS[codec]
    for frame in _malformed(codec):
        with pytest.raises(err):
            decomp(frame)
        with pytest.raises(ref_err):
            ref_module().decompress(frame)


@pytest.mark.parametrize("codec", [Compression.LZ4, Compression.SNAPPY])
@pytest.mark.parametrize("source", ["missing", "broken"])
def test_an_unbuildable_library_raises_and_nothing_falls_back(codec, source, tmp_path,
                                                              monkeypatch):
    cpp = tmp_path / "codecs.cpp"
    if source == "broken":
        cpp.write_text("this is not C++\n")
    monkeypatch.setattr(native_codecs, "_SOURCE", cpp)
    monkeypatch.setattr(native_codecs, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_codecs, "_lib", None)
    with pytest.raises(native_codecs.CodecLibraryUnavailable):
        compress(codec, b"fluvio" * 100)
    with pytest.raises(native_codecs.CodecLibraryUnavailable):
        decompress(codec, b"\x00" * 16)
    # gzip keeps its own path
    assert decompress(Compression.GZIP, compress(Compression.GZIP, b"abc")) == b"abc"


@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_batches_compress_to_the_jax_packages_bytes(codec):
    """A record batch's compressed section through the port's
    `compress` equals the JAX package's `compress` (its codec choice: the
    wheel, else the same native library)."""
    assert ref_compression.lz4_codec()[1] in ("native", "wheel")
    data = b"".join(gen_json(5000, seed=11))
    assert compress(Compression[codec], data) == ref_compression.compress(
        ref_compression.Compression[codec], data)


def _compressed_stored(groups, bases, first_ts, codec):
    """`tests/test_torch_consume._stored` with each batch's records
    compressed by the JAX package."""
    out = []
    for values, base, ts in zip(groups, bases, first_ts):
        recs = [ref_record.Record(value=v, offset_delta=i, timestamp_delta=3 * i)
                for i, v in enumerate(values)]
        b = ref_record.Batch.from_records(recs, base_offset=base, first_timestamp=ts,
                                          compression=ref_compression.Compression[codec],
                                          preserve_offsets=True)
        w = ref_codec.ByteWriter()
        b.encode(w)
        out.append(w.bytes())
    return out


@pytest.mark.parametrize("codec", ["LZ4", "SNAPPY"])
def test_a_compressed_stored_batch_through_the_consume_slice(codec, small_chunks):
    """Stored lz4 / snappy batches (written by the JAX package) through the
    port's coalesced slice equal the JAX package's slice, byte for byte,
    with the slice's ``decompress`` phase timed."""
    ref_chain, port_chain = _north_star()
    groups = [gen_json(n, seed=40 + k) for k, n in enumerate((150, 90, 130))]
    bases = [0, 150, 240]
    wires = _compressed_stored(groups, bases, [2_000_000 + k for k in range(3)], codec)
    _, port_b = _decode(wires)
    assert all(b.header.compression() == Compression[codec] for b in port_b)
    out = _both(ref_chain, port_chain, wires)
    assert out.phase_ms["decompress"] > 0 and len(out.records.batches) == 1


# -- the deferred finish ------------------------------------------------------


class _InlinePool:
    """A pool that runs each job at once: the finish without the overlap."""

    def submit(self, fn, *args):
        fut = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 — the future carries it
            fut.set_exception(e)
        return fut


@pytest.fixture
def inline_pool(monkeypatch):
    def use():
        monkeypatch.setattr(gpu_executor, "fetch_mat_pool", lambda: _InlinePool())
        monkeypatch.setattr(sc, "fetch_mat_pool", lambda: _InlinePool())
    return use


def _set_bytes(res) -> bytes:
    from fluvio_tpu_torch.protocol.codec import ByteWriter

    w = ByteWriter()
    res.records.encode(w)
    return w.bytes()


@pytest.mark.parametrize("chain", ["north_star", "regex_filter"])
def test_deferred_slice_equals_the_inline_finish_and_the_reference(chain, small_chunks,
                                                                   inline_pool):
    """A slice of 9 chunks of 64 rows: the deferred finish, the inline one
    and the JAX package give the same bytes and next offset."""
    from tests.test_torch_consume import _stored

    def chains():
        if chain == "north_star":
            return _north_star()
        return _chains([("regex-filter", {"regex": "flu[vV]io"}, b"")])

    groups = [gen_json(n, seed=60 + k) for k, n in enumerate((120, 80, 100, 90, 110, 60))]
    bases = np.cumsum([0] + [len(g) for g in groups])[:-1].tolist()
    wires = _stored(groups, bases, [1_000_000 + k for k in range(6)])
    ref_chain, port_chain = chains()
    _, port_b = _decode(wires)
    pending = sc.gpu_stage_dispatch(port_chain, port_b)
    assert len(pending.chunks) == 9
    deferred = _both(ref_chain, port_chain, wires)
    inline_pool()
    inline = sc.process_batches(chains()[1], _decode(wires)[1], 1 << 20)
    assert _set_bytes(inline) == _set_bytes(deferred)
    assert inline.next_offset == deferred.next_offset


def _recording_discards(monkeypatch, gpu):
    seen = []
    orig = gpu.discard_dispatch

    def discard(handle):
        seen.append(handle)
        orig(handle)

    monkeypatch.setattr(gpu, "discard_dispatch", discard)
    return seen


def _spill_on_second_finish(monkeypatch, gpu):
    calls = []
    orig = gpu._finish

    def finish(buf, handle):
        calls.append(handle)
        if len(calls) == 2:
            raise GpuSpill("injected on chunk 2", reason="transform-error")
        return orig(buf, handle)

    monkeypatch.setattr(gpu, "_finish", finish)


def _spill_in_chunk_two(monkeypatch, inline: bool, inline_pool):
    from tests.test_torch_consume import _stored

    if inline:
        inline_pool()
    _, port_chain = _north_star()
    gpu = port_chain.gpu_chain
    groups = [gen_json(n, seed=70 + k) for k, n in enumerate((64, 64, 64))]
    wires = _stored(groups, [0, 64, 128], [1_000_000] * 3)
    pending = sc.gpu_stage_dispatch(port_chain, _decode(wires)[1])
    assert len(pending.chunks) == 3
    handles = [h for _, h in pending.chunks]
    discarded = _recording_discards(monkeypatch, gpu)
    _spill_on_second_finish(monkeypatch, gpu)
    gpu._device_carries = ("sentinel",)
    with pytest.raises(GpuSpill, match="chunk 2"):
        sc.gpu_finish(port_chain, pending, 1 << 20)
    return ([handles.index(h) for h in discarded], gpu._device_carries == handles[1].prev_carries)


def test_a_spill_in_chunk_two_of_three_leaves_what_the_inline_finish_leaves(
        small_chunks, inline_pool, monkeypatch):
    deferred = _spill_in_chunk_two(monkeypatch, False, inline_pool)
    inline = _spill_in_chunk_two(monkeypatch, True, inline_pool)
    assert deferred == inline == ([2, 1], True)


def _stream_chain():
    b = SmartEngine(device="cpu").builder()
    from fluvio_tpu_torch.models import lookup

    b.add_smart_module(SmartModuleConfig(params={"regex": "fluvio"}), lookup("regex-filter"))
    b.add_smart_module(SmartModuleConfig(params={"field": "name"}), lookup("json-map"))
    return b.initialize().gpu_chain


def _columns(out: RecordBuffer):
    return [r.value for r in out.to_records()]


def test_deferred_process_stream_equals_process_buffer_and_the_reference():
    """Five batches through ``process_stream`` (the fetch worker rebuilds
    batch k while batch k+1 dispatches) equal ``process_buffer`` a batch
    and the JAX engine's ``process_stream``."""
    from fluvio_tpu.models import lookup as ref_lookup
    from fluvio_tpu.smartengine import SmartEngine as RefEngine
    from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
    from tests.test_torch_chain import _port_buffer, _ref_buffer

    batches = [gen_json(n, seed=80 + k) for k, n in enumerate((300, 0, 257, 1, 512))]
    ref_bufs = [_ref_buffer(v) for v in batches]
    chain = _stream_chain()
    streamed = [_columns(o) for o in chain.process_stream(_port_buffer(b) for b in ref_bufs)]
    single = [_columns(_stream_chain().process_buffer(_port_buffer(b))) for b in ref_bufs]
    rb = RefEngine(backend="tpu").builder()
    rb.add_smart_module(RefConfig(params={"regex": "fluvio"}), ref_lookup("regex-filter"))
    rb.add_smart_module(RefConfig(params={"field": "name"}), ref_lookup("json-map"))
    ref = rb.initialize().tpu_chain
    ref_out = [[r.value for r in o.to_records()] for o in ref.process_stream(iter(ref_bufs))]
    assert streamed == single == ref_out
    assert sum(map(len, streamed)) > 0


def _stream_with_spill(monkeypatch, inline: bool, inline_pool):
    if inline:
        inline_pool()
    chain = _stream_chain()
    _spill_on_second_finish(monkeypatch, chain)
    got = []
    with pytest.raises(GpuSpill, match="chunk 2"):
        for out in chain.process_stream(RecordBuffer.from_values(gen_json(200, seed=90 + k))
                                        for k in range(3)):
            got.append(_columns(out))
    return got


def test_a_spill_in_batch_two_of_three_delivers_what_the_inline_stream_delivers(
        inline_pool, monkeypatch):
    deferred = _stream_with_spill(monkeypatch, False, inline_pool)
    inline = _stream_with_spill(monkeypatch, True, inline_pool)
    assert len(deferred) == 1 and deferred == inline


def test_the_fetch_pool_is_one_process_wide_worker():
    pool = gpu_executor.fetch_mat_pool()
    assert pool is gpu_executor.fetch_mat_pool() and pool._max_workers == 1
    names = pool.submit(lambda: __import__("threading").current_thread().name).result()
    assert names.startswith("fetch-mat") and os.getpid() > 0
