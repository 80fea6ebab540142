"""The port's glz link (``gpu/glz.py`` and the two glz kernels' plain
versions) against the JAX package's ``smartengine/tpu/glz.py`` and
``pallas_kernels`` (Pallas in interpret mode), on the CPU.

Inputs are made with numpy from fixed seeds; the same bytes go through both
packages. Every output is bytes or integers, so every check is exact
(tolerance 0): tokens, depths, chunk tables, byte plans and roots. The
port's kernel wrappers run their plain torch versions here, since the
tensors lie on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.smartengine.tpu import glz as ref_glz
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu.smartengine.tpu.executor import TpuChainExecutor
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
from fluvio_tpu_torch.smartengine.gpu.executor import (
    desc_split,
    desc_stream,
    pad_glz_tokens,
)

CHUNK = 4096


def _json(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    names = ["fluvio", "kafka", "pulsar", "fluvio-tpu", "redpanda", "flink"]
    vals = [
        f'{{"name":"{names[rng.integers(0, 6)]}-{i & 255}","n":{rng.integers(0, 100000)}}}'.encode()
        for i in range(n)
    ]
    return np.frombuffer(b"".join(vals), dtype=np.uint8).copy()


# the decode corpora of tests/test_glz_pallas.py, cut to a few chunks
DECODE_CORPORA = {
    "json": lambda: _json(500, 2024),
    "zeros": lambda: np.zeros(12 * 1024, np.uint8),
    "period28": lambda: np.frombuffer(b'{"name":"fluvio-1","n":123}\n' * 500, np.uint8).copy(),
    "mixed": lambda: np.concatenate([
        _json(150, 1), np.random.default_rng(3).integers(0, 256, 1500).astype(np.uint8),
        _json(150, 5),
    ]),
    "wide": lambda: np.frombuffer(
        b"".join(b'{"name":"fluvio-%d","body":"' % (i & 7) + b"x" * 3000 + b'"}' for i in range(4)),
        np.uint8,
    ).copy(),
}


def _pad8(data: bytes) -> np.ndarray:
    out = np.zeros((len(data) + 7) & ~7, np.uint8)
    out[: len(data)] = np.frombuffer(data, np.uint8)
    return out


# the encode corpora of tests/test_glz_encode.py, cut to a few chunks
ENCODE_CORPORA = {
    "json": lambda: _pad8(b'{"name":"fluvio-7","n":123,"pad":"xyz"}' * 200),
    "periodic5": lambda: _pad8(bytes(range(5)) * 1200),
    "const": lambda: _pad8(b"x" * 9000),
    "zeros_tail": lambda: np.concatenate([
        np.random.default_rng(0).integers(0, 256, 1024).astype(np.uint8), np.zeros(7168, np.uint8),
    ]),
    "random": lambda: np.random.default_rng(1).integers(0, 256, 4096).astype(np.uint8),
    "tiny": lambda: _pad8(b"abcdefgh"),
    "vocab": lambda: _pad8(np.tile(np.array([1, 0, 7, 0, 6, 0, 250, 199], np.uint8), 900).tobytes()),
}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _both(name: str, chunk: int = CHUNK, max_ratio: float = 1.0):
    raw = DECODE_CORPORA[name]()
    port, port_reason = glz.compress_link(raw, max_ratio=max_ratio, chunk=chunk)
    ref, ref_reason = ref_glz.compress_link(raw, max_ratio=max_ratio, chunk=chunk)
    assert port_reason == ref_reason
    return raw, port, ref


@pytest.mark.parametrize("name", sorted(DECODE_CORPORA))
@pytest.mark.parametrize("chunk", [4096, 16384])
def test_compress_link_token_for_token(name, chunk):
    raw, port, ref = _both(name, chunk)
    assert port is not None, name
    for field in ("lit_lens", "match_lens", "srcs", "lits", "chunk_seqs"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field), err_msg=field)
        assert getattr(port, field).dtype == getattr(ref, field).dtype, field
    assert (port.depth, port.out_len, port.chunk_bytes) == (ref.depth, ref.out_len, ref.chunk_bytes)
    np.testing.assert_array_equal(glz.decompress_host(port), raw)
    np.testing.assert_array_equal(glz.decompress_numpy(port), raw)
    # the whole-buffer stream (one window) too
    whole, ref_whole = glz.compress(raw, max_ratio=1.0), ref_glz.compress(raw, max_ratio=1.0)
    for a, b in zip(whole, ref_whole):
        np.testing.assert_array_equal(a, b)


def test_decline_reasons_and_chunk_validation():
    tiny = np.zeros(64, np.uint8)
    assert glz.compress_link(tiny) == (None, glz.DECLINE_BELOW_MIN)
    assert ref_glz.compress_link(tiny) == (None, ref_glz.DECLINE_BELOW_MIN)
    noise = np.random.default_rng(11).integers(0, 256, 32 * 1024).astype(np.uint8)
    assert glz.compress_link(noise, chunk=CHUNK) == (None, glz.DECLINE_RATIO)
    assert ref_glz.compress_link(noise, chunk=CHUNK) == (None, ref_glz.DECLINE_RATIO)
    # one incompressible chunk sinks the stream, whatever the ratio limit
    sunk = np.concatenate([_json(300, 2), noise[:8192], _json(300, 4)])
    assert glz.compress_link(sunk, max_ratio=1.0, chunk=CHUNK) == (None, glz.DECLINE_RATIO)
    assert ref_glz.compress_link(sunk, max_ratio=1.0, chunk=CHUNK) == (None, ref_glz.DECLINE_RATIO)
    for bad in (0, 1024, 5000, 4096 + 512):
        with pytest.raises(ValueError):
            glz.compress_link(_json(300, 1), chunk=bad)
        with pytest.raises(ValueError):
            glz.LinkParams(chunk=bad)
    assert glz.LinkParams() == glz.LinkParams(False, False, 256 * 1024)


def test_port_compressor_is_its_own_copy():
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    assert glz._SOURCE.is_relative_to(repo / "fluvio_tpu_torch")
    assert glz._SOURCE.read_bytes() == (repo / "fluvio_tpu" / "native" / "glz.cpp").read_bytes()


def _ref_plan(ll, ml, srcs, lits, out_len):
    base, midx = jax.jit(lambda *a: ref_glz.byte_plan_device(*a, out_len))(
        jnp.asarray(ll), jnp.asarray(ml), jnp.asarray(srcs), jnp.asarray(lits))
    return np.asarray(base), np.asarray(midx)


@pytest.mark.parametrize("name", ["json", "mixed", "period28"])
def test_byte_plan_and_decoders_match(name):
    """byte_plan_device (bare and with the executor's padded tokens),
    the plain resolve against the Pallas kernel in interpret mode, and
    decompress_device against the JAX gather rounds."""
    raw, comp, _ = _both(name)
    out_len = comp.out_len
    for ll, ml, srcs, lits in (comp[:4], pad_glz_tokens(comp)):
        base, midx = glz.byte_plan_device(_t(ll), _t(ml), _t(srcs), _t(lits), out_len)
        assert base.dtype == torch.uint8 and midx.dtype == torch.int32
        ref_base, ref_midx = _ref_plan(ll, ml, srcs, lits, out_len)
        np.testing.assert_array_equal(base.numpy(), ref_base)
        np.testing.assert_array_equal(midx.numpy(), ref_midx)
    got = cuda_kernels.glz_resolve(base, midx, CHUNK)
    want = pallas_kernels.glz_decode_pallas(jnp.asarray(ref_base), jnp.asarray(ref_midx), CHUNK,
                                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), raw)
    dev = glz.decompress_device(*map(_t, comp[:4]), comp.depth, out_len)
    ref_dev = ref_glz.decompress_device(*map(jnp.asarray, comp[:4]), jnp.int32(comp.depth), out_len)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(ref_dev))
    np.testing.assert_array_equal(dev.numpy(), raw)


@pytest.mark.parametrize("name", sorted(DECODE_CORPORA))
def test_resolve_every_corpus(name):
    """The plain resolve (and the link decode around it) inflates every
    corpus at two chunk sizes, with padded tokens and ragged last chunks."""
    for chunk in (4096, 16384):
        raw, comp, _ = _both(name, chunk)
        assert comp.out_len % chunk or name == "zeros"
        ll, ml, srcs, lits = pad_glz_tokens(comp)
        out = glz.decode_link_flat((_t(ll), _t(ml), _t(srcs)), _t(lits), comp.out_len, chunk)
        assert out.dtype == torch.uint8
        np.testing.assert_array_equal(out.numpy(), raw)


def test_deep_chains_resolve():
    raw = _json(2500, 7)
    comp, _ = glz.compress_link(raw, max_ratio=1.0, chunk=64 * 1024)
    assert comp.depth == glz.MAX_DEPTH
    base, midx = glz.byte_plan_device(*map(_t, comp[:4]), comp.out_len)
    np.testing.assert_array_equal(kernels.glz_resolve(base, midx, 64 * 1024).numpy(), raw)


def test_resolve_clips_sources_into_their_chunk():
    """A source outside its chunk (never emitted by compress_link) is
    clipped into the chunk, and pad bytes of the ragged last chunk read 0."""
    base = torch.arange(300, dtype=torch.int32).to(torch.uint8)
    midx = torch.arange(300, dtype=torch.int32)
    midx[5], midx[130], midx[260] = 200, 3, 299
    midx[299] = 5000
    got = kernels.glz_resolve(base, midx, 128)
    want = base.clone()
    want[5], want[130], want[260], want[299] = 127, 128, 0, 0
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        kernels.glz_resolve(base, midx, 100)


def _ref_words(raw):
    w0, w1 = ref_glz.enc_group_words(jnp.asarray(raw))
    return w0, w1


@pytest.mark.parametrize("chunk,names", [
    (8192, ["json", "vocab", "zeros_tail"]),  # one or two windows a corpus
    (1024, ["periodic5"]),  # many windows: chunk edges and the shortest window
])
def test_encode_match_matches_pallas(chunk, names):
    """The plain window match against the Pallas kernel (interpret mode) on
    the encode corpora; the group words and constant runs on the way."""
    cg = chunk // 8
    for name in names:
        raw = ENCODE_CORPORA[name]()
        w0, w1 = glz.enc_group_words(_t(raw))
        rw0, rw1 = _ref_words(raw)
        np.testing.assert_array_equal(w0.numpy(), np.asarray(rw0))
        np.testing.assert_array_equal(w1.numpy(), np.asarray(rw1))
        const_m, csrc = glz.enc_const_runs(w0, w1, cg)
        rconst, rcsrc = ref_glz.enc_const_runs(rw0, rw1, cg)
        np.testing.assert_array_equal(const_m.numpy(), np.asarray(rconst))
        np.testing.assert_array_equal(csrc.numpy(), np.asarray(rcsrc))
        got = cuda_kernels.glz_encode_match(w0, w1, const_m, cg)
        want = pallas_kernels.glz_encode_match(rw0, rw1, rconst, cg, interpret=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def test_encode_match_chain_spans_a_chunk():
    """A period-2 corpus chains every group back to the chunk's first two:
    the squaring rounds must carry chains across the whole chunk."""
    cg = 256
    w0 = torch.tensor([7, 9] * 300, dtype=torch.int32)
    w1 = torch.zeros(600, dtype=torch.int32)
    roots = kernels.glz_encode_match(w0, w1, torch.zeros(600, dtype=torch.bool), cg)
    g = torch.arange(600, dtype=torch.int32)
    assert torch.equal(roots, (g // cg) * cg + g % 2)
    with pytest.raises(ValueError):
        kernels.glz_encode_match(w0, w1, torch.zeros(600, dtype=torch.bool), 100)


@pytest.mark.parametrize("name", ["json", "const", "random", "tiny"])
def test_encode_result_matches_pallas_variant(name):
    """All seven outputs of encode_result against the JAX package's pallas
    variant, and every stream decodes back to its raw bytes."""
    raw = ENCODE_CORPORA[name]()
    got = [x.numpy() for x in glz.encode_result(_t(raw), CHUNK)]
    want = [np.asarray(x) for x in jax.jit(lambda r: ref_glz.encode_result(
        r, CHUNK, "pallas", interpret=True))(jnp.asarray(raw))]
    for k, (a, b) in enumerate(zip(got, want)):
        if k < 4:  # the token arrays keep the reference's dtypes
            assert a.dtype == b.dtype, (name, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} output {k}")
    ll, ml, srcs, lits, n_seq, n_lit, depth = got
    back = glz.decode_result_host(ll, ml, srcs, lits, int(n_seq), int(n_lit), len(raw), int(depth))
    np.testing.assert_array_equal(back, raw)


@pytest.mark.parametrize("width", [64, 200, 256, 60000, 1 << 20])
def test_desc_stream_and_split_match_the_reference(width):
    rng = np.random.default_rng(width)
    n, count = 37, 29
    st = rng.integers(0, width, n).astype(np.int32)
    ln = rng.integers(0, width + 1, n).astype(np.int32)
    got = desc_stream(_t(st), _t(ln), width)
    want = np.asarray(TpuChainExecutor._desc_stream(jnp.asarray(st), jnp.asarray(ln), width))
    assert got.dtype == torch.uint8 and got.shape[0] % 8 == 0
    np.testing.assert_array_equal(got.numpy(), want)
    pst, pln = desc_split(got.numpy(), count, width)
    rst, rln = TpuChainExecutor._desc_split(want, count, width)
    np.testing.assert_array_equal(pst, rst)
    np.testing.assert_array_equal(pln, rln)
    np.testing.assert_array_equal(pst, st[:count])
    np.testing.assert_array_equal(pln, ln[:count])


def test_interop_carries_the_reference_stream():
    """A JAX-package stream, carried into the port, decodes through the
    port's plan and plain resolve to the same bytes."""
    raw = DECODE_CORPORA["json"]()
    ref, _ = ref_glz.compress_link(raw, max_ratio=1.0, chunk=CHUNK)
    comp = interop.glz_from_reference(ref)
    assert isinstance(comp, glz.Compressed) and comp.chunk_bytes == CHUNK
    ll, ml, srcs, lits = pad_glz_tokens(comp)
    out = glz.decode_link_flat((_t(ll), _t(ml), _t(srcs)), _t(lits), comp.out_len, CHUNK)
    np.testing.assert_array_equal(out.numpy(), raw)


def test_cpu_wrappers_count_no_launch():
    cuda_kernels.reset_launches()
    raw = ENCODE_CORPORA["json"]()
    glz.encode_result(_t(raw), 4096)
    comp, _ = glz.compress_link(_json(300, 3), chunk=CHUNK)
    glz.decode_link_flat(tuple(map(_t, comp[:3])), _t(comp.lits), comp.out_len, CHUNK)
    assert cuda_kernels.LAUNCHES["glz_resolve"] == 0 and cuda_kernels.LAUNCHES["glz_enc_match"] == 0
