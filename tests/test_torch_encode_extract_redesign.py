"""The redesigned ``glz_encode.cu`` (TPU kernel #4) and ``extract.cu`` (TPU
kernel #2) as executable specs against the JAX package, on the CPU, and the
long-key repair of the span wrappers.

- `tiled_match`, a numpy model of ``csrc/glz_encode.cu``'s two launches
  (tiles of ``kTile`` groups with a 128-group halo, pointer jumps inside the
  tile, exits into the halo; then the join over the previous tiles' tails,
  staged ``kWindow`` at a time, with blocks in any order reading tiles that
  other blocks rewrite), against the plain `kernels.glz_encode_match` and
  the JAX package's Pallas kernel in interpret mode: the encode corpora of
  ``tests/test_glz_encode.py``, chunks of 128 to 65,536 groups, a period-2
  stream across many tile borders, chunks of exactly one tile, constant runs
  across the halo and ragged last chunks;
- `segment_extract`, a numpy model of ``csrc/extract.cu`` (16-byte segments,
  aligned word loads shifted by funnel shifts, the byte path), and the plain
  `kernels.extract_span`, against the JAX package's gather on random spans
  with overruns and negative starts at widths 1 to 1,000;
- the plain span version on a 49,151-byte key, against the JAX package.

The model's tile, halo and window are read from the CUDA source, so the two
cannot drift apart. Inputs are made with numpy from fixed seeds; every output
is an integer or a byte, so every check is exact (tolerance 0). The kernels
themselves are held to the plain versions on the card by
``tests/test_torch_isolation.py`` (marker ``cuda``) and ``chip_smoke.py``.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
from fluvio_tpu_torch.smartengine.gpu.native import CSRC
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401


def _cu_constant(source: str, name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert found, f"{name} not in {source}"
    return int(found.group(1))


TILE = _cu_constant("glz_encode.cu", "kTile")
HALO = _cu_constant("glz_encode.cu", "kHalo")
WINDOW = _cu_constant("glz_encode.cu", "kWindow")
SEG = _cu_constant("extract.cu", "kSeg")


def _forward(n):
    return range(n)


def _backward(n):
    return range(n - 1, -1, -1)


def _shuffled(n):
    return np.random.default_rng(n).permutation(n)


ORDERS = (_forward, _backward, _shuffled)


def tiled_match(w0, w1, const_m, chunk_groups: int, tile: int = TILE, window: int = WINDOW,
                order=_forward) -> np.ndarray:
    """``csrc/glz_encode.cu`` in numpy: global roots int64[G]. ``order``
    gives the order in which the join's blocks run; each reads the roots
    array as the blocks before it left it."""
    w0, w1, cm = (np.asarray(x) for x in (w0, w1, const_m))
    g_count = w0.size
    tile = min(chunk_groups, tile)
    tiles_per_chunk = -(-chunk_groups // tile)
    n_blocks = -(-g_count // chunk_groups) * tiles_per_chunk
    rounds = (tile - 1).bit_length()
    out = np.zeros(g_count, np.int64)

    def geometry(block):
        c, t = divmod(block, tiles_per_chunk)
        base = c * chunk_groups + t * tile
        return c, t, base, min(tile, chunk_groups - t * tile, g_count - base)

    # enc_tile: probe from the staged tile and halo, jump inside the tile
    for block in range(n_blocks):
        c, t, base, tl = geometry(block)
        if base >= g_count:
            continue
        hl = HALO if t else 0
        frm = base - hl
        a, b, cc = w0[frm: base + tl], w1[frm: base + tl], cm[frm: base + tl]
        p = np.arange(hl, hl + tl)
        local = t * tile + np.arange(tl)
        cand = p.copy()
        open_ = ~cc[hl:]
        for d in kernels.GLZ_ENC_DISTANCES:  # ascending: the first hit wins
            if d >= chunk_groups:
                break
            s = p - d
            sc = np.maximum(s, 0)
            hit = open_ & (local >= d) & ~cc[sc] & (a[sc] == a[p]) & (b[sc] == b[p])
            cand[hit] = s[hit]
            open_ &= ~hit
        ptr = np.concatenate([np.arange(hl), cand])  # halo groups: fixed points
        for _ in range(rounds):
            ptr = ptr[ptr]
        q = ptr[hl:]
        out[base: base + tl] = np.where(q >= hl, frm + q, -(frm + q) - 1)
    if tiles_per_chunk == 1:
        return out

    # enc_join: resolve the previous tile's tail, then the tile's exits
    for block in order(n_blocks):
        c, t, base, tl = geometry(block)
        if t == 0 or base >= g_count:
            continue
        cbase = c * chunk_groups
        lo = max(0, t - window)
        tails = np.concatenate([out[cbase + (u + 1) * tile - HALO: cbase + (u + 1) * tile]
                                for u in range(lo, t)])
        u = np.full(HALO, t - 1)
        k = np.arange(HALO)
        v = tails[(u - lo) * HALO + k]
        while True:
            m = (v < 0) & (u > lo)
            if not m.any():
                break
            k = np.where(m, -v - 1 - (cbase + u * tile - HALO), k)
            u = np.where(m, u - 1, u)
            v = np.where(m, tails[(u - lo) * HALO + k], v)
        while (v < 0).any():  # past the window, through the roots array
            v = np.where(v < 0, out[np.where(v < 0, -v - 1, 0)], v)
        seg = out[base: base + tl]
        ex = seg < 0
        seg[ex] = v[-seg[ex] - 1 - (base - HALO)]
    return out


def _pad8(data) -> np.ndarray:
    raw = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data
    out = np.zeros((len(raw) + 7) & ~7, np.uint8)
    out[: len(raw)] = raw
    return out


def _corpora():
    """`tests/test_glz_encode.py`'s corpora."""
    rng = np.random.default_rng(0)
    return {
        "json": _pad8(b'{"name":"fluvio-7","n":123,"pad":"xyz"}' * 700),
        "periodic5": _pad8(bytes(range(5)) * 4000),
        "const": _pad8(b"x" * 30000),
        "zeros_tail": np.concatenate([rng.integers(0, 256, 1024).astype(np.uint8),
                                      np.zeros(31744, np.uint8)]),
        "random": rng.integers(0, 256, 16384).astype(np.uint8),
        "tiny": _pad8(b"abcdefgh"),
        "vocab": _pad8(np.tile(np.array([1, 0, 7, 0, 6, 0, 250, 199], np.uint8), 3000)),
    }


def _inputs(w0: np.ndarray, w1: np.ndarray, chunk_groups: int):
    """Torch words and the port's constant-run mask (the JAX package's own,
    as tests/test_torch_glz.py shows)."""
    t0 = torch.from_numpy(np.ascontiguousarray(w0, dtype=np.int32))
    t1 = torch.from_numpy(np.ascontiguousarray(w1, dtype=np.int32))
    const_m, _ = glz.enc_const_runs(t0, t1, chunk_groups)
    return t0, t1, const_m


def _check_match(name: str, w0, w1, chunk_groups: int, pallas: bool = True, **model_kw):
    t0, t1, const_m = _inputs(w0, w1, chunk_groups)
    plain = kernels.glz_encode_match(t0, t1, const_m, chunk_groups).numpy()
    for order in ORDERS:
        got = tiled_match(t0.numpy(), t1.numpy(), const_m.numpy(), chunk_groups, order=order,
                          **model_kw)
        np.testing.assert_array_equal(got, plain, err_msg=f"{name} cg={chunk_groups} {order}")
    if pallas:
        want = pallas_kernels.glz_encode_match(jnp.asarray(t0.numpy()), jnp.asarray(t1.numpy()),
                                               jnp.asarray(const_m.numpy()), chunk_groups,
                                               interpret=True)
        np.testing.assert_array_equal(plain, np.asarray(want), err_msg=f"{name} cg={chunk_groups}")
    return plain


def test_model_geometry_is_the_kernels():
    """The model runs the kernel's geometry: tiles of whole halos, a window
    of several tiles."""
    assert HALO == max(kernels.GLZ_ENC_DISTANCES) == 128
    assert TILE % HALO == 0 and TILE >= HALO and WINDOW >= 2
    assert SEG == 16


@pytest.mark.parametrize("chunk_groups", [128, 512, 4096, 65536])
def test_tiled_match_on_the_encode_corpora(chunk_groups):
    for name, raw in _corpora().items():
        w = raw.view(np.int32).reshape(-1, 2)
        _check_match(name, w[:, 0], w[:, 1], chunk_groups)


@pytest.mark.parametrize("chunk_groups", [128, 4096, 65536])
def test_tiled_match_period_two_across_tile_borders(chunk_groups):
    """Every group chains back to its chunk's first two: each tile's tail
    exits, and the join walks back over every earlier tile. 70,000 groups
    leave a ragged last chunk at 4,096 and 65,536 groups a chunk."""
    g_count = 70000
    w0 = np.where(np.arange(g_count) % 2 == 0, 7, 9).astype(np.int32)
    roots = _check_match("period-2", w0, np.zeros(g_count, np.int32), chunk_groups)
    g = np.arange(g_count)
    np.testing.assert_array_equal(roots, (g // chunk_groups) * chunk_groups + g % 2)


def test_tiled_match_past_the_join_window():
    """A chunk of 131,072 groups has 64 tiles: the join's chase leaves its
    staged window of tails and walks the roots array."""
    g_count = 140000
    rng = np.random.default_rng(8)
    w0 = np.where(np.arange(g_count) % 2 == 0, 7, 9).astype(np.int32)
    w0[rng.integers(0, g_count, 300)] = rng.integers(100, 110, 300)  # breaks, some repeats
    _check_match("period-2 with breaks", w0, np.zeros(g_count, np.int32), 131072, pallas=False)


@pytest.mark.parametrize("tile,window", [(128, 2), (256, 1), (384, 3)])
def test_tiled_match_small_tiles(tile, window):
    """The same rules at small tiles and windows (the window left after a
    few tiles), on a mixed stream: few values, constant runs, random
    stretches."""
    rng = np.random.default_rng(tile + window)
    g_count = 9000
    w0 = rng.integers(0, 6, g_count).astype(np.int32)
    w1 = rng.integers(0, 2, g_count).astype(np.int32)
    for at in rng.integers(0, g_count - 200, 12):  # constant runs, some across halos
        w0[at: at + int(rng.integers(2, 200))] = 3
        w1[at: at + 50] = 1
    w0[4000:4600] = rng.integers(1000, 1 << 30, 600)  # a stretch with no matches
    for chunk_groups in (1024, 4096):
        t0, t1, const_m = _inputs(w0, w1, chunk_groups)
        plain = kernels.glz_encode_match(t0, t1, const_m, chunk_groups).numpy()
        for order in ORDERS:
            got = tiled_match(w0, w1, const_m.numpy(), chunk_groups, tile=tile, window=window,
                              order=order)
            np.testing.assert_array_equal(got, plain, err_msg=f"cg={chunk_groups} {order}")


def test_tiled_match_one_tile_chunks_and_constant_halos():
    """Chunks of exactly one tile (no join), and a stream whose halo groups
    sit in constant runs: they are neither probers nor targets."""
    rng = np.random.default_rng(21)
    g_count = 3 * TILE + 500
    w0 = rng.integers(0, 4, g_count).astype(np.int32)
    w1 = np.zeros(g_count, np.int32)
    for start in range(TILE - HALO, g_count, TILE):  # runs over every tile's tail
        w0[start - 3: start + 40] = 2
    _check_match("one-tile chunks", w0, w1, TILE)
    _check_match("constant halos", w0, w1, 4 * TILE)


def test_encode_match_wrapper_on_cpu_is_the_plain_version():
    raw = _corpora()["json"]
    w0, w1 = glz.enc_group_words(torch.from_numpy(raw))
    const_m, _ = glz.enc_const_runs(w0, w1, 512)
    cuda_kernels.reset_launches()
    got = cuda_kernels.glz_encode_match(w0, w1, const_m, 512)
    assert torch.equal(got, kernels.glz_encode_match(w0, w1, const_m, 512))
    assert cuda_kernels.LAUNCHES["glz_enc_match"] == 0


def segment_extract(values: np.ndarray, start: np.ndarray, vlen: np.ndarray) -> np.ndarray:
    """``csrc/extract.cu`` in numpy: a 16-byte segment at a time; where the
    width is a multiple of 16, a live segment whose window lies in the row
    reads aligned little-endian words and funnel-shifts them, every other
    one takes the byte rule."""
    n, width = values.shape
    out = np.zeros((n, width), np.uint8)
    live = np.clip(vlen.astype(np.int64), 0, width)
    st = start.astype(np.int64)

    def span_byte(i, j):
        if j >= live[i]:
            return 0
        return values[i, min(max(st[i] + j, 0), width - 1)]

    for i in range(n):
        for j0 in range(0, width, SEG):
            if width % SEG:
                for j in range(j0, min(j0 + SEG, width)):
                    out[i, j] = span_byte(i, j)
                continue
            if j0 >= live[i]:
                continue  # sixteen zero bytes
            a = st[i] + j0
            if st[i] >= 0 and a + SEG <= width:
                row = np.concatenate([values[i], np.zeros(4, np.uint8)])
                base, sh = a & ~3, int(a & 3) * 8
                x = [int(row[base + 4 * k: base + 4 * k + 4].view("<u4")[0]) for k in range(5)]
                if not sh:
                    x[4] = 0
                keep = live[i] - j0
                for k in range(4):
                    word = ((x[k + 1] << 32 | x[k]) >> sh) & 0xFFFFFFFF
                    c = keep - 4 * k
                    word &= 0xFFFFFFFF if c >= 4 else (0 if c <= 0 else (1 << (8 * c)) - 1)
                    out[i, j0 + 4 * k: j0 + 4 * k + 4] = np.array([word], "<u4").view(np.uint8)
            else:
                for j in range(j0, j0 + SEG):
                    out[i, j] = span_byte(i, j)
    return out


def _spans(rng, n: int, width: int):
    """Random rows and spans: in-row spans (what a span kernel emits),
    spans that overrun the row, negative starts, lengths past the width and
    negative lengths."""
    values = rng.integers(0, 256, size=(n, width)).astype(np.uint8)
    start = rng.integers(0, width + 1, size=n)
    vlen = np.array([rng.integers(0, width - s + 1) for s in start])
    kind = rng.integers(0, 5, size=n)
    start = np.where(kind == 1, rng.integers(0, 2 * width + 2, size=n), start)  # overrun
    vlen = np.where(kind == 1, rng.integers(0, 2 * width + 2, size=n), vlen)
    start = np.where(kind == 2, -rng.integers(1, 2 * width + 2, size=n), start)  # start < 0
    vlen = np.where(kind == 3, rng.integers(width, 3 * width + 2, size=n), vlen)  # past W
    vlen = np.where(kind == 4, -rng.integers(0, 3, size=n), vlen)  # negative, none
    return values, start.astype(np.int32), vlen.astype(np.int32)


@pytest.mark.parametrize("width", [1, 3, 15, 16, 17, 63, 64, 65, 100, 1000])
def test_extract_plain_and_segment_model_match_jax(width):
    rng = np.random.default_rng(width)
    n = 300 if width < 1000 else 60
    values, start, vlen = _spans(rng, n, width)
    want = np.asarray(jax_kernels.extract_span(jnp.asarray(values), jnp.asarray(start),
                                               jnp.asarray(vlen)))
    cuda_kernels.reset_launches()
    port = cuda_kernels.extract_span(torch.from_numpy(values), torch.from_numpy(start),
                                     torch.from_numpy(vlen))
    assert cuda_kernels.LAUNCHES["extract"] == 0
    np.testing.assert_array_equal(port.numpy(), want)
    np.testing.assert_array_equal(segment_extract(values, start, vlen), want)


def test_long_key_plain_span_matches_jax():
    """A 49,151-byte key (a 49,153-byte needle, past 48 KB of shared memory):
    the plain span version gives the JAX package's answer, b'1'."""
    key = "a" * 49151
    docs = [b'{"' + key.encode() + b'":1}', b'{"' + key.encode() + b'b":2}', b'{"a":3}']
    width = len(docs[0])
    values = np.zeros((len(docs), width), np.uint8)
    lengths = np.array([min(len(d), width) for d in docs], np.int32)
    for i, d in enumerate(docs):
        values[i, : lengths[i]] = np.frombuffer(d[: lengths[i]], np.uint8)
    st, vl = cuda_kernels.json_get_span(torch.from_numpy(values), torch.from_numpy(lengths), key)
    rst, rvl = jax_kernels.json_get_span(jnp.asarray(values), jnp.asarray(lengths), key)
    np.testing.assert_array_equal(st.numpy(), np.asarray(rst))
    np.testing.assert_array_equal(vl.numpy(), np.asarray(rvl))
    assert bytes(values[0, st[0]: st[0] + vl[0]]) == b"1"
    assert vl[1] == 0 and vl[2] == 0
