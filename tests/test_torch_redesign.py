"""The redesigned kernels' executable specs against the JAX package, on the
CPU: the column split of ``csrc/dfa_compose.cu`` (TPU kernel #6) and the
token-to-byte rounds of ``csrc/glz_decode.cu`` (TPU kernel #3).

- `kernels.dfa_compose_columns_split` (segments composed, then folded in
  column order) against the plain serial walk, the JAX package's XLA
  kernel and its Pallas kernel in interpret mode;
- `glz.decompress_rounds_numpy` (literal pass, then ``depth`` in-place
  rounds over the sequences in a shuffled order) against the raw bytes and
  the JAX package's ``decompress_device``;
- the ``glz_decode`` wrapper on CPU tensors against the JAX package's byte
  plan and Pallas resolve (interpret mode), with no launch counted.

Inputs are made with numpy from fixed seeds; every output is an integer or a
byte, so every check is exact (tolerance 0). The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_isolation.py`` (marker ``cuda``) and ``chip_smoke.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.ops.regex_dfa import compile_regex as ref_compile_regex
from fluvio_tpu.smartengine.tpu import glz as ref_glz
from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
from fluvio_tpu_torch.smartengine.gpu.executor import pad_glz_tokens


@pytest.fixture(autouse=True)
def _dfa_pallas_flags_restored():
    """A call of the JAX package's Pallas DFA compose sets its process-wide
    engagement flag, and an engaged flag routes any later dispatch
    failure in that process into the compose kernel's demotion; leave the
    flags as the test found them."""
    saved = (pallas_kernels._dfa_pallas_off, pallas_kernels._dfa_pallas_engaged)
    yield
    pallas_kernels._dfa_pallas_off, pallas_kernels._dfa_pallas_engaged = saved

BENCH_REGEX = "^(fluvio|kafka|pulsar)-[0-3]$"
BIG_REGEX = "(a|b)*a(a|b){6}c|x" + "d" * 125  # 257 states: two-byte table entries


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _table_t(ref) -> np.ndarray:
    return np.ascontiguousarray(ref.table.T.astype(np.int32))


def _classes(rng, rows: int, t_len: int, n_classes: int) -> np.ndarray:
    """Random classes with identity runs, an all-identity row and, in every
    row past the third, an all-identity 32-column segment."""
    cls = rng.integers(0, n_classes, size=(rows, t_len)).astype(np.int32)
    for i in range(rows):
        a = int(rng.integers(0, t_len))
        cls[i, a: a + int(rng.integers(0, t_len // 2 + 1))] = -1
    cls[0] = -1
    if t_len > 64:
        cls[3:, 32:64] = -1
    return cls


T_LEN = 77  # not a multiple of 32 or 64


@functools.lru_cache(maxsize=None)
def _split_case(pattern: str, packed: bool):
    """(classes, table_t, XLA result, Pallas result) of one table, shared
    by the segment lengths (the references do not depend on them)."""
    ref = ref_compile_regex(pattern, packed=packed)
    table_t = _table_t(ref)
    cls = _classes(np.random.default_rng(ref.n_states + T_LEN), 9, T_LEN, ref.n_classes)
    xla = jax_kernels.dfa_compose_columns(jnp.asarray(cls), jnp.asarray(table_t), ref.n_states)
    pallas = pallas_kernels.dfa_compose_columns_pallas(
        jnp.asarray(cls), jnp.asarray(table_t), ref.n_states, interpret=True)
    return cls, table_t, np.asarray(xla), np.asarray(pallas)


@pytest.mark.parametrize("seg_len", [32, 64, T_LEN, T_LEN + 17], ids=["32", "64", "T", "past-T"])
@pytest.mark.parametrize(
    "pattern,packed",
    [(BENCH_REGEX, True), ("flu[vV]io", True), ("flu[vV]io", False), ("(a|b)*a(a|b){2}c", True),
     ("x" + "d" * 40, True), (BIG_REGEX, True), (BIG_REGEX, False)],
    ids=["22-state", "fluvio", "fluvio-unpacked", "11-state", "43-state", "257-packed",
         "257-unpacked"],
)
def test_dfa_split_matches_serial_xla_and_pallas(pattern, packed, seg_len):
    """The split mirror at segment lengths 32, 64, T and past T equals the
    serial walk, the XLA kernel and the Pallas kernel bit for bit."""
    cls, table_t, xla, pallas = _split_case(pattern, packed)
    got = kernels.dfa_compose_columns_split(_t(cls), _t(table_t), seg_len)
    assert got.dtype == torch.int32 and got.shape == (9, table_t.shape[1])
    plain = kernels.dfa_compose_columns(_t(cls), _t(table_t))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # the wrapper on CPU tensors runs the serial walk and counts nothing
    cuda_kernels.reset_launches()
    np.testing.assert_array_equal(
        cuda_kernels.dfa_compose_columns(_t(cls), _t(table_t)).numpy(), plain.numpy())
    assert cuda_kernels.LAUNCHES["dfa_compose"] == 0


@pytest.mark.parametrize("t_len,seg_len", [(300, 32), (300, 64), (100, 96)])
def test_dfa_split_fold_order_matters(t_len, seg_len):
    """Segments that do not commute: folding them in reverse order gives
    another answer, so the mirror's equality pins the column order."""
    ref = ref_compile_regex("flu[vV]io", packed=True)
    table_t = _table_t(ref)
    cls = _classes(np.random.default_rng(t_len + seg_len), 24, t_len, ref.n_classes)
    got = kernels.dfa_compose_columns_split(_t(cls), _t(table_t), seg_len)
    np.testing.assert_array_equal(got.numpy(), kernels.dfa_compose_columns(
        _t(cls), _t(table_t)).numpy())
    n_segs = -(-t_len // seg_len)
    padded = np.full((24, n_segs * seg_len), -1, np.int32)
    padded[:, :t_len] = cls
    seg = kernels.dfa_compose_columns(_t(padded.reshape(24 * n_segs, seg_len)), _t(table_t))
    seg = seg.view(24, n_segs, ref.n_states)
    wrong = torch.arange(ref.n_states, dtype=torch.int32).expand(24, ref.n_states)
    for p in reversed(range(n_segs)):
        wrong = kernels.dfa_compose(wrong, seg[:, p])
    assert not torch.equal(wrong, got)


def _json(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    names = ["fluvio", "kafka", "pulsar", "fluvio-tpu", "redpanda", "flink"]
    vals = [
        f'{{"name":"{names[rng.integers(0, 6)]}-{i & 255}","n":{rng.integers(0, 100000)}}}'.encode()
        for i in range(n)
    ]
    return np.frombuffer(b"".join(vals), dtype=np.uint8).copy()


def _padded(comp: glz.Compressed) -> glz.Compressed:
    ll, ml, srcs, lits = pad_glz_tokens(comp)
    return comp._replace(lit_lens=ll, match_lens=ml, srcs=srcs, lits=lits)


# (name, raw bytes, chunk): the depth-6 corpus, ragged last chunks, 4 and
# 64 KiB chunks
ROUND_CASES = {
    "depth6-64k": (lambda: _json(1400, 7), 64 * 1024),
    "depth6-4k": (lambda: _json(1400, 7), 4096),
    "ragged-4k": (lambda: _json(500, 3)[: 5 * 4096 + 1234], 4096),
    "zeros-4k": (lambda: np.zeros(3 * 4096 + 100, np.uint8), 4096),
}


@pytest.mark.parametrize("tokens", ["bare", "padded"])
@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_glz_rounds_match_raw_and_reference(case, tokens):
    make, chunk = ROUND_CASES[case]
    raw = make()
    comp, reason = glz.compress_link(raw, max_ratio=1.0, chunk=chunk)
    assert comp is not None, reason
    assert raw.size % chunk, "every case ends in a ragged chunk"
    if case.startswith("depth6"):
        assert comp.depth == glz.MAX_DEPTH
    if tokens == "padded":
        comp = _padded(comp)
    order_seed = sorted(ROUND_CASES).index(case) * 2 + (tokens == "padded")
    np.testing.assert_array_equal(glz.decompress_rounds_numpy(comp, order_seed), raw)
    ref = jax.jit(lambda *a: ref_glz.decompress_device(*a, comp.out_len))(
        *map(jnp.asarray, comp[:4]), jnp.int32(comp.depth))
    np.testing.assert_array_equal(np.asarray(ref), raw)


def test_glz_rounds_need_every_round():
    """With one round fewer than the stream's depth the rounds come up
    short on the depth-6 corpus: the depth the host passes is load-bearing."""
    raw = _json(1400, 7)
    comp, _ = glz.compress_link(raw, max_ratio=1.0, chunk=64 * 1024)
    assert comp.depth == glz.MAX_DEPTH
    short = glz.decompress_rounds_numpy(comp._replace(depth=comp.depth - 1), 0)
    assert not np.array_equal(short, raw)


@pytest.mark.parametrize("tokens", ["bare", "padded"])
@pytest.mark.parametrize("chunk", [4096, 16384])
def test_glz_decode_wrapper_matches_reference_on_cpu(chunk, tokens):
    """``cuda_kernels.glz_decode`` on CPU tensors (its plain version, the
    byte plan plus the resolve) equals the JAX package's byte plan and
    Pallas resolve in interpret mode, and counts no launch."""
    raw = _json(900, chunk)
    comp, _ = glz.compress_link(raw, max_ratio=1.0, chunk=chunk)
    ll, ml, srcs, lits = pad_glz_tokens(comp) if tokens == "padded" else comp[:4]
    cuda_kernels.reset_launches()
    got = cuda_kernels.glz_decode(_t(ll), _t(ml), _t(srcs), _t(lits), comp.out_len, chunk,
                                  comp.depth)
    assert dict(cuda_kernels.LAUNCHES) == {k: 0 for k in cuda_kernels.LAUNCHES}
    base, midx = jax.jit(lambda *a: ref_glz.byte_plan_device(*a, comp.out_len))(
        *map(jnp.asarray, (ll, ml, srcs, lits)))
    want = pallas_kernels.glz_decode_pallas(base, midx, chunk, interpret=True)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), raw)
    link = glz.decode_link_flat((_t(ll), _t(ml), _t(srcs)), _t(lits), comp.out_len, chunk,
                                comp.depth)
    np.testing.assert_array_equal(link.numpy(), raw)


def test_glz_decode_wrapper_checks_its_arguments():
    comp, _ = glz.compress_link(_json(300, 1), max_ratio=1.0, chunk=4096)
    args = tuple(map(_t, comp[:4]))
    for chunk, depth in ((100, comp.depth), (4096, 0), (4096, 9)):
        with pytest.raises(ValueError):
            cuda_kernels.glz_decode(*args, comp.out_len, chunk, depth)
