"""CPU spec of the redesigned DFA scan kernel (``csrc/dfa_scan.cu``).

A numpy model of the kernel's walk — the folded table, chunked reads up to
each record's length, the verdict read from ``eos_accept`` / ``accept``
without walking the EOS/PAD tail, and the tail walk for a table whose PAD
column changes acceptance — held, with the port's plain
``kernels.dfa_match``, against the reference
compiler's ``match_numpy`` at every width, and the JAX package's
``kernels.dfa_match`` and its Pallas kernel in interpret mode (wherever
``dfa_supported`` holds) at width 64.
Verdicts are booleans: the tolerance is bit equality.

The cases (patterns, hand-built tables, edge lengths, widths) are
``tests/test_torch_isolation.py``'s, which also holds them against the
kernel on the card. The model reads the chunk size from the source, so a
changed constant is tested as it is.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluvio_tpu.ops import regex_dfa as ref_regex_dfa
from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa, compile_regex_cached
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
from tests.test_torch_isolation import (
    DFA_SCAN_PATTERNS,
    DFA_SCAN_WIDTHS,
    dfa_scan_inputs,
    non_invariant_tables,
)
from tests.test_torch_regex_dfa import PATTERNS

SOURCE = (Path(__file__).resolve().parent.parent
          / "fluvio_tpu_torch/smartengine/gpu/csrc/dfa_scan.cu").read_text(encoding="utf-8")
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", SOURCE).group(1))
# the width at which the JAX package's XLA and Pallas kernels join the
# check (each call compiles anew); `match_numpy`, the reference compiler's
# own matcher, checks every width
JAX_WIDTH = 64


def model_scan(values, lengths, dfa: CompiledDfa, aligned=None):
    """The kernel's walk in numpy: the verdicts. A row walks min(length, W)
    bytes through the folded table, a chunk at a time. Rows that are not
    16-byte aligned (``aligned`` False; None reads the address as the
    launcher does) read the chunk byte by byte and see zeros past the walk,
    which no step reads."""
    t = cuda_kernels.scan_tables(dfa)
    n, width = values.shape
    if aligned is None:
        aligned = width % CHUNK == 0 and values.ctypes.data % 16 == 0
    lengths = lengths.astype(np.int64)
    walk = np.clip(lengths, 0, width)
    state = np.full(n, dfa.start, dtype=np.int64)
    for j0 in range(0, width, CHUNK):
        live = walk > j0
        if not live.any():
            break
        chunk = values[:, j0: j0 + CHUNK].astype(np.int64)
        if not aligned:
            chunk = np.where(j0 + np.arange(chunk.shape[1]) < walk[:, None], chunk, 0)
        for k in range(chunk.shape[1]):
            step = live & (j0 + k < walk)
            state = np.where(step, t.fold[state, chunk[:, k]], state)
    accept = (t.flags & cuda_kernels.SCAN_ACCEPT) != 0
    if t.pad_invariant:
        eos_accept = (t.flags & cuda_kernels.SCAN_EOS_ACCEPT) != 0
        outside = (lengths < 0) | (lengths > width)
        return np.where(outside, accept[state], eos_accept[state])
    # the tail walk: EOS at the length, PAD after it and as the trailing symbol
    inside = (lengths >= 0) & (lengths <= width)
    state = np.where(inside, t.eos_next[state], state)
    pads = np.where(lengths < 0, width + 1, np.where(inside, width - lengths, 1))
    for k in range(width + 1):
        state = np.where(k < pads, t.pad_next[state], state)
    return accept[state]


@functools.lru_cache(maxsize=None)
def _reference(pattern: str, packed: bool):
    return ref_regex_dfa.compile_regex(pattern, packed=packed)


def _ref_of(kw) -> ref_regex_dfa.CompiledDfa:
    return ref_regex_dfa.CompiledDfa(
        table=kw["table"], byte_class=kw["byte_class"], eos_class=kw["eos_class"],
        pad_class=kw["pad_class"], accept=kw["accept"], start=kw["start"])


def _cases():
    cases = [(f"{p[:24]} packed={packed}", lambda p=p, packed=packed: _reference(p, packed))
             for p, packed in DFA_SCAN_PATTERNS]
    cases += [(t["pattern"], lambda i=i: _ref_of(non_invariant_tables()[i]))
              for i, t in enumerate(non_invariant_tables())]
    return cases


CASES = _cases()


@pytest.mark.parametrize("width", DFA_SCAN_WIDTHS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_model_and_plain_match_the_jax_kernels(case, width):
    ref = CASES[case][1]()
    dfa = interop.dfa_from_reference(
        ref.table, ref.byte_class, ref.accept, ref.start, ref.eos_class, ref.pad_class)
    values, lengths = dfa_scan_inputs(np.random.default_rng(100 * case + width), width)
    want = ref.match_numpy(values, lengths)
    if width == JAX_WIDTH:
        np.testing.assert_array_equal(np.asarray(jax_kernels.dfa_match(values, lengths, ref)),
                                      want)
    if width == JAX_WIDTH and pallas_kernels.dfa_supported(ref):
        np.testing.assert_array_equal(
            np.asarray(pallas_kernels.dfa_match_pallas(values, lengths, ref, interpret=True)),
            want)
    plain = cuda_kernels.dfa_match(torch.from_numpy(values), torch.from_numpy(lengths), dfa)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(model_scan(values, lengths, dfa), want)
    # the same rows one byte into a buffer: not 16-byte aligned
    buf = np.zeros(values.size + 1, dtype=np.uint8)
    buf[1:] = values.reshape(-1)
    off = buf[1:].reshape(values.shape)
    np.testing.assert_array_equal(model_scan(off, lengths, dfa, aligned=False), want)
    off_t = torch.from_numpy(buf)[1:].view(values.shape)
    np.testing.assert_array_equal(
        cuda_kernels.dfa_match(off_t, torch.from_numpy(lengths), dfa).numpy(), want)
    if width == JAX_WIDTH:
        assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("pattern", [p for p, _ in DFA_SCAN_PATTERNS[::2]] + ["(a|b)*a(a|b){2}c"])
def test_folded_table_is_table_at_byte_class(pattern, packed):
    """fold[s, b] == table[s, byte_class[b]]; the image the kernel copies
    holds it column-major as byte offsets."""
    dfa = compile_regex_cached(pattern, packed=packed)
    t = cuda_kernels.scan_tables(dfa)
    np.testing.assert_array_equal(t.fold, dfa.table[:, dfa.byte_class])
    blob, args = cuda_kernels._scan_image(dfa)
    size, entry, tail, stride, flags_off, _ = args
    assert size == blob.size and size % 16 == 0 and not tail
    assert stride >= dfa.n_states * entry and (stride // 4) % 32 == 13
    ids = np.dtype("<u1") if entry == 1 else np.dtype("<u2")
    nxt = blob[: 256 * stride].view(ids).reshape(256, stride // entry)[:, : dfa.n_states]
    np.testing.assert_array_equal(nxt.T, t.fold * entry)
    np.testing.assert_array_equal(blob[flags_off: flags_off + dfa.n_states], t.flags)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compiled_tables_pass_the_pad_check(pattern):
    """Every compiled table, packed and unpacked, keeps acceptance under
    PAD, so the kernel decides from the state after the live bytes."""
    for packed in (True, False):
        dfa = compile_regex_cached(pattern, packed=packed)
        t = cuda_kernels.scan_tables(dfa)
        assert t.pad_invariant, (pattern, packed)
        np.testing.assert_array_equal(
            (t.flags & cuda_kernels.SCAN_EOS_ACCEPT) != 0, dfa.accept[dfa.table[:, dfa.eos_class]])
        assert (t.fold[dfa.n_states - 1] == dfa.n_states - 1).all()  # the dead sink


@pytest.mark.parametrize("which", range(len(non_invariant_tables())))
def test_hand_built_table_needs_the_tail_walk(which):
    """A table whose PAD column changes acceptance fails the check and
    takes the tail walk; reading the verdict without the tail would be
    wrong on these rows."""
    kw = non_invariant_tables()[which]
    dfa = CompiledDfa(**kw)
    t = cuda_kernels.scan_tables(dfa)
    assert not t.pad_invariant
    assert cuda_kernels._scan_image(dfa)[1][2] == 1
    values, lengths = dfa_scan_inputs(np.random.default_rng(9), 64)
    want = np.asarray(jax_kernels.dfa_match(values, lengths, _ref_of(kw)))
    np.testing.assert_array_equal(model_scan(values, lengths, dfa), want)
    np.testing.assert_array_equal(_ref_of(kw).match_numpy(values, lengths), want)
    np.testing.assert_array_equal(
        cuda_kernels.dfa_match(torch.from_numpy(values), torch.from_numpy(lengths), dfa).numpy(),
        want)
    # the verdict read without the tail, as for a table that passes
    eos_accept = (t.flags & cuda_kernels.SCAN_EOS_ACCEPT) != 0
    accept = (t.flags & cuda_kernels.SCAN_ACCEPT) != 0
    walk = np.clip(lengths, 0, 64)
    state = np.full(len(lengths), dfa.start)
    for j in range(64):
        state = np.where(j < walk, t.fold[state, values[:, j]], state)
    outside = (lengths < 0) | (lengths > 64)
    assert (np.where(outside, accept[state], eos_accept[state]) != want).any()


def test_unsupported_tables_raise():
    kw = non_invariant_tables()[0]
    for change in ("state", "class", "start", "size"):
        bad = dict(kw, table=kw["table"].copy(), byte_class=kw["byte_class"].copy())
        if change == "state":
            bad["table"][1, 2] = 4
        elif change == "class":
            bad["byte_class"][7] = 6
        elif change == "start":
            bad["start"] = 4
        else:
            bad["table"] = np.zeros((258, 6), dtype=np.int16)
            bad["accept"] = np.zeros(258, dtype=bool)
        with pytest.raises(ValueError):
            cuda_kernels.scan_tables(CompiledDfa(**bad))
