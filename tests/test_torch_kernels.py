"""The port's kernel wrappers (plain torch versions, on CPU tensors)
against the JAX package's kernels on the CPU.

Each input goes through three functions: the port's wrapper in
``fluvio_tpu_torch.smartengine.gpu.cuda_kernels`` (which runs its plain
torch version for a CPU tensor), the JAX package's XLA kernel in
``kernels.py`` and its Pallas kernel in interpret mode, as the JAX
package's own tests run it. Outputs are integers and bytes, so the
tolerance is exact equality. Inputs are built with numpy from fixed seeds;
N <= 512 and W <= 64 keep interpret mode fast.

Two reference faults are pinned here rather than papered over:

- raw values trim only space/tab/CR/LF in both JAX span kernels, while
  ``dsl.json_get_bytes`` also trims ``\\x0b``/``\\x0c``; the port follows
  the kernels;
- the Pallas span kernel drops the byte that aborts a matched key's colon
  search, where the XLA kernel and the DSL rescan it; the port follows the
  XLA kernel.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fluvio_tpu.ops.regex_dfa import compile_regex as ref_compile_regex
from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
from tests.test_tpu_kernels import JSON_DOCS
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

W = 64
VT_CORNER = [b'{"n":123\x0b,"m":1}', b'{"n":12 \x0c}', b'{"n":\x0b7\x0c}']
COLON_ABORT = [b'{"n" {"n":5}}', b'{"n" "x":1, "n":2}', b'{"n" }"n":3}']


def _stage(docs, width=W):
    values = np.zeros((len(docs), width), dtype=np.uint8)
    lengths = np.zeros(len(docs), dtype=np.int32)
    for i, d in enumerate(docs):
        values[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    return values, lengths


def _edge_docs(width=W):
    """Records of length 0, W-1 and W (JSON and not)."""
    def fit(prefix: bytes, n: int) -> bytes:
        body = prefix + b"x" * max(n - len(prefix) - 2, 0) + b'"}'
        return body[:n]

    return [
        b"",
        fit(b'{"n":"', width - 1),
        fit(b'{"n":"', width),
        (b'{"n":' + b"1" * width)[: width],
        (b'{"a":1,"n":' + b"7" * width)[: width - 1],
    ]


def _garbage(rng, count, width, tokens):
    docs = []
    for _ in range(count):
        target = int(rng.integers(0, width + 1))
        d = b""
        while len(d) < target:
            d += tokens[int(rng.integers(len(tokens)))]
        docs.append(d[:target])
    return docs


_TOKENS = [b"{", b"}", b"[", b"]", b'"', b",", b":", b"\\", b" ", b"\t", b"\x0b",
           b"1", b"a", b"x", b"n"]
# every needle token carries its colon, so the Pallas kernel's colon-abort
# corner cannot arise (`test_pallas_colon_abort_fault` pins that corner)
_TOKENS_NO_ABORT = _TOKENS[:-1] + [b'"n":', b'{"n":', b'"q":']
_TOKENS_ANY = _TOKENS + [b'"n"', b'"n":', b'{"n":']


def _port_span(values, lengths, key):
    st, ln = cuda_kernels.json_get_span(torch.from_numpy(values), torch.from_numpy(lengths), key)
    assert st.dtype == torch.int32 and ln.dtype == torch.int32
    return st.numpy(), ln.numpy()


def _xla_span(values, lengths, key):
    st, ln = jax_kernels.json_get_span(values, lengths, key)
    return np.asarray(st), np.asarray(ln)


def _pallas_span(values, lengths, key):
    st, ln = pallas_kernels.json_get_span_pallas(values, lengths, key, interpret=True)
    return np.asarray(st), np.asarray(ln)


def _field(doc, st, ln):
    return doc[int(st) : int(st) + int(ln)]


class TestJsonSpan:
    @pytest.mark.parametrize("key", ["name", "n", "q", ""])
    def test_docs_match_both_jax_kernels(self, key):
        docs = list(JSON_DOCS) + VT_CORNER + _edge_docs()
        values, lengths = _stage(docs)
        port = _port_span(values, lengths, key)
        np.testing.assert_array_equal(port[0], _xla_span(values, lengths, key)[0])
        np.testing.assert_array_equal(port[1], _xla_span(values, lengths, key)[1])
        pallas = _pallas_span(values, lengths, key)
        np.testing.assert_array_equal(port[0], pallas[0])
        np.testing.assert_array_equal(port[1], pallas[1])

    def test_garbage_matches_xla(self):
        rng = np.random.default_rng(20261016)
        docs = _garbage(rng, 512, W, _TOKENS_ANY)
        values, lengths = _stage(docs)
        for key in ("n", "a"):
            port = _port_span(values, lengths, key)
            xla = _xla_span(values, lengths, key)
            np.testing.assert_array_equal(port[0], xla[0])
            np.testing.assert_array_equal(port[1], xla[1])

    def test_garbage_matches_pallas(self):
        rng = np.random.default_rng(7)
        docs = _garbage(rng, 512, W, _TOKENS_NO_ABORT)
        values, lengths = _stage(docs)
        for key in ("n", "q"):
            port = _port_span(values, lengths, key)
            pallas = _pallas_span(values, lengths, key)
            np.testing.assert_array_equal(port[0], pallas[0])
            np.testing.assert_array_equal(port[1], pallas[1])

    def test_vt_ff_trim_follows_the_kernels(self):
        """Raw values keep a trailing \\x0b / \\x0c (both JAX kernels);
        ``json_get_bytes`` strips them."""
        values, lengths = _stage(VT_CORNER)
        port = _port_span(values, lengths, "n")
        got = [_field(d, port[0][i], port[1][i]) for i, d in enumerate(VT_CORNER)]
        assert got == [b"123\x0b", b"12 \x0c", b"\x0b7\x0c"]
        for kernel in (_xla_span, _pallas_span):
            ref = kernel(values, lengths, "n")
            assert [_field(d, ref[0][i], ref[1][i]) for i, d in enumerate(VT_CORNER)] == got
        assert [ref_dsl.json_get_bytes(d, "n") for d in VT_CORNER] == [b"123", b"12", b"7"]

    def test_pallas_colon_abort_fault(self):
        """A matched key followed by neither ':' nor whitespace: the XLA
        kernel and the DSL rescan that byte, the Pallas kernel drops it.
        The port follows the XLA kernel and the DSL."""
        values, lengths = _stage(COLON_ABORT)
        port = _port_span(values, lengths, "n")
        xla = _xla_span(values, lengths, "n")
        pallas = _pallas_span(values, lengths, "n")
        port_f = [_field(d, port[0][i], port[1][i]) for i, d in enumerate(COLON_ABORT)]
        assert port_f == [_field(d, xla[0][i], xla[1][i]) for i, d in enumerate(COLON_ABORT)]
        assert port_f == [ref_dsl.json_get_bytes(d, "n") for d in COLON_ABORT]
        assert port_f == [b"", b"2", b""]
        pallas_f = [_field(d, pallas[0][i], pallas[1][i]) for i, d in enumerate(COLON_ABORT)]
        assert pallas_f == [b"5", b"", b"3"]


def _port_extract(values, start, vlen):
    out = cuda_kernels.extract_span(
        torch.from_numpy(values), torch.from_numpy(start), torch.from_numpy(vlen)
    )
    assert out.dtype == torch.uint8
    return out.numpy()


class TestExtract:
    def test_json_spans_match_both_jax_kernels(self):
        docs = list(JSON_DOCS) + VT_CORNER + _edge_docs()
        values, lengths = _stage(docs)
        st, ln = _xla_span(values, lengths, "name")
        st, ln = st.astype(np.int32), ln.astype(np.int32)
        port = _port_extract(values, st, ln)
        np.testing.assert_array_equal(port, np.asarray(jax_kernels.extract_span(values, st, ln)))
        np.testing.assert_array_equal(
            port, np.asarray(pallas_kernels.extract_pallas(values, st, ln, interpret=True))
        )

    def test_random_spans(self):
        rng = np.random.default_rng(5)
        n = 512
        values = rng.integers(0, 256, size=(n, W), dtype=np.uint8)
        start = rng.integers(0, W + 1, size=n).astype(np.int32)
        vlen = np.minimum(rng.integers(0, W + 1, size=n), W - start).astype(np.int32)
        port = _port_extract(values, start, vlen)
        np.testing.assert_array_equal(
            port, np.asarray(jax_kernels.extract_span(values, start, vlen))
        )
        np.testing.assert_array_equal(
            port, np.asarray(pallas_kernels.extract_pallas(values, start, vlen, interpret=True))
        )

    def test_overrunning_spans_clip_like_xla(self):
        """Spans past the row end read the last byte (the gather form);
        no span kernel emits them, so only the XLA form is the reference."""
        rng = np.random.default_rng(6)
        n = 256
        values = rng.integers(0, 256, size=(n, W), dtype=np.uint8)
        start = rng.integers(-3, W + 8, size=n).astype(np.int32)
        vlen = rng.integers(0, W + 1, size=n).astype(np.int32)
        np.testing.assert_array_equal(
            _port_extract(values, start, vlen),
            np.asarray(jax_kernels.extract_span(values, start, vlen)),
        )


NAMES = [b"fluvio", b"fluVio", b"kafka", b"pulsar", b"fluvio-tpu", b"redpanda", b"flink"]
PATTERNS = ["flu[vV]io", "^fluvio$", "^(fluvio|kafka|pulsar)-[0-3]$"]


def _dfa_inputs(rng, n=512, width=W):
    docs = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            docs.append(NAMES[int(rng.integers(len(NAMES)))] + b"-%d" % int(rng.integers(0, 6)))
        elif kind == 1:
            docs.append(rng.integers(97, 123, size=int(rng.integers(0, width + 1))).astype(np.uint8).tobytes())
        elif kind == 2:
            docs.append(b'{"name":"' + NAMES[int(rng.integers(len(NAMES)))] + b'-1"}')
        else:
            docs.append(NAMES[int(rng.integers(len(NAMES)))])
    docs[:4] = [b"", b"f" * (width - 1), b"fluvio" + b"x" * (width - 6), b"x" * (width - 6) + b"fluvio"]
    return _stage(docs, width)


def _ref_dfas():
    dfas = [(p, ref_compile_regex(p)) for p in PATTERNS]
    dfas.append(("flu[vV]io unpacked", ref_compile_regex("flu[vV]io", packed=False)))
    return dfas


class TestDfa:
    @pytest.mark.parametrize("case", range(4), ids=[d[0] for d in _ref_dfas()])
    def test_matches_both_jax_kernels(self, case):
        name, ref = _ref_dfas()[case]
        if name.startswith("^(fluvio"):
            assert ref.n_states == 22
        dfa = interop.dfa_from_reference(
            ref.table, ref.byte_class, ref.accept, ref.start, ref.eos_class, ref.pad_class
        )
        values, lengths = _dfa_inputs(np.random.default_rng(31 + case))
        port = cuda_kernels.dfa_match(torch.from_numpy(values), torch.from_numpy(lengths), dfa)
        assert port.dtype == torch.bool
        port = port.numpy()
        np.testing.assert_array_equal(
            port, np.asarray(jax_kernels.dfa_match(values, lengths, ref))
        )
        np.testing.assert_array_equal(port, ref.match_numpy(values, lengths))
        if pallas_kernels.dfa_supported(ref):
            np.testing.assert_array_equal(
                port,
                np.asarray(pallas_kernels.dfa_match_pallas(values, lengths, ref, interpret=True)),
            )
        else:
            # the Mosaic select-chain bound the CUDA kernel does not have
            assert name.endswith("unpacked")

    def test_padded_rows_read_pad(self):
        """Length -1 (padded rows) scans PAD throughout, so a row that
        would match as the empty record does not."""
        ref = ref_compile_regex("^x*$")
        dfa = interop.dfa_from_reference(
            ref.table, ref.byte_class, ref.accept, ref.start, ref.eos_class, ref.pad_class
        )
        values, lengths = _stage([b"", b"xx", b"", b"xy"], 32)
        lengths[2] = -1
        port = cuda_kernels.dfa_match(torch.from_numpy(values), torch.from_numpy(lengths), dfa)
        np.testing.assert_array_equal(
            port.numpy(), np.asarray(jax_kernels.dfa_match(values, lengths, ref))
        )
        assert port.numpy().tolist() == [True, True, False, False]

    @pytest.mark.parametrize("packed", [True, False])
    def test_257_state_table(self, packed):
        """The largest DFA the compiler emits (state ids up to 256: the
        CUDA kernel's two-byte table; unpacked it is 257 x 258 entries)."""
        ref = ref_compile_regex("(a|b)*a(a|b){6}c|x" + "d" * 125, packed=packed)
        assert ref.n_states == 257
        dfa = interop.dfa_from_reference(
            ref.table, ref.byte_class, ref.accept, ref.start, ref.eos_class, ref.pad_class
        )
        rng = np.random.default_rng(257)
        alphabet = np.frombuffer(b"abcxd", dtype=np.uint8)
        docs = [alphabet[rng.integers(0, 5, size=int(rng.integers(0, W + 1)))].tobytes()
                for _ in range(256)]
        for i in range(0, 256, 4):  # plant a match: a(a|b){6}c
            docs[i] = (docs[i][:40] + b"a" + alphabet[rng.integers(0, 2, size=6)].tobytes() + b"c")
        values, lengths = _stage(docs)
        port = cuda_kernels.dfa_match(torch.from_numpy(values), torch.from_numpy(lengths), dfa)
        want = np.asarray(jax_kernels.dfa_match(values, lengths, ref))
        np.testing.assert_array_equal(port.numpy(), want)
        np.testing.assert_array_equal(port.numpy(), ref.match_numpy(values, lengths))
        assert 0 < want.sum() < len(docs)
