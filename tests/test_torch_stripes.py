"""The port's striped wide-record layout (``gpu/stripes.py``) against the
JAX package's (``fluvio_tpu/smartengine/tpu/stripes.py``), on the CPU.

Both sides use small stripes — 64 bytes overlapping by 16 (a 48-byte
step), above a 64-byte threshold: the JAX side through the
``FLUVIO_STRIPE_*`` variables, set before its chain is built, the port
through ``StripeParams(64, 64, 16)``. Records of a few hundred bytes then
span several stripes, and literals, JSON keys, colons and values land on
the stripe joints. Inputs are made with numpy from fixed seeds; every
output is an integer, a flag or bytes, so every comparison is exact
(tolerance 0). The port's kernel wrappers run their plain torch versions
here, since the tensors lie on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.ops.regex_dfa import compile_regex as ref_compile_regex
from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu.smartengine.tpu import stripes as ref_stripes
from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
from fluvio_tpu.protocol.record import Record
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.smartengine import GpuSpill, SmartEngine, SmartModuleConfig, StripeParams
from fluvio_tpu_torch.smartengine.gpu import buffer as port_buffer
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, stripes
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from tests.test_torch_chain import _assert_equal, _module_pair, _port_buffer, _ref_buffer
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_tpu_kernels import JSON_DOCS

S, V, THRESHOLD = 64, 16, 64
PARAMS = StripeParams(threshold=THRESHOLD, width=S, overlap=V)
BENCH_REGEX = "^(fluvio|kafka|pulsar)-[0-3]$"


@pytest.fixture
def small_stripes(monkeypatch):
    monkeypatch.setenv("FLUVIO_STRIPE_THRESHOLD", str(THRESHOLD))
    monkeypatch.setenv("FLUVIO_STRIPE_WIDTH", str(S))
    monkeypatch.setenv("FLUVIO_STRIPE_OVERLAP", str(V))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _json_corpus(seed: int = 11):
    """JSON_DOCS behind a pad field of 0..95 bytes, so the "name" key, its
    colon and its value sit at every offset around the 48-byte step."""
    rng = np.random.default_rng(seed)
    names = [b"fluvio-1", b"kafka-3", b"pulsar-7", b"fluVio-2", b"redpanda"]
    docs = []
    for m in range(0, 96, 3):
        doc = JSON_DOCS[m % len(JSON_DOCS)]
        body = doc[1:] if doc.startswith(b"{") else b'"x":"' + doc + b'"}'
        docs.append(b'{"pad":"' + b"p" * m + b'",' + (body if body != b"}" else b'"z":1}'))
    for i in range(40):
        name = names[int(rng.integers(len(names)))]
        pad = b"q" * int(rng.integers(0, 200))
        docs.append(b'{"pad":"' + pad + b'","name":"' + name + b'","n":%d}' % i)
    docs.append(b'{"name":"' + b"fluvio" * 30 + b'"}')  # a value across several stripes
    docs.append(b'{"name":' + b"7" * 150)  # raw value to the record's end
    return docs


def _batch(docs):
    """(flat i32 words, lengths i32, count, buffer) for the port and numpy."""
    buf = RecordBuffer.from_values(docs)
    flat, _ = buf.ragged_values()
    return np.ascontiguousarray(flat).view(np.int32), buf.lengths.copy(), buf.count, buf


def _plans(lengths, count, s=S, v=V):
    r = port_buffer._next_pow2(stripes.plan_rows(lengths, count, s, v), 8)
    n = len(lengths)
    live = np.arange(n) < count
    ref = ref_stripes.plan_device(jnp.asarray(lengths), jnp.asarray(live), r, s, v)
    port = stripes.plan_device(torch.from_numpy(lengths), torch.from_numpy(live), r, s, v)
    return ref, port


def _striped(docs):
    flat, lengths, count, _ = _batch(docs)
    ref_plan, port_plan = _plans(lengths, count)
    ref_sv = ref_stripes.striped_repad_words(jnp.asarray(flat), jnp.asarray(lengths), ref_plan, S)
    port_sv = stripes.striped_repad_words(
        torch.from_numpy(flat), torch.from_numpy(lengths), port_plan, S
    )
    kmax = int(stripes.stripe_counts(lengths[:count], S, V).max())
    return lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), kmax


class TestLayout:
    def test_plan_and_repad_match(self):
        rng = np.random.default_rng(3)
        docs = [rng.integers(0, 256, size=int(n)).astype(np.uint8).tobytes()
                for n in rng.integers(0, 400, size=45)]
        docs += [b"", b"a" * V, b"b" * (V + 1), b"c" * S, b"d" * (S + 1), b"e" * (2 * S)]
        lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), _ = _striped(docs)
        for key in ("seg", "stripe_idx", "abs_start", "stripe_len", "row_live", "is_last",
                    "first_row", "k"):
            np.testing.assert_array_equal(_np(port_plan[key]), _np(ref_plan[key]), err_msg=key)
        for key in ("step", "s", "v"):
            assert port_plan[key] == ref_plan[key]
        np.testing.assert_array_equal(port_sv.numpy(), np.asarray(ref_sv))
        np.testing.assert_array_equal(
            stripes.owned_lengths(port_plan).numpy(), np.asarray(ref_stripes.owned_lengths(ref_plan))
        )

    def test_params_validate_like_the_reference(self):
        for bad in ((64, 64, 64), (64, 62, 16), (64, 64, 18), (0, 64, 16), (1 << 17, 64, 16)):
            with pytest.raises(ValueError):
                StripeParams(*bad)
        assert StripeParams() == StripeParams(65536, 8192, 128)

    def test_both_packages_refuse_a_record_past_1_mib(self):
        big = b"x" * ((1 << 20) + 1)
        with pytest.raises(ValueError):
            RecordBuffer.from_values([b"a", big])
        with pytest.raises(ValueError):
            RefBuffer.from_records([Record(value=b"a"), Record(value=big)])
        assert RecordBuffer.from_values([b"y" * (1 << 20)]).width == port_buffer.MAX_RECORD_WIDTH


def _compose_inputs(rng, rows, t_len, n_classes):
    cls = rng.integers(0, n_classes, size=(rows, t_len)).astype(np.int32)
    for i in range(rows):  # identity runs of random length and place
        a = int(rng.integers(0, t_len))
        cls[i, a : a + int(rng.integers(0, t_len))] = -1
    cls[0, :] = -1
    cls[1, : t_len // 2] = -1
    return cls


@pytest.mark.parametrize(
    "pattern,packed", [(BENCH_REGEX, True), ("flu[vV]io", True), ("flu[vV]io", False)],
    ids=["22-state", "fluvio", "unpacked"],
)
def test_dfa_compose_columns_matches_xla_and_pallas(pattern, packed):
    ref = ref_compile_regex(pattern, packed=packed)
    table_t = np.ascontiguousarray(ref.table.T.astype(np.int32))
    cls = _compose_inputs(np.random.default_rng(ref.n_states), 37, 45, ref.n_classes)
    port = cuda_kernels.dfa_compose_columns(torch.from_numpy(cls), torch.from_numpy(table_t))
    assert port.dtype == torch.int32 and port.shape == (37, ref.n_states)
    xla = jax_kernels.dfa_compose_columns(jnp.asarray(cls), jnp.asarray(table_t), ref.n_states)
    np.testing.assert_array_equal(port.numpy(), np.asarray(xla))
    pallas = pallas_kernels.dfa_compose_columns_pallas(
        jnp.asarray(cls), jnp.asarray(table_t), ref.n_states, interpret=True
    )
    np.testing.assert_array_equal(port.numpy(), np.asarray(pallas))
    # composing two halves in order equals the whole (a applied first)
    a = cuda_kernels.dfa_compose_columns(torch.from_numpy(cls[:, :20].copy()), torch.from_numpy(table_t))
    b = cuda_kernels.dfa_compose_columns(torch.from_numpy(cls[:, 20:].copy()), torch.from_numpy(table_t))
    from fluvio_tpu_torch.smartengine.gpu import kernels

    np.testing.assert_array_equal(kernels.dfa_compose(a, b).numpy(), port.numpy())


def test_striped_json_span_matches():
    docs = _json_corpus()
    lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), kmax = _striped(docs)
    n = len(lengths)
    ref_kmax = int(ref_stripes.stripe_counts(np.asarray([RecordBuffer.from_values(docs).width]), S, V)[0])
    for key in ("name", "pad", "n"):
        st, ln = stripes.striped_json_span(port_sv, port_plan, torch.from_numpy(lengths), key, kmax)
        ref_st, ref_ln = jax.jit(lambda sv: ref_stripes.striped_json_span(
            sv, ref_plan, jnp.asarray(lengths), key, ref_kmax, n))(ref_sv)
        np.testing.assert_array_equal(st.numpy(), np.asarray(ref_st))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(ref_ln))
        if key == "name":
            fields = [d[int(st[i]) : int(st[i]) + int(ln[i])] for i, d in enumerate(docs)]
            assert b"fluvio" * 30 in fields and b"7" * 150 in fields


def _port_dfa(ref):
    return interop.dfa_from_reference(
        ref.table, ref.byte_class, ref.accept, ref.start, ref.eos_class, ref.pad_class
    )


def test_striped_dfa_verdict_matches():
    rng = np.random.default_rng(21)
    words = [b"fluvio", b"fluVio", b"flu", b"vio", b"x" * 40]
    docs = [b" ".join(words[int(rng.integers(len(words)))] for _ in range(int(rng.integers(0, 30))))
            for _ in range(60)]
    docs += [b"y" * pad + b"fluvio" + b"z" * 30 for pad in range(38, 70)]
    lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), kmax = _striped(docs)
    n = len(lengths)
    for pattern in ("flu[vV]io", "^fluvio", "o$", "flu(vio)+ z"):
        ref = ref_compile_regex(pattern)
        got = stripes.striped_dfa_verdict(port_sv, port_plan, _port_dfa(ref), kmax)
        want = jax.jit(lambda sv: ref_stripes.striped_dfa_verdict(sv, ref_plan, ref, n))(ref_sv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=pattern)


def test_striped_in_span_predicates_match():
    docs = _json_corpus(seed=12)
    lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), kmax = _striped(docs)
    n = len(lengths)
    ref_kmax = int(ref_stripes.stripe_counts(np.asarray([RecordBuffer.from_values(docs).width]), S, V)[0])
    vst, vln = stripes.striped_json_span(port_sv, port_plan, torch.from_numpy(lengths), "name", kmax)
    ref_vst, ref_vln = jax.jit(lambda sv: ref_stripes.striped_json_span(
        sv, ref_plan, jnp.asarray(lengths), "name", ref_kmax, n))(ref_sv)
    for pattern in (BENCH_REGEX, "flu[vV]io", "^$"):
        ref = ref_compile_regex(pattern)
        got = stripes.striped_dfa_in_span(port_sv, port_plan, _port_dfa(ref), vst, vln, kmax)
        want = jax.jit(lambda sv: ref_stripes.striped_dfa_in_span(
            sv, ref_plan, ref, ref_vst, ref_vln, n))(ref_sv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=pattern)
        assert 0 < int(got.sum()) < count
    for lit in (b"fluvio", b"-1", b"fluvio-1", b""):
        for kind in ("contains", "startswith", "endswith", "equals"):
            got = stripes.striped_literal_in_span(port_sv, port_plan, lit, vst, vln, kind, n)
            want = jax.jit(lambda sv: ref_stripes.striped_literal_in_span(
                sv, ref_plan, lit, ref_vst, ref_vln, kind, n))(ref_sv)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{lit} {kind}")


# ---------------------------------------------------------------------------
# Whole chains: the port's SmartEngine against the JAX package's
# ---------------------------------------------------------------------------


def _filter(pattern):
    return ("filter", lambda d: d.FilterProgram(predicate=d.RegexMatch(arg=d.Value(), pattern=pattern)))


UPPER = ("map", lambda d: d.MapProgram(value=d.Upper(arg=d.Value())))


def _run_striped(specs, values, **buf_kw):
    from fluvio_tpu.models import lookup as ref_lookup
    from fluvio_tpu.smartengine import SmartEngine as RefEngine
    from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
    from fluvio_tpu_torch.models import lookup

    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu", stripes=PARAMS).builder()
    for spec, params in specs:
        ref_m, port_m = (ref_lookup(spec), lookup(spec)) if isinstance(spec, str) else _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(params)), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(params)), port_m)
    ref_chain = rb.initialize().tpu_chain
    port_chain = pb.initialize().gpu_chain
    ref_buf = _ref_buffer(values, **buf_kw)
    assert ref_buf.width > THRESHOLD
    assert ref_chain._striped_chain() is not None, "the reference did not take the striped path"
    ref_out = ref_chain.process_buffer(ref_buf)
    port_out = port_chain.process_buffer(_port_buffer(ref_buf))
    _assert_equal(ref_out, port_out)
    return port_out


class TestChains:
    def test_literal_filter(self, small_stripes):
        values = [b"x" * pad + b"fluvio" + b"y" * 40 for pad in range(0, 110)]
        values += [b"x" * pad + b"fluvi" + b"y" * 40 for pad in range(0, 40)]
        out = _run_striped([("regex-filter", {"regex": "fluvio"})], values,
                           ts=list(range(len(values))), base_ts=9)
        assert out.count == 110

    def test_json_regex_filter(self, small_stripes):
        docs = _json_corpus(seed=13) + [b'{"pad":"' + b"w" * 50 + b'","name":"kafka-2"}']
        out = _run_striped([("json-regex-filter", {"key": "name", "regex": BENCH_REGEX})], docs)
        assert out.count > 3

    def test_dfa_filter_then_json_map(self, small_stripes):
        docs = _json_corpus(seed=14)
        out = _run_striped([("regex-filter", {"regex": "flu[vV]io"}), ("json-map", {"field": "name"})],
                           docs, base_offset=500)
        assert out.count > 3 and b"FLUVIO-1" in out.value_list()

    def test_upper_map_postops(self, small_stripes):
        rng = np.random.default_rng(8)
        values = [bytes(rng.integers(32, 127, size=int(rng.integers(0, 300))).astype(np.uint8))
                  for _ in range(50)]
        keys = [None if i % 2 else b"k%d" % i for i in range(len(values))]
        _run_striped([(_filter("[a-m]{2}"), {}), (UPPER, {})], values, keys=keys)

    def test_overlap_exceeding_literal(self, small_stripes):
        lit = b"fluvio-streaming-engine"  # 23 bytes > the 16-byte overlap
        values = [b"a" * pad + lit + b"b" * 20 for pad in range(30, 90, 3)]
        values += [b"a" * pad + lit[:-1] + b"b" * 20 for pad in range(30, 60, 5)]
        out = _run_striped([("regex-filter", {"regex": lit.decode()})], values)
        assert out.count == 20

    def test_dfa_past_the_gate_spills(self, small_stripes):
        from fluvio_tpu.models import lookup as ref_lookup
        from fluvio_tpu.smartengine import SmartEngine as RefEngine
        from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
        from fluvio_tpu_torch.models import lookup

        pattern = "(a|b)*a(a|b){6}"
        assert ref_compile_regex(pattern).n_states > stripes.DFA_STRIPE_MAX_STATES
        params = {"regex": pattern}
        ref_chain = RefEngine(backend="tpu").builder().add_smart_module(
            RefConfig(params=params), ref_lookup("regex-filter")).initialize().tpu_chain
        assert ref_chain._striped_chain() is None
        port_chain = SmartEngine(device="cpu", stripes=PARAMS).builder().add_smart_module(
            SmartModuleConfig(params=params), lookup("regex-filter")).initialize().gpu_chain
        with pytest.raises(GpuSpill) as e:
            port_chain.process_buffer(RecordBuffer.from_values([b"ab" * 60]))
        assert e.value.reason == "record-too-wide-unstripeable"
        # a narrow batch of the same chain still runs
        assert port_chain.process_buffer(RecordBuffer.from_values([b"aabababa", b"b"])).count == 1
