"""The array_map slice: the port's fan-out kernels against the JAX
package's, and explode chains of the port's SmartEngine (on the CPU)
against the JAX package's ``backend="tpu"`` SmartEngine (JAX on the CPU)
across several batches; tolerance 0.

`bench.gen_arrays`'s ~6 elements a record overflow the default capacity
(4 a row) once a batch fills its row bucket, so the overflow re-dispatch
runs in the chains here. Every test leaves the JAX package's batch-handle gauges
where it found them.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.smartengine.tpu import kernels as ref_kernels
from fluvio_tpu.smartengine.tpu.executor import TpuSpill
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.smartengine import LinkParams, SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import kernels
from fluvio_tpu_torch.smartmodule import dsl
from tests.test_torch_aggregate import _chains, _gauges_unchanged, _stage, run_both  # noqa: F401
from tests.test_torch_chain import _assert_equal, _port_buffer, _ref_buffer
from tests.test_torch_isolation import gen_arrays
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401


ARRAY_DOCS = [
    b"[]", b"[1]", b" [ 1 , 2 ] ", b'["a","b"]', b'["", "x", ""]', b"[,,]", b"[ , 1 ,]",
    b'[{"k":[1,2]},[3,[4]],"s,t"]', b'["q\\"uo,te", "back\\\\", "\\\\"]', b'[" padded "]',
    b'["a"b"]', b'[""]', b'["\\""]', b"[\t1\n,\r2\x0b]", b"\x0c[3]\x0b", b"[[]]", b"[{}]",
    b'[1, "unterminated]', b"[ ] ", b"[x y, z]",
]
NOT_ARRAYS = [b"", b"1", b"{}", b"[1", b"1]", b" ", b"]["]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _bounds_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_json_array_bounds_matches_jax():
    rng = np.random.default_rng(12)
    alphabet = np.frombuffer(b'[]{}",\\ \t1a', dtype=np.uint8)
    docs = ARRAY_DOCS + NOT_ARRAYS + gen_arrays(20)
    for _ in range(300):
        body = alphabet[rng.integers(0, len(alphabet), int(rng.integers(0, 30)))].tobytes()
        docs.append(b"[" + body + b"]" if rng.random() < 0.7 else body)
    values, lengths = _stage(docs)
    got = kernels.json_array_bounds(torch.from_numpy(values), torch.from_numpy(lengths))
    _bounds_equal(got, ref_kernels.json_array_bounds(jnp.asarray(values), jnp.asarray(lengths)))
    # and the interpreter's elements, record by record
    flag, st, ln, _, _, _, err = (t.numpy() for t in got)
    for i, d in enumerate(docs):
        want = dsl.json_array_elements(d)
        assert bool(err[i]) == (want is None), d
        if want is not None:
            cols = np.flatnonzero(flag[i])
            assert [d[st[i, c]: st[i, c] + ln[i, c]] for c in cols] == want, d


@pytest.mark.parametrize("sep", [b"\n", b",", b"\r\n", b"--", b"aba"])
def test_split_bounds_matches_jax(sep):
    rng = np.random.default_rng(len(sep))
    alphabet = np.frombuffer(b"ab-\r\n,", dtype=np.uint8)
    docs = [b"", sep, sep * 3, b"x" + sep, sep + b"x", b"ababa", b"abababa", b"---", b"a\r\n\r\nb"]
    docs += [alphabet[rng.integers(0, len(alphabet), int(rng.integers(0, 30)))].tobytes()
             for _ in range(300)]
    values, lengths = _stage(docs)
    got = kernels.split_bounds(torch.from_numpy(values), torch.from_numpy(lengths), sep)
    _bounds_equal(got, ref_kernels.split_bounds(jnp.asarray(values), jnp.asarray(lengths), sep))


def test_next_index_ge_matches_jax():
    cond = np.random.default_rng(1).random((50, 33)) < 0.2
    np.testing.assert_array_equal(
        kernels._next_index_ge(torch.from_numpy(cond)).numpy(),
        np.asarray(ref_kernels._next_index_ge(jnp.asarray(cond), 33)))


@pytest.mark.parametrize("cap", [1, 64, 1024])
def test_fanout_scatter_matches_jax(cap):
    docs = gen_arrays(100) + ARRAY_DOCS
    values, lengths = _stage(docs)
    rng = np.random.default_rng(cap)
    contributing = rng.random(len(docs)) < 0.8
    for mode in ("json", "split"):
        if mode == "json":
            b = ref_kernels.json_array_bounds(jnp.asarray(values), jnp.asarray(lengths))
        else:
            b = ref_kernels.split_bounds(jnp.asarray(values), jnp.asarray(lengths), b"ab")
        want = ref_kernels.fanout_scatter(*b[:6], jnp.asarray(contributing), cap)
        got = kernels.fanout_scatter(*(torch.from_numpy(np.array(x)) for x in b[:6]),
                                     torch.from_numpy(contributing), cap)
        assert int(got[0]) == int(want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------


def _array_batches(sizes=(300, 5, 700), keys=True):
    out = []
    for k, n in enumerate(sizes):
        docs = gen_arrays(n, seed=k)
        key_col = [None if i % 3 == 0 else b"k%d" % i for i in range(n)] if keys else None
        out.append(_ref_buffer(docs, keys=key_col, offsets=[3 * i for i in range(n)],
                               ts=[i for i in range(n)], base_offset=500 * k, base_ts=9))
    return out


def test_array_map_json_overflows_and_redispatches():
    """`4_array_map`: every batch's elements, keys and fresh zero deltas
    equal the reference's; a batch that overflows the default capacity
    runs again, and the learned ratio grows past the default."""
    chain, outs = run_both([("array-map-json", {})], _array_batches())
    assert outs[0].count == 6 * 300
    assert chain.redispatches >= 1 and chain._cap_ratio > 4.0
    assert not outs[2].offset_deltas[: outs[2].count].any()


def test_array_map_adversarial_records():
    run_both([("array-map-json", {})], [_ref_buffer(ARRAY_DOCS), _ref_buffer(ARRAY_DOCS[::-1]),
                                        _ref_buffer(gen_arrays(40))])


@pytest.mark.parametrize("sep", [b"\n", b"\r\n"])
def test_array_map_lines(sep):
    lines = ("array_map", lambda d: d.ArrayMapProgram(mode="split", sep=sep))
    rng = np.random.default_rng(len(sep))
    words = [b"alpha", b"", b"b", b"gamma delta", sep]
    bufs = []
    for n in (120, 3, 90):
        docs = [sep.join(words[j] for j in rng.integers(0, len(words), int(rng.integers(0, 9))))
                for _ in range(n)]
        bufs.append(_ref_buffer(docs, keys=[b"key"] * n))
    run_both([(lines, {})], bufs)
    if sep == b"\n":
        run_both([("array-map-lines", {})], bufs)


def test_array_map_then_filter_and_map():
    """An explode feeding a filter and a JsonGet map: both read the
    elements' bytes on the card (views of the source records)."""
    docs = [b'[{"name":"fluvio-1"},{"name":"kafka"}]', b'[{"name":"fluvio-tpu","n":3}, 7]',
            b'["fluvio", {"name":"x"}]']
    run_both([("array-map-json", {}), ("regex-filter", {"regex": "fluvio"}),
              ("json-map", {"field": "name"})],
             [_ref_buffer(docs * 40), _ref_buffer(docs), _ref_buffer(docs[::-1] * 9)])


def test_array_map_then_count_across_an_overflow():
    """``array_map -> aggregate(count)``: byte mode with source rows; the
    overflowed batch restarts from its own carries, so the count runs on
    from batch to batch without double counting."""
    chain, outs = run_both([("array-map-json", {}), ("aggregate-count", {})], _array_batches())
    assert chain.redispatches >= 1
    assert chain.carries == [(6 * (300 + 5 + 700), 0, True)]
    assert outs[2].value_list()[-1] == str(6 * 1005).encode()


def test_non_array_record_spills_and_keeps_the_carries():
    """A record that is no JSON array: the JAX executor raises `TpuSpill`
    (``transform-error``) and its chain reruns the batch in its
    interpreter; the port's executor re-dispatches the explode on the card
    and returns what that interpreter returns, the elements before the
    failing record with the error at it. The aggregate downstream keeps
    the carries of the batch before on both."""
    from fluvio_tpu.models import lookup as ref_lookup
    from fluvio_tpu.smartengine import SmartEngine as RefEngine
    from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
    from fluvio_tpu.smartmodule.types import SmartModuleInput as RefInput

    specs = [("array-map-json", {}, b""), ("aggregate-count", {}, b"")]
    ref_chain, port_chain = _chains(specs)
    interp = RefEngine(backend="python").builder()
    for name, _, _ in specs:
        interp.add_smart_module(RefConfig(), ref_lookup(name))
    interp = interp.initialize()

    def interpreted(buf):
        return interp.process(RefInput.from_records(
            buf.to_records(), base_offset=buf.base_offset, base_timestamp=buf.base_timestamp))

    good = _ref_buffer(gen_arrays(50))
    _assert_equal(ref_chain.process_buffer(good), port_chain.process_buffer(_port_buffer(good)))
    interpreted(good)
    bad = _ref_buffer(gen_arrays(10) + [b'{"not":"an array"}'] + gen_arrays(5))
    with pytest.raises(TpuSpill) as r:
        ref_chain.process_buffer(bad)
    assert r.value.reason == "transform-error"
    got, want = port_chain.process_buffer(_port_buffer(bad)), interpreted(bad)
    assert got.value_list() == [rec.value for rec in want.successes]
    assert got.key_list() == [rec.key for rec in want.successes]
    assert len(want.successes) == sum(len(json.loads(d)) for d in gen_arrays(10))
    e, w = got.error, want.error
    assert (e.hint, e.offset, e.kind.value, e.record_key, e.record_value) == (
        w.hint, w.offset, w.kind.value, w.record_key, w.record_value)
    assert port_chain.error_redispatches == 1
    ref_chain._ensure_host_state()
    port_chain._ensure_host_state()
    assert port_chain.carries == ref_chain.carries == [(300, 0, True)]
    _assert_equal(ref_chain.process_buffer(good), port_chain.process_buffer(_port_buffer(good)))


def test_array_map_with_the_glz_link():
    """With the link on both ways, the explode's descriptors come back as
    glz tokens where they are smaller, the source rows beside them; the
    outputs stay the reference's (which runs with the link off)."""
    ref_chain, _ = _chains([("array-map-json", {}, b"")])
    port_chain = (SmartEngine(device="cpu", link=LinkParams(compress=True, result_compress=True,
                                                            chunk=4096)).builder()
                  .add_smart_module(SmartModuleConfig(), lookup("array-map-json")).initialize().gpu_chain)
    bufs = [_ref_buffer(ARRAY_DOCS * 100), *_array_batches((2000, 3))]
    port_outs = list(port_chain.process_stream([_port_buffer(b) for b in bufs]))
    for ref_out, port_out in zip(ref_chain.process_stream(bufs), port_outs):
        _assert_equal(ref_out, port_out)
    assert port_chain.link_counts["glz"] >= 1 and port_chain.link_counts["down-glz"] >= 1


@pytest.mark.parametrize("name, spills", [("array-map-json", True), ("aggregate-sum", False)])
def test_wide_explode_batch_spills_at_dispatch(name, spills):
    """A batch wider than the narrow layout runs striped on the port, for a
    JSON-array explode (``spills``: the JAX package spills such a batch to
    its interpreter) and for a running sum alike. The record's three bytes
    are zeros: no JSON array, so the explode's output is empty and carries
    its transform error, and the sum's is 0."""
    chain = (SmartEngine(device="cpu").builder()
             .add_smart_module(SmartModuleConfig(), lookup(name)).initialize().gpu_chain)
    wide = _port_buffer(_ref_buffer([b"[1]"]))
    wide.values = np.zeros((8, (1 << 16) + 32), dtype=np.uint8)
    if spills:
        out = chain.process_buffer(wide)
        assert chain._striped_chain() is not None and chain._striped.fanout_json
        assert out.count == 0 and out.error.hint == "input record is not a JSON array"
        assert (out.error.offset, out.error.record_value) == (0, b"\0\0\0")
        return
    out = chain.process_buffer(wide)
    assert chain._striped_chain() is not None and chain._striped.has_agg
    assert out.count == 1 and out.value_list() == [b"0"]
    chain._ensure_host_state()
    assert chain.carries == [(0, 0, True)]
