"""Byte-mode packed payload, its down link, and striped aggregate and split
explode: the port (on the CPU) against the JAX package, tolerance 0.

- `kernels.packed_payload` against ``TpuChainExecutor._packed_payload``;
- narrow byte-mode chains (aggregates, windowed sums, a key-rewriting
  map) against ``SmartEngine(backend="tpu")`` over three batches: equal
  outputs and carries, flat-backed results, and the D2H bytes of each
  batch equal to the packed formula;
- the byte-mode down link: tokens win on a settled running max, the
  ratio declines on noise, the outputs equal the reference either way;
- `stripes.striped_split_bounds` against the JAX function on separator
  corners around the stripe joints;
- striped chains against the JAX engine, both on stripes of 64 bytes
  overlapping by 16 above a 64-byte threshold (the JAX side through the
  ``FLUVIO_STRIPE_*`` variables, the port through `StripeParams`), and the
  chains that still spill.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartengine.tpu import stripes as ref_stripes
from fluvio_tpu.smartengine.tpu.executor import TpuChainExecutor
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.smartengine import (
    GpuSpill,
    LinkParams,
    SmartEngine,
    SmartModuleConfig,
)
from fluvio_tpu_torch.smartengine.gpu import glz, kernels, stripes
from fluvio_tpu_torch.smartengine.gpu.executor import _HEADER, _bucket_rows
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_chain import _assert_equal, _module_pair, _port_buffer, _ref_buffer
from tests.test_torch_isolation import gen_arrays, gen_json
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_torch_stripes import PARAMS, S, V, _striped, small_stripes  # noqa: F401

NEWLINE = ord("\n")


def _chains(specs, stripes_params=None, link=None):
    """specs: [(registry name | (kind, build), params[, initial_data])] ->
    (JAX executor, port executor)."""
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu", stripes=stripes_params or stripes.StripeParams(),
                     link=link or LinkParams()).builder()
    for spec, params, *initial in specs:
        init = initial[0] if initial else b""
        ref_m, port_m = (ref_lookup(spec), lookup(spec)) if isinstance(spec, str) else \
            _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(params), initial_data=init), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(params), initial_data=init), port_m)
    ref_chain = rb.initialize()
    assert ref_chain.backend_in_use == "tpu"
    return ref_chain.tpu_chain, pb.initialize().gpu_chain


def _stream_both(ref_chain, port_chain, ref_bufs):
    """Stream the batches through both chains: outputs and carries equal."""
    ref_outs = list(ref_chain.process_stream(ref_bufs))
    port_outs = list(port_chain.process_stream([_port_buffer(b) for b in ref_bufs]))
    assert len(port_outs) == len(ref_outs) == len(ref_bufs)
    for r, p in zip(ref_outs, port_outs):
        _assert_equal(r, p)
    ref_chain._ensure_host_state()
    port_chain._ensure_host_state()
    assert port_chain.carries == ref_chain.carries
    return port_outs


# ---------------------------------------------------------------------------
# the packed payload
# ---------------------------------------------------------------------------

PAYLOAD_CASES = {
    "short": (24, [0, 1, 2, 3, 4, 5, 24, 7, 0, 23]),
    "full_width": (20, [20] * 6),
    "all_empty": (16, [0] * 9),
    "one_row": (12, [11]),
    "odd_width": (18, [18, 17, 3, 0, 18]),
}


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_packed_payload_matches_jax(case):
    """Every row's first aligned bytes at the cumsum of the aligned
    lengths, the total and the zero tail as the JAX executor packs them
    (a width that is no multiple of 4 rounds up, so the last row fits)."""
    width, lens = PAYLOAD_CASES[case]
    rng = np.random.default_rng(len(case))
    lengths = np.array(lens, dtype=np.int32)
    values = rng.integers(1, 256, size=(len(lens), width)).astype(np.uint8)
    values[np.arange(width)[None, :] >= lengths[:, None]] = 0  # compacted rows are zero-padded
    payload, total = kernels.packed_payload(torch.from_numpy(values), torch.from_numpy(lengths))
    ref_payload, ref_total = TpuChainExecutor._packed_payload(jnp.asarray(values),
                                                              jnp.asarray(lengths))
    ref_payload = np.asarray(ref_payload)
    want = int(((lengths.astype(np.int64) + 3) & ~3).sum())
    assert int(total) == want
    got = payload.numpy()
    assert got.shape[0] == len(lens) * ((width + 3) & ~3) and not got[want:].any()
    if width % 4 == 0:
        assert int(ref_total) == want
        np.testing.assert_array_equal(got, ref_payload)
    else:
        # the JAX payload drops the aligned tail bytes past its unrounded cap
        cap = len(lens) * width
        np.testing.assert_array_equal(got[: min(want, cap)], ref_payload[: min(want, cap)])
    for i, n in enumerate(lens):
        start = int(((lengths[:i].astype(np.int64) + 3) & ~3).sum())
        assert got[start:start + n].tobytes() == values[i, :n].tobytes()


# ---------------------------------------------------------------------------
# narrow byte mode
# ---------------------------------------------------------------------------

WINDOWED_SUM = ("windowed-sum", {"window_ms": "100"})
KEY_REWRITE = (
    ("filter_map", lambda d: d.FilterMapProgram(
        predicate=d.RegexMatch(arg=d.Value(), pattern="fl(u|i)"),
        value=d.Concat(args=[d.Const(data=b"<"), d.JsonGet(arg=d.Value(), key="name"),
                             d.Const(data=b">")]),
        key=d.Upper(arg=d.Key()),
    )),
    {},
)
NARROW_CHAINS = {
    "aggregate-sum": [("aggregate-sum", {})],
    "aggregate-field-add": [("aggregate-field", {"field": "n", "combine": "add"})],
    "aggregate-field-max": [("aggregate-field", {"field": "n", "combine": "max"})],
    "windowed-sum": [WINDOWED_SUM],
    "key-rewrite": [KEY_REWRITE],
}


def _narrow_batches(name: str):
    out = []
    for k, n in enumerate((300, 5, 700)):
        docs = gen_json(n, seed=40 + k)
        if name == "aggregate-sum":
            docs = [b"%d" % (int(d.split(b'"n":')[1][:-1]) - 50000) for d in docs]
            docs[: 3] = [b"", b"x", b"-0"]
        keys = [None if i % 3 == 0 else b"k%d" % i for i in range(n)]
        ts = list(range(0, 7 * n, 7))
        out.append(_ref_buffer(docs, keys=keys, ts=ts, base_ts=1000 * k, base_offset=100 * k))
    return out


def _packed_d2h(port_in, out, width: int, key_width: int, writes_keys: bool) -> int:
    """The bytes a narrow byte-mode batch downloads: the header (five
    columns and the payload's byte count, int64), the survivor mask, the
    payload sliced to its bucket, the lengths (u8 up to 255-byte outputs,
    else i32) and the keys of the bucketed survivor rows (their lengths,
    and their bytes to the longest key's pow2 bucket)."""
    count = out.count
    rows = min(_bucket_rows(max(count, 1)), port_in.rows)
    l4 = (out.lengths[:count].astype(np.int64) + 3) & ~3
    n = 8 * (_HEADER + 1) + (port_in.rows + 7) // 8
    n += min(_bucket_rows(max(int(l4.sum()), 1), floor=256), port_in.rows * ((width + 3) & ~3))
    n += rows * (1 if width + 1 <= 256 else 4)
    if port_in.has_keys() or writes_keys:
        n += rows * 4
        max_k = int(out.key_lengths[:count].max(initial=0))
        if max_k > 0:
            n += rows * min(_bucket_rows(max_k) if max_k <= 8 else 1 << (max_k - 1).bit_length(),
                            key_width)
    return n


@pytest.mark.parametrize("name", sorted(NARROW_CHAINS))
def test_narrow_byte_mode_chains(name):
    """Three batches, equal outputs and carries; each output adopts the
    payload flat-backed, and each batch's D2H equals the packed formula."""
    ref_chain, port_chain = _chains(NARROW_CHAINS[name])
    bufs = _narrow_batches(name)
    _stream_both(ref_chain, port_chain, bufs)
    assert not port_chain._viewable
    for ref_buf in bufs:
        port_in = _port_buffer(ref_buf)
        before = port_chain.link_counts["d2h_bytes"]
        handle = port_chain.dispatch_buffer(port_in)
        width, key_width = handle.byte_cols[4], handle.byte_cols[2].shape[1]
        out = port_chain.finish_buffer(port_in, handle)
        assert out.values is None and out._flat is not None  # flat-backed
        got = port_chain.link_counts["d2h_bytes"] - before
        assert got == _packed_d2h(port_in, out, width, key_width, port_chain._writes_keys), name
    assert port_chain.link_counts["down-packed"] == 6


def test_all_empty_survivors_and_no_survivors():
    """A map whose every output is empty ships an empty payload; a filter
    that keeps nothing ships none; both against the reference."""
    empty = ("map", lambda d: d.MapProgram(value=d.Const(data=b""), key=d.Const(data=b"k")))
    ref_chain, port_chain = _chains([(empty, {})])
    _stream_both(ref_chain, port_chain, [_ref_buffer([b"a", b"bb", b""] * 5)])
    ref_chain, port_chain = _chains([("regex-filter", {"regex": "nothing-matches"}),
                                     ("aggregate-sum", {})])
    outs = _stream_both(ref_chain, port_chain, [_ref_buffer([b"1", b"2"])])
    assert outs[0].count == 0


# ---------------------------------------------------------------------------
# the byte-mode down link
# ---------------------------------------------------------------------------

CHUNK = 16 * 1024


def test_byte_mode_down_link_tokens_and_decline():
    """A settled running max repeats one decimal: its payload's tokens are
    smaller than the raw slice and ship (``down-glz``); running sums of
    noise do not compress and decline (``glz-enc-ratio``). The outputs
    equal the reference's (link off) either way."""
    link = LinkParams(result_compress=True, chunk=CHUNK)
    spec = [("aggregate-field", {"field": "n", "combine": "max"})]
    ref_chain, port_chain = _chains(spec, link=link)
    _stream_both(ref_chain, port_chain, [_ref_buffer(gen_json(3000, seed=s)) for s in (5, 6)])
    counts = port_chain.link_counts
    assert counts["down-glz"] == 2 and counts["down-packed"] == 0
    assert counts[glz.DECLINE_ENC_RATIO] == 0

    rng = np.random.default_rng(9)
    noise = [b"%d" % v for v in rng.integers(-10**15, 10**15, size=3000)]
    ref_chain, port_chain = _chains([("aggregate-sum", {})], link=link)
    _stream_both(ref_chain, port_chain, [_ref_buffer(noise)])
    counts = port_chain.link_counts
    assert counts[glz.DECLINE_ENC_RATIO] == 1 and counts["down-packed"] == 1
    assert counts["down-glz"] == 0


# ---------------------------------------------------------------------------
# striped split bounds
# ---------------------------------------------------------------------------

STEP = S - V


def _split_docs(rng):
    nl = b"\n"
    docs = [
        b"",
        b"a" * (STEP - 1) + nl + b"b" * 100,  # separator at column step - 1 (last owned byte)
        b"a" * STEP + nl + b"b" * 70,  # separator at column 0 of the next row
        b"a" * 50 + nl * 20 + b"c" * 60,  # a separator run across the overlap and the joint
        b"a" * (3 * S + 10),  # no separator over 4 stripes
        nl * 150,  # separators only
        nl + b"x" * 130 + nl,  # leading and trailing separators
        b"y" * (STEP + 5) + nl,  # separator in the overlap, last byte of the record
        b"z" * (2 * STEP - 1) + nl + b"w",
        b"q" * 65,
        b"short\nrecord",
    ]
    for _ in range(25):
        n = int(rng.integers(0, 260))
        sym = rng.choice(np.array([ord("a"), ord("b"), NEWLINE], dtype=np.uint8), size=n,
                         p=[0.45, 0.4, 0.15])
        docs.append(sym.tobytes())
    return docs


def test_striped_split_bounds_matches_jax():
    """(flag, start, length) over every stripe row, dead rows included."""
    docs = _split_docs(np.random.default_rng(12))
    lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), _ = _striped(docs)
    assert port_plan["seg"].shape[0] > int(port_plan["row_live"].sum())  # dead rows
    n = len(lengths)
    want = ref_stripes.striped_split_bounds(ref_sv, ref_plan, NEWLINE, n)
    got = stripes.striped_split_bounds(port_sv, port_plan, NEWLINE, n)
    for name, g, w in zip(("flag", "start", "elen"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the elements, rebuilt from the grid, are the interpreter's split
    flag, st, ln = (t.numpy() for t in got)
    seg = port_plan["seg"].numpy()
    elems = [[] for _ in range(n)]
    for r, c in zip(*np.nonzero(flag)):
        elems[seg[r]].append(docs[seg[r]][st[r, c]:st[r, c] + ln[r, c]])
    assert elems[:count] == [[e for e in d.split(b"\n") if e] for d in docs]


# ---------------------------------------------------------------------------
# striped chains
# ---------------------------------------------------------------------------

NAMES = (b"fluvio", b"kafka", b"fluVio", b"pulsar")


def _fat_numbers(rng, n: int, narrow: int = 3):
    """Records of a signed integer and a space, then ~70-300 bytes of text
    with a name cycling over four; a few narrow ones among them."""
    docs = []
    for i in range(n):
        num = int(rng.integers(-10**6, 10**6))
        body = b"%s-%d " % (NAMES[i % 4], i) + b"lorem ipsum " * int(rng.integers(5, 25))
        docs.append(b"%d " % num + body if i % 11 else b"  %d" % num)
    for i in range(narrow):
        docs[i * 7] = b"%d" % (i - 1)
    return docs


def _fat_lines(rng, n: int):
    """Records of 3-40 lines of 5-40 bytes with runs of empty lines, the
    name of each record in its first line."""
    docs = []
    for i in range(n):
        lines = [NAMES[i % 4] + b" log"]
        for _ in range(int(rng.integers(3, 40))):
            k = int(rng.integers(0, 6))
            lines.append(b"" if k == 0 else bytes(rng.integers(97, 123, int(rng.integers(5, 40)))
                                                  .astype(np.uint8)))
        docs.append(b"\n".join(lines) + (b"\n\n" if i % 3 == 0 else b""))
    return docs


def _striped_both(specs, batches, **kw):
    ref_chain, port_chain = _chains(specs, PARAMS, **kw)
    assert ref_chain._striped_chain() is not None, "the reference did not take the striped path"
    for b in batches:
        assert b.width > PARAMS.threshold
    outs = _stream_both(ref_chain, port_chain, batches)
    return ref_chain, port_chain, outs


def _numbers_batches(seed: int, sizes=(40, 25), ts=False):
    rng = np.random.default_rng(seed)
    out = []
    for k, n in enumerate(sizes):
        docs = _fat_numbers(rng, n)
        kw = dict(ts=list(range(0, 9 * n, 9)), base_ts=500 + 1000 * k) if ts else {}
        out.append(_ref_buffer(docs, keys=[None if i % 2 else b"k%d" % i for i in range(n)],
                               base_offset=50 * k, **kw))
    return out


@pytest.mark.parametrize("name", ["aggregate-sum", "aggregate-max", "aggregate-count"])
def test_striped_aggregate(small_stripes, name):
    _, port_chain, outs = _striped_both([(name, {})], _numbers_batches(3))
    assert port_chain._striped.has_agg and outs[0].values is None


def test_striped_filter_then_aggregate_across_two_calls(small_stripes):
    """The carry runs on from one call to the next and starts from the
    initial data."""
    specs = [("regex-filter", {"regex": "flu[vV]io"}), ("aggregate-sum", {}, b"-7")]
    ref_chain, port_chain = _chains(specs, PARAMS)
    batches = _numbers_batches(4)
    for b in batches:
        _stream_both(ref_chain, port_chain, [b])
    assert port_chain.carries[0][2]


def test_striped_windowed_sum(small_stripes):
    _, port_chain, outs = _striped_both([WINDOWED_SUM], _numbers_batches(5, ts=True))
    assert outs[0].key_list()[0] is not None


def test_striped_split_explode(small_stripes):
    """Elements that span stripes, empty lines dropped; batch 1 is narrow
    records among wide ones."""
    rng = np.random.default_rng(6)
    docs = _fat_lines(rng, 12)
    batches = [_ref_buffer(docs), _ref_buffer(docs[:3] + [b"a\nb", b"", b"c"])]
    _, port_chain, outs = _striped_both([("array-map-lines", {})], batches)
    assert outs[0].count == sum(len([e for e in d.split(b"\n") if e]) for d in docs)
    assert port_chain._striped.fanout


def test_striped_filter_then_explode_overflows_and_learns(small_stripes):
    """A filter ahead of the explode; the first batch's elements overflow
    the default capacity, run again over the same survivors at the
    bucketed total, and the learned capacity holds the next batch."""
    rng = np.random.default_rng(7)
    docs = _fat_lines(rng, 160)
    specs = [("regex-filter", {"regex": "flu[vV]io"}), ("array-map-lines", {})]
    _, port_chain, outs = _striped_both(specs, [_ref_buffer(docs), _ref_buffer(docs[:60])])
    want = sum(len([e for e in d.split(b"\n") if e]) for d in docs if NAMES[0] in d.lower())
    assert outs[0].count == want > 1024
    assert port_chain.redispatches == 1 and port_chain._cap_ratio > 4


SPILLS = {
    "array-map-json": [("array-map-json", {})],
    "word-count": [("word-count", {})],
    "aggregate-field": [("aggregate-field", {"field": "n"})],
    "aggregate-after-span-map": [("json-map", {"field": "name"}), ("aggregate-sum", {})],
}


@pytest.mark.parametrize("name", sorted(SPILLS))
def test_still_spills(small_stripes, name):
    """No striped lowering on either side: the wide batch raises before
    anything runs and the carries stay where they were."""
    ref_chain, port_chain = _chains(SPILLS[name], PARAMS)
    assert ref_chain._striped_chain() is None
    narrow = _port_buffer(_ref_buffer(gen_arrays(20) if "array" in name else gen_json(20)))
    port_chain.process_buffer(narrow)
    port_chain._ensure_host_state()
    carries = list(port_chain.carries)
    wide = _port_buffer(_ref_buffer([b'{"name":"fluvio","n":5,"pad":"' + b"p" * 90 + b'"}']))
    assert wide.width > PARAMS.threshold
    with pytest.raises(GpuSpill) as e:
        port_chain.dispatch_buffer(wide)
    assert e.value.reason == "record-too-wide-unstripeable"
    port_chain._ensure_host_state()
    assert port_chain.carries == carries


def test_integer_past_the_first_stripe_follows_the_reference(small_stripes):
    """Reference fault: a striped aggregate parses only the first stripe's
    bytes. An integer that starts past it parses as 0, one cut by the
    stripe's end as its prefix; the interpreter reads the whole record.
    The port follows the JAX engine."""
    docs = [b" " * S + b"5", b" " * (S - 2) + b"123456"]
    ref_chain, port_chain, outs = _striped_both([("aggregate-sum", {})], [_ref_buffer(docs)])
    assert outs[0].value_list() == [b"0", b"12"]
    assert [ref_dsl.parse_int_prefix(d) for d in docs] == [5, 123456]
