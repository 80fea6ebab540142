"""The aggregate slice: the port's integer kernels against the JAX
package's, and aggregate chains of the port's SmartEngine (on the CPU)
against the JAX package's ``backend="tpu"`` SmartEngine (JAX on the CPU),
over the same staged columns, across several batches; tolerance 0.

The carries must continue from batch to batch on both sides and end
equal. Every test leaves the JAX package's batch-handle gauges where it
found them (`_gauges_unchanged`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.smartengine.tpu import kernels as ref_kernels
from fluvio_tpu.smartengine.tpu.executor import TpuChainExecutor
from fluvio_tpu.telemetry import TELEMETRY
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.smartengine import EngineError, SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import kernels
from fluvio_tpu_torch.smartmodule import dsl
from tests.test_torch_chain import (
    _assert_equal,
    _module_pair,
    _port_buffer,
    _ref_buffer,
)
from tests.test_torch_isolation import gen_json
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


@pytest.fixture(autouse=True)
def _gauges_unchanged():
    """The JAX side's process-global gauges end where they started: every
    reference handle a test dispatches is finished."""
    before = [TELEMETRY.gauge_value(g) for g in ("live_batch_handles", "hbm_staged_bytes")]
    yield
    after = [TELEMETRY.gauge_value(g) for g in ("live_batch_handles", "hbm_staged_bytes")]
    assert after == before


def _stage(docs, width=None):
    width = width or max(8, max(len(d) for d in docs))
    values = np.zeros((len(docs), width), dtype=np.uint8)
    lengths = np.zeros(len(docs), dtype=np.int32)
    for i, d in enumerate(docs):
        values[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    return values, lengths


def _wrap(v: int) -> int:
    return (v + 2**63) % 2**64 - 2**63


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

PARSE_DOCS = [
    b"0", b"7", b"-1", b"+42", b"  \t\r\n12", b"\x0b5", b"\x0c5", b"-", b"+", b"+-5", b"- 5",
    b"12abc", b"abc", b"", b" ", b"007", b"-0", b"123 456",
    b"9223372036854775807", b"-9223372036854775808", b"9223372036854775808",
    b"18446744073709551615", b"18446744073709551616", b"1234567890123456789012345",
    b"-1234567890123456789012345", b"  +9999999999999999999999999",
    b"9" * 63, b"9" * 64, b"9" * 65, b"1" + b"0" * 70, b"-" + b"7" * 90,
    b'{"n":5}', b"5\x00", b"12.5",
]


def test_parse_int_matches_jax_and_the_interpreter():
    rng = np.random.default_rng(3)
    docs = list(PARSE_DOCS)
    alphabet = np.frombuffer(b" \t+-0123456789x", dtype=np.uint8)
    for _ in range(400):
        docs.append(alphabet[rng.integers(0, len(alphabet), int(rng.integers(0, 40)))].tobytes())
    for width in (None, 128):
        values, lengths = _stage(docs, width)
        got = kernels.parse_int(torch.from_numpy(values), torch.from_numpy(lengths)).numpy()
        want = np.asarray(ref_kernels.parse_int(jnp.asarray(values), jnp.asarray(lengths)))
        np.testing.assert_array_equal(got, want)
        assert got.tolist() == [_wrap(dsl.parse_int_prefix(d)) for d in docs]


def test_parse_int_digits_run_to_the_last_column():
    docs = [b"1" * 32, b"-" + b"2" * 31, b" " * 31 + b"3"]
    values, lengths = _stage(docs, 32)
    got = kernels.parse_int(torch.from_numpy(values), torch.from_numpy(lengths)).numpy()
    want = np.asarray(ref_kernels.parse_int(jnp.asarray(values), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got, want)


INT_EDGES = [INT64_MIN, INT64_MIN + 1, INT64_MAX, 0, -1, 1] + [
    s * v for k in range(19) for v in (10**k, 10**k - 1) for s in (1, -1)
]


def test_int_to_ascii_matches_jax_at_the_edges():
    rng = np.random.default_rng(5)
    xs = np.array(INT_EDGES + rng.integers(INT64_MIN, INT64_MAX, 300, dtype=np.int64).tolist(),
                  dtype=np.int64)
    got_v, got_l = kernels.int_to_ascii(torch.from_numpy(xs))
    want_v, want_l = ref_kernels.int_to_ascii(jnp.asarray(xs))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    rendered = [bytes(got_v.numpy()[i, : got_l[i]]) for i in range(len(xs))]
    assert rendered == [str(int(x)).encode() for x in xs]


def test_count_words_matches_jax():
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b" \t\n\r\x0b\x0cab", dtype=np.uint8)
    docs = [b"", b"one", b" two  words ", b"a\x0bb\x0cc"]
    docs += [alphabet[rng.integers(0, len(alphabet), int(rng.integers(0, 50)))].tobytes()
             for _ in range(200)]
    values, lengths = _stage(docs)
    got = kernels.count_words(torch.from_numpy(values), torch.from_numpy(lengths)).numpy()
    want = np.asarray(ref_kernels.count_words(jnp.asarray(values), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [dsl.count_words(d) for d in docs]


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_segmented_scan_matches_jax(op, n):
    rng = np.random.default_rng(n)
    x = rng.integers(INT64_MIN, INT64_MAX, n, dtype=np.int64)  # sums wrap
    x[rng.random(n) < 0.1] = INT64_MIN
    reset = rng.random(n) < 0.2
    got = kernels.segmented_scan(torch.from_numpy(x), torch.from_numpy(reset), op).numpy()
    want = np.asarray(ref_kernels.segmented_scan(jnp.asarray(x), jnp.asarray(reset), op))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_last_valid_helpers_match_jax(density):
    rng = np.random.default_rng(int(density * 10))
    vals = rng.integers(-1000, 1000, 64, dtype=np.int64)
    flags = rng.random(64) < density
    filled, has = kernels.propagate_last_valid(torch.from_numpy(vals), torch.from_numpy(flags))
    r_filled, r_has = ref_kernels.propagate_last_valid(jnp.asarray(vals), jnp.asarray(flags))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(r_filled))
    np.testing.assert_array_equal(has.numpy(), np.asarray(r_has))
    got = kernels.last_true_value(torch.from_numpy(flags), torch.from_numpy(vals),
                                  torch.tensor(-7, dtype=torch.int64))
    want = ref_kernels.last_true_value(jnp.asarray(flags), jnp.asarray(vals), jnp.int64(-7))
    assert int(got) == int(want)


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------


def _chains(specs):
    """specs: [(registry name | (kind, build), params, initial_data)] ->
    (ref executor, port executor)."""
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu").builder()
    for spec, params, initial in specs:
        if isinstance(spec, str):
            ref_m, port_m = ref_lookup(spec), lookup(spec)
        else:
            ref_m, port_m = _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(params), initial_data=initial), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(params), initial_data=initial), port_m)
    ref_chain = rb.initialize()
    assert ref_chain.backend_in_use == "tpu"
    return ref_chain.tpu_chain, pb.initialize().gpu_chain


def run_both(specs, ref_bufs):
    """Stream the batches through both chains; outputs and final carries equal."""
    ref_chain, port_chain = _chains([s if len(s) == 3 else (*s, b"") for s in specs])
    port_bufs = [_port_buffer(b) for b in ref_bufs]
    ref_outs = list(ref_chain.process_stream(ref_bufs))
    port_outs = list(port_chain.process_stream(port_bufs))
    assert len(port_outs) == len(ref_outs) == len(ref_bufs)
    for r, p in zip(ref_outs, port_outs):
        _assert_equal(r, p)
    ref_chain._ensure_host_state()
    port_chain._ensure_host_state()
    assert port_chain.carries == ref_chain.carries
    return port_chain, port_outs


def _batches(seed: int, sizes=(300, 7, 500), keys=False):
    out = []
    for k, n in enumerate(sizes):
        docs = gen_json(n, seed=seed + k)
        key_col = [None if i % 4 == 0 else b"key-%d" % i for i in range(n)] if keys else None
        out.append(_ref_buffer(docs, keys=key_col, base_offset=1000 * k))
    return out


NUMBERS = [b"12", b"-5", b"  7", b"abc", b"", b"9223372036854775807", b"1", b"-9223372036854775808",
           b"+3", b"100000"]
WORDS = [b"the quick  brown", b"", b"fox\tjumps\nover", b" lazy ", b"dog\x0bcat"]


@pytest.mark.parametrize("name,corpus", [
    ("aggregate-sum", NUMBERS), ("aggregate-count", NUMBERS), ("aggregate-max", NUMBERS),
    ("aggregate-min", NUMBERS), ("word-count", WORDS),
])
def test_canned_kinds_across_batches(name, corpus):
    rng = np.random.default_rng(len(name))
    bufs = []
    for k, n in enumerate((40, 3, 65)):
        docs = [corpus[i] for i in rng.integers(0, len(corpus), n)]
        bufs.append(_ref_buffer(docs, keys=[b"k" if i % 2 else None for i in range(n)]))
    run_both([(name, {})], bufs)


@pytest.mark.parametrize("combine", ["add", "max", "min"])
def test_aggregate_field_across_batches(combine):
    """`3_aggregate`'s module (``combine="add"``) and its max/min forms
    over the bench corpus; the carry continues across three batches."""
    chain, outs = run_both([("aggregate-field", {"field": "n", "combine": combine})],
                           _batches(11, keys=True))
    assert outs[0].count == 300 and outs[1].count == 7
    chain._ensure_host_state()
    assert chain.carries[0][0] == int(outs[-1].value_list()[-1])


def test_initial_data_seeds_the_accumulator():
    run_both([("aggregate-field", {"field": "n"}, b"  -1234xyz")], _batches(21))
    run_both([("aggregate-max", {}, b"5000")], [_ref_buffer(NUMBERS), _ref_buffer(NUMBERS[:3])])


def test_filter_then_aggregate():
    """`9_partitioned`'s chain on one partition, no partition runtime."""
    run_both([("regex-filter", {"regex": "fluvio"}), ("aggregate-field", {"field": "n"})],
             _batches(31))


def _windowed(window_ms: int):
    return ("aggregate-field", {"field": "n", "combine": "add", "window_ms": str(window_ms)})


def test_tumbling_window_across_batch_edges():
    """Window 100 ms: a boundary inside batch 0 (ts 95 -> 105), one exactly
    at the edge between batches 1 and 2 (batch 1 ends at 199, batch 2
    starts at 200), a batch with no timestamp (``base_ts`` -1 clamps to
    0) and one whose deltas start below zero."""
    docs = gen_json(12, seed=4)
    specs = [
        (docs, [90, 95, 99, 100, 105, 150, 150, 199, 230, 260, 299, 300], 0),
        (docs[:4], [0, 20, 50, 99], 100),
        (docs[:5], [0, 0, 1, 99, 100], 200),
        (docs[:3], [0, 5, 7], -1),
        (docs[:6], [-500, -1, 0, 10, 250, 251], 400),
    ]
    bufs = [_ref_buffer(d, ts=ts, base_ts=base) for d, ts, base in specs]
    chain, outs = run_both([_windowed(100)], bufs)
    assert outs[0].key_list()[:5] == [b"0", b"0", b"0", b"100", b"100"]
    assert chain.carries[0][1] == 600 and chain.carries[0][2]


def test_windowed_canned_kind_with_filter():
    win_count = ("aggregate", lambda d: d.AggregateProgram(kind="count", window_ms=50))
    docs = gen_json(40, seed=8)
    bufs = [_ref_buffer(docs, ts=list(range(0, 400, 10)), base_ts=1000 + 400 * k) for k in range(3)]
    run_both([("regex-filter", {"regex": "kafka|pulsar"}), (win_count, {})], bufs)


def test_aggregate_then_map_renders_on_the_card():
    """A map after the aggregate reads its decimal rendering, which
    `int_to_ascii` makes on the card."""
    then_upper = ("map", lambda d: d.MapProgram(
        value=d.Concat(args=[d.Const(data=b"#"), d.Value()])))
    run_both([("aggregate-min", {}), (then_upper, {})],
             [_ref_buffer(NUMBERS), _ref_buffer(NUMBERS[::-1])])


def test_two_aggregates_keep_two_carries():
    """The second aggregate parses the first's decimal rendering (made on
    the card); each keeps its own carry slot."""
    chain, _ = run_both([("aggregate-sum", {}, b"7"), ("aggregate-max", {}, b"")],
                        [_ref_buffer(NUMBERS), _ref_buffer(NUMBERS[::-1]), _ref_buffer(NUMBERS)])
    assert len(chain.carries) == 2


def test_len_and_int_to_bytes_lower():
    """``IntToBytes(Len(Value()))`` is lowerable now; a Len contribution
    sums record lengths."""
    render = ("map", lambda d: d.MapProgram(value=d.IntToBytes(arg=d.Len(arg=d.Value()))))
    run_both([(render, {})], [_ref_buffer([b"", b"abc", b"x" * 40])])
    by_len = ("aggregate", lambda d: d.AggregateProgram(
        contribution=d.Len(arg=d.Value()), combine="add"))
    run_both([(by_len, {})], [_ref_buffer(WORDS), _ref_buffer(WORDS)])


def test_delta_tiers_and_the_reference_delta_fault():
    """Running values whose steps need int16, int32 and int64 deltas,
    which the JAX package's int-output fetch ships per batch. A drop of
    exactly 2**63 defeats its probe (``max(|delta|)`` wraps to INT64_MIN,
    so it ships int16 zeros); the port renders the decimals on the card
    and gives the interpreter's answer (ROADMAP §3)."""
    small = [b"1", b"2", b"3"]
    mid = [b"1", b"70000", b"-70000"]
    big = [b"1", b"9000000000000", b"-9000000000000"]
    run_both([("aggregate-sum", {})], [_ref_buffer(small), _ref_buffer(mid), _ref_buffer(big)])
    ref_chain, port_chain = _chains([("aggregate-min", {}, b"")])
    docs = [b"0", b"-9223372036854775808", b"5"]
    ref_out = ref_chain.process_buffer(_ref_buffer(docs))
    port_out = port_chain.process_buffer(_port_buffer(_ref_buffer(docs)))
    assert [r.value for r in ref_out.to_records()] == [b"0", b"0", b"0"]
    assert port_out.value_list() == [b"0", b"-9223372036854775808", b"-9223372036854775808"]


def test_try_build_refuses_what_the_reference_refuses():
    """The reference's rules: a windowed aggregate after an array_map, an
    unknown combine, a contribution that is no int."""
    cases = [
        ["array-map-json", ("aggregate", lambda d: d.AggregateProgram(
            kind="count", window_ms=100))],
        [("aggregate", lambda d: d.AggregateProgram(
            contribution=d.Len(arg=d.Value()), combine="mul"))],
        [("aggregate", lambda d: d.AggregateProgram(
            contribution=d.Upper(arg=d.Value()), combine="add"))],
        [("aggregate", lambda d: d.AggregateProgram(kind="median_int"))],
    ]
    for case in cases:
        ref_entries, pb = [], SmartEngine(device="cpu").builder()
        for spec in case:
            if isinstance(spec, str):
                ref_m, port_m = ref_lookup(spec), lookup(spec)
            else:
                ref_m, port_m = _module_pair(*spec)
            ref_entries.append((ref_m, RefConfig()))
            pb.add_smart_module(SmartModuleConfig(), port_m)
        assert TpuChainExecutor.try_build(ref_entries) is None
        with pytest.raises(EngineError):
            pb.initialize()
