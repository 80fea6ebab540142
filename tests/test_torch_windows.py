"""The windowed-state engine: the port's ``fluvio_tpu_torch.windows`` (on
the CPU) against the JAX package's ``fluvio_tpu.windows`` (JAX on the
CPU), on the same inputs made from a seed; tolerance 0, every field
bit-equal.

Specs are fully pinned (capacity 512, emit 256 unless a test says
otherwise), and one JAX `WindowJits` is shared per spec. Batches are
padded to a few fixed row counts, with ``count`` marking the live rows, so
each spec compiles its JAX programs once.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.analysis.envreg import BY_NAME
from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
from fluvio_tpu.windows import HostWindowReference as RefReference
from fluvio_tpu.windows import PartitionedWindowRuntime as RefPartitioned
from fluvio_tpu.windows import WindowCapacityError as RefCapacityError
from fluvio_tpu.windows import WindowedRuntime as RefRuntime
from fluvio_tpu.windows import WindowJits
from fluvio_tpu.windows import WindowSpec as RefSpec
from fluvio_tpu.windows import merge_banks as ref_merge_banks
from fluvio_tpu.windows.kernels import parse_two_ints as ref_parse_two_ints
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.smartengine import EngineError
from fluvio_tpu_torch.windows import (
    HostWindowReference,
    MaterializedView,
    PartitionedWindowRuntime,
    WindowCapacityError,
    WindowEagerOps,
    WindowSpec,
    WindowedRuntime,
    merge_banks,
)
from fluvio_tpu_torch.windows import spec as spec_mod
from fluvio_tpu_torch.windows.kernels import parse_two_ints
from tests.test_torch_aggregate import _gauges_unchanged, run_both  # noqa: F401
from tests.test_torch_chain import _port_buffer, _ref_buffer
from tests.test_torch_isolation import gen_ints, gen_keyed_ints

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1
FOREVER = 10**9  # lateness that never closes a window
ROWS = 64  # every fuzz batch pads to this many rows

GEOMETRIES = {
    "tumbling": dict(window_ms=100),
    "sliding": dict(window_ms=120, slide_ms=40),
    "keyed": dict(window_ms=90, slide_ms=30, keyed=True),
}

_JITS = {}


def _fields(window_ms=100, slide_ms=0, op="add", keyed=False, lateness_ms=0, capacity=512,
            emit_capacity=256, delta_only=True):
    return dict(window_ms=window_ms, slide_ms=slide_ms, op=op, keyed=keyed,
                lateness_ms=lateness_ms, capacity=capacity, emit_capacity=emit_capacity,
                delta_only=delta_only)


def _jits(ref_spec):
    jits = _JITS.get(ref_spec)
    if jits is None:
        jits = _JITS[ref_spec] = WindowJits(ref_spec)
    return jits


def _pair(**kw):
    """(JAX runtime, port runtime on the CPU) of one fully pinned spec."""
    fields = _fields(**kw)
    ref_spec = RefSpec(**fields)
    return (RefRuntime(ref_spec, jits=_jits(ref_spec)),
            WindowedRuntime(WindowSpec(**fields), device="cpu"))


DELTA_SCALARS = ("kind", "watermark", "n_open", "n_closed", "n_late", "delta_bytes",
                 "full_bytes", "records", "n_invalid", "partition", "offset")


def _assert_delta_equal(ref, port):
    for f in DELTA_SCALARS:
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("ids", "accs", "counts", "closed"):
        a, b = getattr(ref, f), getattr(port, f)
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _padded(batch, rows=ROWS):
    """(contribs, keys, ts, count) of ``(key, contrib, ts)`` rows, padded
    with junk rows past ``count`` (they must not count)."""
    n = len(batch)
    cols = np.full((3, rows), 7, dtype=np.int64)
    if n:
        cols[:, :n] = np.array([(c, k, t) for k, c, t in batch], dtype=np.int64).T
    return cols[0], cols[1], cols[2], n


def _drive_both(ref_rt, port_rt, batches, views=None):
    """Each batch through both runtimes: every delta and both banks equal
    after every batch."""
    out = []
    for batch in batches:
        args = _padded(batch)
        d_ref = ref_rt.ingest_arrays(*args[:3], count=args[3])
        d_port = port_rt.ingest_arrays(*args[:3], count=args[3])
        _assert_delta_equal(d_ref, d_port)
        assert port_rt.bank.snapshot() == ref_rt.bank.snapshot()
        if views is not None:
            for v in views:
                v.apply_delta(d_port)
        out.append(d_port)
    return out


def _gen_batches(rng, n_batches, per, n_keys, step, regress=0, t0=0):
    """Mostly-monotonic event time with backwards jitter (the late-record
    source); contribs include negatives."""
    t = t0
    batches = []
    for _ in range(n_batches):
        batch = []
        for _ in range(per):
            t += int(rng.integers(0, step))
            ts = t - int(rng.integers(0, regress + 1))
            batch.append((int(rng.integers(0, n_keys)), int(rng.integers(-50, 100)), ts))
        batches.append(batch)
    return batches


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------


def test_spec_defaults_and_pinned_fields_match_the_reference():
    for kw in ({"window_ms": 100}, {"window_ms": 120, "slide_ms": 40, "op": "max"},
               _fields(window_ms=90, slide_ms=30, op="min", keyed=True, lateness_ms=7,
                       capacity=9, emit_capacity=3, delta_only=False)):
        ref, port = RefSpec(**kw), WindowSpec(**kw)
        assert port.__dict__ == ref.__dict__
        for prop in ("fanout", "tumbling", "neutral", "mode"):
            assert getattr(port, prop) == getattr(ref, prop)
        assert port.describe() == ref.describe()
    # the port's constants are the reference registry's defaults
    assert spec_mod.DEFAULT_LATENESS_MS == int(BY_NAME["FLUVIO_WINDOW_LATENESS_MS"].default)
    assert spec_mod.DEFAULT_CAPACITY == int(BY_NAME["FLUVIO_WINDOW_CAPACITY"].default)
    assert spec_mod.DEFAULT_EMIT_CAPACITY == int(BY_NAME["FLUVIO_WINDOW_EMIT"].default)
    assert BY_NAME["FLUVIO_WINDOW_DELTA"].default == "1" and spec_mod.delta_enabled()
    assert WindowSpec.from_params("max_int", "1000", "250", True, delta_only=False) == WindowSpec(
        window_ms=1000, slide_ms=250, op="max", keyed=True, delta_only=False)
    for bad in ({"window_ms": 0}, {"window_ms": 100, "slide_ms": 30},
                {"window_ms": 10, "op": "mul"}):
        with pytest.raises(ValueError):
            WindowSpec(**bad)
    with pytest.raises(ValueError):
        WindowSpec.from_params("count", 1000)


# ---------------------------------------------------------------------------
# parse_two_ints
# ---------------------------------------------------------------------------

KEYED_DOCS = [
    b"3 17", b"0 0", b"12", b"", b" ", b"5 ", b" 5 9", b"  \t7 -8", b"-4 6", b"+9 +2", b"7 -",
    b"1  2", b"8\t9", b"2 x", b"x 3", b"63 999", b"9223372036854775807 -9223372036854775808",
    b"99999999999999999999 5", b"4 12345678901234567890", b"1 2 3", b"6  -  7", b"  ",
]


@pytest.mark.parametrize("width", [8, 64, 128])
def test_parse_two_ints_matches_jax(width):
    rng = np.random.default_rng(width)
    docs = [d[:width] for d in KEYED_DOCS]
    alphabet = np.frombuffer(b" \t+-0123456789x", dtype=np.uint8)
    for _ in range(200):
        picks = rng.integers(0, len(alphabet), int(rng.integers(0, width + 1)))
        docs.append(alphabet[picks].tobytes())
    values = np.zeros((len(docs), width), dtype=np.uint8)
    lengths = np.zeros(len(docs), dtype=np.int32)
    for i, d in enumerate(docs):
        values[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    got = parse_two_ints(torch.from_numpy(values), torch.from_numpy(lengths))
    want = ref_parse_two_ints(jnp.asarray(values), jnp.asarray(lengths))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# one update against WindowJits.update_arrays
# ---------------------------------------------------------------------------


def _edge_batch(geometry: str, rng):
    """Late rows (behind the warm batch's watermark 1,000), out-of-range
    keys, negative ts and contributions near the int64 limits, so add
    wraps."""
    keyed = GEOMETRIES[geometry].get("keyed", False)
    batch = []
    for i in range(40):
        key = int(rng.integers(0, 4)) if keyed else 0
        batch.append((key, int(rng.integers(-50, 100)), 900 + 5 * i))
    batch += [(0, INT64_MAX, 1010), (0, INT64_MAX, 1011), (0, INT64_MIN, 1020),
              (0, INT64_MIN + 1, 1020), (0, 1, 1020), (0, -1, 1030)]
    batch += [(0, 5, 10), (0, 6, 800), (0, 7, -250), (0, 8, -1)]  # late, negative ts
    batch += [(-1, 9, 1040), (1 << 31, 9, 1040), (INT64_MIN, 3, 1050), (INT64_MAX, 3, 2000)]
    if keyed:
        batch += [((1 << 31) - 1, 11, 1060), (2, INT64_MAX, 1070), (2, 5, 1070)]
    return batch


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_one_update_matches_update_arrays(geometry, op):
    ref_rt, port_rt = _pair(**GEOMETRIES[geometry], op=op, lateness_ms=20)
    rng = np.random.default_rng(len(geometry) * 7 + len(op))
    warm = [(int(rng.integers(0, 3)), int(rng.integers(-9, 9)), int(t))
            for t in np.sort(rng.integers(600, 1000, 30))] + [(0, 1, 1000)]
    _drive_both(ref_rt, port_rt, [warm])
    contribs, keys, ts, count = _padded(_edge_batch(geometry, rng))
    valid = np.arange(ROWS) < count
    want = ref_rt.jits.update_arrays(*ref_rt.bank.arrays(), jnp.asarray(contribs),
                                     jnp.asarray(keys), jnp.asarray(ts), jnp.asarray(valid))
    got = port_rt.ops.update_arrays(*port_rt.bank.arrays(), *(torch.from_numpy(a) for a in (
        contribs, keys, ts, valid)))
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
    header = got[0].tolist()
    assert header[3] > 0 and header[7] > 0, "late and invalid rows must occur"


@pytest.mark.parametrize("geometry", ["tumbling", "keyed"])
def test_empty_batch(geometry):
    ref_rt, port_rt = _pair(**GEOMETRIES[geometry])
    batches = [[(0, 4, 50), (1, 5, 70)], []]
    empty = (np.zeros(0, np.int64),) * 3
    _drive_both(ref_rt, port_rt, batches[:1])
    d_ref, d_port = ref_rt.ingest_arrays(*empty), port_rt.ingest_arrays(*empty)
    _assert_delta_equal(d_ref, d_port)
    assert port_rt.bank.snapshot() == ref_rt.bank.snapshot()
    assert d_port.records == 0


# ---------------------------------------------------------------------------
# multi-batch runs through WindowedRuntime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [101, 202])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_fuzz_every_batch_bit_equal(geometry, seed):
    kw = GEOMETRIES[geometry]
    slide = kw.get("slide_ms") or kw["window_ms"]
    ref_rt, port_rt = _pair(**kw, lateness_ms=slide)
    spec = port_rt.spec
    rng = np.random.default_rng(seed)
    batches = _gen_batches(rng, 5, int(rng.integers(40, ROWS)), 4 if spec.keyed else 1, step=8,
                           regress=kw["window_ms"] + 4 * slide, t0=-300)
    batches.insert(2, [])
    view, ref = MaterializedView(spec), HostWindowReference(spec)
    _drive_both(ref_rt, port_rt, batches, views=[view])
    for batch in batches:
        ref.process_batch(batch)
    assert port_rt.bank.snapshot() == ref.bank_entries()
    assert view.table() == ref.table()
    assert ref.late > 0 and ref.closed


def _buffer(values, ts, base_ts=-1):
    """The same staged records as a JAX-package and a port RecordBuffer."""
    ref_buf = _ref_buffer(values, ts=ts, base_ts=base_ts)
    return ref_buf, _port_buffer(ref_buf)


@pytest.mark.parametrize("keyed", [False, True])
def test_process_buffer_path(keyed):
    ref_rt, port_rt = _pair(window_ms=1000, slide_ms=250 if not keyed else 0, keyed=keyed)
    spec = port_rt.spec
    view, ref = MaterializedView(spec), HostWindowReference(spec)
    gen = gen_keyed_ints if keyed else gen_ints
    for k, n in enumerate((250, 140, 200)):  # one row bucket: one JAX compile
        values = gen(n, seed=k)
        if k == 1:
            values[2:4] = [b"  12 x", b"-3"]  # a leading blank, a sign, no space
        ts = (np.arange(n, dtype=np.int64) * 4 + 1200 * k).tolist()
        ref_buf, port_buf = _buffer(values, ts, base_ts=1_000_000 if k else -1)
        d_ref = ref_rt.process_buffer(ref_buf)
        d_port = port_rt.process_buffer(port_buf)
        _assert_delta_equal(d_ref, d_port)
        assert port_rt.bank.snapshot() == ref_rt.bank.snapshot()
        view.apply_delta(d_port)
        base = max(port_buf.base_timestamp, 0)
        rows = [(*((int(v.split(b" ")[0]), int(v.split(b" ")[1])) if keyed else (0, int(v))),
                 t + base) for v, t in zip(values, ts) if k != 1 or v not in (b"  12 x", b"-3")]
        if k == 1:  # the hand-made rows, as the kernels parse them ("int after the
            # first space": the leading blank's)
            rows += [((12, 12) if keyed else (0, 12)) + (ts[2] + base,),
                     ((-3, 0) if keyed else (0, -3)) + (ts[3] + base,)]
        ref.process_batch(rows)
    assert port_rt.bank.snapshot() == ref.bank_entries()
    assert view.table() == ref.table()
    assert port_rt.d2h_bytes_total == ref_rt.d2h_bytes_total


def test_dense_values_of_a_flat_backed_buffer_matches_jax():
    values = [b"12", b"", b"345 6", b"7" * 40]
    ref_buf, port_buf = _buffer(values, [0, 1, 2, 3])
    flat, starts = port_buf.ragged_values()
    port_flat = interop.buffer_from_reference(
        ref_buf.values, ref_buf.lengths, ref_buf.count, ref_buf.keys, ref_buf.key_lengths,
        ref_buf.offset_deltas, ref_buf.timestamp_deltas, 0, -1)
    port_flat.values, port_flat._flat, port_flat._starts = None, flat, starts
    port_flat._rows, port_flat._width = ref_buf.values.shape
    ref_flat = RefBuffer.from_arrays(ref_buf.values, ref_buf.lengths, count=ref_buf.count)
    ref_flat.ragged_values()
    ref_flat._rows, ref_flat._width = ref_buf.values.shape
    ref_flat.values = None
    np.testing.assert_array_equal(port_flat.dense_values(), ref_flat.dense_values())
    np.testing.assert_array_equal(port_flat.dense_values(), ref_buf.values)


# ---------------------------------------------------------------------------
# overflow, resync and error paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["emit-overflow", "emit-overflow-closes", "full-state",
                                  "full-state-closes"])
def test_resync_paths(case):
    kw = {"emit-overflow": dict(emit_capacity=8, lateness_ms=FOREVER),
          "emit-overflow-closes": dict(emit_capacity=32, lateness_ms=2000),
          "full-state": dict(delta_only=False, lateness_ms=FOREVER),
          "full-state-closes": dict(delta_only=False, lateness_ms=0)}[case]
    ref_rt, port_rt = _pair(**kw)
    spec = port_rt.spec
    if case.startswith("emit"):
        batches = [[(0, i + 1, i * 100) for i in range(40)], [(0, 5, 4000)]]
    else:
        batches = _gen_batches(np.random.default_rng(47), 4, 16, 1, step=14)
    view, ref = MaterializedView(spec), HostWindowReference(spec)
    deltas = _drive_both(ref_rt, port_rt, batches, views=[view])
    for batch in batches:
        ref.process_batch(batch)
    assert deltas[0].kind == "resync" and view.resyncs >= 1
    assert view.table() == ref.table()
    assert view.close_events == len(ref.closed)
    if case.endswith("closes"):
        assert ref.closed


@pytest.mark.parametrize("case", ["closed-overflow", "bank-capacity"])
def test_capacity_errors_leave_the_carry(case):
    if case == "closed-overflow":
        ref_rt, port_rt = _pair(emit_capacity=8, lateness_ms=0)
        first, wide = [(0, 1, 0)], [(0, i, i * 100) for i in range(40)]
    else:
        ref_rt, port_rt = _pair(capacity=4, emit_capacity=8, lateness_ms=FOREVER)
        first, wide = [(0, 1, 0), (0, 2, 150)], [(0, i, i * 100) for i in range(10)]
    _drive_both(ref_rt, port_rt, [first])
    before = port_rt.bank.snapshot()
    bank_tensors = [t.clone() for t in port_rt.bank.arrays()]
    args = _padded(wide)
    with pytest.raises(RefCapacityError):
        ref_rt.ingest_arrays(*args[:3], count=args[3])
    with pytest.raises(WindowCapacityError, match="emit" if case == "closed-overflow" else "bank"):
        port_rt.ingest_arrays(*args[:3], count=args[3])
    assert port_rt.bank.snapshot() == before == ref_rt.bank.snapshot()
    for t, was in zip(port_rt.bank.arrays(), bank_tensors):
        assert torch.equal(t, was)
    assert port_rt.batches == 1
    # the stream carries on from the untouched carry
    _drive_both(ref_rt, port_rt, [[(0, 3, 120)]])


def test_restore_rejects_oversized_snapshot_and_resync_rows():
    ref_rt, port_rt = _pair(capacity=64, lateness_ms=FOREVER)
    _drive_both(ref_rt, port_rt, [[(0, i, i * 100) for i in range(20)]])
    rows, wm = port_rt.resync_rows()
    ref_rows, ref_wm = ref_rt.resync_rows()
    np.testing.assert_array_equal(rows, ref_rows)
    assert rows.dtype == ref_rows.dtype and wm == ref_wm
    _ref_small, small = _pair(capacity=8)
    with pytest.raises(WindowCapacityError):
        small.bank.restore(*port_rt.bank.snapshot())


# ---------------------------------------------------------------------------
# bank merges
# ---------------------------------------------------------------------------


def test_merge_banks_equals_serial_ingest_and_the_jax_merge():
    fields = _fields(keyed=True, lateness_ms=FOREVER)
    ref_spec, spec = RefSpec(**fields), WindowSpec(**fields)
    jits, ops = _jits(ref_spec), WindowEagerOps(spec)
    rng = np.random.default_rng(29)
    records = [r for batch in _gen_batches(rng, 3, 20, 6, step=7) for r in batch]
    parts = [records[0::3], records[1::3], records[2::3]]
    shards, ref_shards = [], []
    for part in parts:
        ref_rt = RefRuntime(ref_spec, jits=jits)
        rt = WindowedRuntime(spec, device="cpu", ops=ops)
        _drive_both(ref_rt, rt, [part])
        shards.append(rt.bank)
        ref_shards.append(ref_rt.bank)
    serial = WindowedRuntime(spec, device="cpu", ops=ops)
    serial.ingest_arrays(*_padded(records, rows=len(records))[:3])
    left = merge_banks(ops, merge_banks(ops, shards[0], shards[1]), shards[2])
    right = merge_banks(ops, shards[0], merge_banks(ops, shards[1], shards[2]))
    ref_left = ref_merge_banks(jits, ref_merge_banks(jits, ref_shards[0], ref_shards[1]),
                               ref_shards[2])
    assert left.snapshot() == right.snapshot() == serial.bank.snapshot() == ref_left.snapshot()
    assert left.state_bytes() == ref_left.state_bytes()
    small = WindowedRuntime(WindowSpec(**{**fields, "capacity": 4}), device="cpu")
    with pytest.raises(WindowCapacityError):
        merge_banks(WindowEagerOps(small.spec), small.bank, shards[0])


# ---------------------------------------------------------------------------
# partitioned runtime, carry across, the classic chain
# ---------------------------------------------------------------------------


class _DictReplica:
    """The replica contract the partitioned runtime needs: publish and latest."""

    def __init__(self):
        self.entries = {}

    def publish(self, key, offset, carries, inst_state=None):
        self.entries[key] = (offset, list(carries), list(inst_state or ()))

    def latest(self, key):
        return self.entries[key]


def test_partitioned_seed_and_migrate():
    fields = _fields(keyed=True)
    ref_spec, spec = RefSpec(**fields), WindowSpec(**fields)
    rng = np.random.default_rng(41)
    batches = _gen_batches(rng, 4, 20, 4, step=12)
    replicas = (_DictReplica(), _DictReplica())
    ref_a = RefPartitioned(ref_spec, replica=replicas[0], jits=_jits(ref_spec))
    port_a = PartitionedWindowRuntime(spec, replica=replicas[1], device="cpu")

    def feed(ref_p, port_p, batch):
        vals = [f"{k} {c}".encode() for k, c, _ in batch]
        ref_buf, port_buf = _buffer(vals, [t for _, _, t in batch])
        d_ref = ref_p.process_buffer("t", 0, ref_buf)
        d_port = port_p.process_buffer("t", 0, port_buf)
        _assert_delta_equal(d_ref, d_port)
        return d_port

    for batch in batches[:2]:
        feed(ref_a, port_a, batch)
    assert replicas[1].entries == replicas[0].entries
    # promotion: fresh runtimes seed from the last committed snapshot
    ref_b = RefPartitioned(ref_spec, replica=replicas[0], jits=_jits(ref_spec))
    port_b = PartitionedWindowRuntime(spec, replica=replicas[1], device="cpu")
    assert port_b.seed("t", 0) == ref_b.seed("t", 0) == 40
    assert port_b.snapshot("t", 0) == port_a.snapshot("t", 0) == ref_b.snapshot("t", 0)
    port_b.migrate("t", 0, "cpu")
    assert port_b.runtime("t", 0).bank.device == torch.device("cpu")
    ref = HostWindowReference(spec)
    for batch in batches[:2]:
        ref.process_batch(batch)
    for batch in batches[2:]:
        feed(ref_b, port_b, batch)
        ref.process_batch(batch)
    assert port_b.snapshot("t", 0) == ref.bank_entries()
    assert port_b.state_bytes() == ref_b.state_bytes()
    assert port_b.snapshot("t", 1) == ([], None)
    with pytest.raises(RuntimeError):
        PartitionedWindowRuntime(spec, device="cpu").seed("t", 0)


@pytest.mark.parametrize("geometry", ["sliding", "keyed"])
def test_carry_across_from_the_jax_engine(geometry):
    kw = GEOMETRIES[geometry]
    ref_rt, _ = _pair(**kw, lateness_ms=15)
    rng = np.random.default_rng(61)
    batches = _gen_batches(rng, 5, 30, 3 if kw.get("keyed") else 1, step=9, regress=60)
    for batch in batches[:3]:
        ref_rt.ingest_arrays(*_padded(batch)[:3], count=len(batch))
    s = ref_rt.spec
    spec = interop.window_spec_from_reference(
        s.window_ms, s.slide_ms, s.op, s.keyed, s.lateness_ms, s.capacity, s.emit_capacity,
        s.delta_only)
    assert spec.__dict__ == s.__dict__
    entries, wm = ref_rt.bank.snapshot()
    port_rt = WindowedRuntime(spec, device="cpu")
    port_rt.bank = interop.window_bank_from_reference(entries, wm, spec, "cpu")
    assert port_rt.bank.snapshot() == (entries, wm) and entries
    _drive_both(ref_rt, port_rt, batches[3:])


def test_windowed_sum_classic_chain():
    """The `5_windowed` classic arm's module through both SmartEngines:
    running sums that restart at each 1,000 ms window, keyed by its start."""
    bufs = []
    for k, n in enumerate((200, 130, 250)):  # one row bucket: one JAX compile
        values = gen_ints(n, seed=k)
        bufs.append(_ref_buffer(values, ts=(np.arange(n) * 4).tolist(),
                                base_ts=1_000_000 + 2400 * k))
    chain, outs = run_both([("windowed-sum", {"kind": "sum_int", "window_ms": "1000"})], bufs)
    assert outs[2].key_list()[0] == b"1004000" and outs[2].key_list()[-1] == b"1005000"
    run_both([("windowed-sum", {"kind": "max_int", "window_ms": "250"})], bufs[:2])


# ---------------------------------------------------------------------------
# the reference's aliasing fault, the device rule
# ---------------------------------------------------------------------------


def test_composite_id_aliasing_fault_follows_the_reference():
    """Past 2^31 windows the composite id ``key * 2^31 + win_idx`` aliases:
    key 0's window 2^31 lands on key 1's window 0 (ROADMAP.md §3). Both
    engines give the same bank entry and view. The lateness keeps window 0
    open past the second record's watermark."""
    batch = [(1, 5, 0), (0, 7, (1 << 31) * 250)]
    ref_rt, port_rt = _pair(window_ms=250, keyed=True, lateness_ms=1 << 40)
    d_port = _drive_both(ref_rt, port_rt, [batch])[0]
    assert port_rt.bank.snapshot()[0] == [(2147483648, 12, 2)]
    view = MaterializedView(port_rt.spec)
    view.apply_delta(d_port)
    assert view.table() == {(1, 0): (12, 2, "open")}
    ref, port_ref = RefReference(ref_rt.spec), HostWindowReference(port_rt.spec)
    assert port_ref.process_batch(batch) == ref.process_batch(batch)
    assert port_ref.bank_entries() == ref.bank_entries() == port_rt.bank.snapshot()
    assert port_ref.table() == ref.table() == view.table()


def test_device_less_runtimes_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = WindowSpec(**_fields())
    for make in (lambda: WindowedRuntime(spec), lambda: PartitionedWindowRuntime(spec),
                 lambda: WindowedRuntime(spec, device="cuda"),
                 lambda: WindowedRuntime.from_params("sum_int", 1000)):
        with pytest.raises(EngineError):
            make()
    assert WindowedRuntime(spec, device="cpu").bank.device == torch.device("cpu")
