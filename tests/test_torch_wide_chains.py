"""Wide records through the chains the JAX package spills to its
interpreter: the port's striped JSON-array explode, word count, JsonGet
contribution and aggregate after a span map, on the CPU, tolerance 0.

The JAX package has no striped lowering for these chains: a batch wider
than its stripe threshold raises ``TpuSpill`` inside its engine, which
reruns the batch in its interpreter. That rerun is the reference. Both
sides run at small stripes (64 bytes overlapping by 16 above a 64-byte
threshold: the JAX side through ``FLUVIO_STRIPE_*``, the port through
``StripeParams(64, 64, 16)``), so records of a few hundred bytes span
several stripes and the seam edges land where each case puts them: a row
OWNS its first 48 bytes (the last one at column 47), the overlap tail
belongs to the next row. Both engines get the same inputs through their
chain instance's ``process``; outputs (value, key, offset and timestamp
deltas), the first error (hint, offset, kind, key, value) and the
aggregate carries must be equal. Inputs are fixed bytes or made with numpy
from fixed seeds. The port's kernel wrappers run their plain torch
versions here, since the tensors lie on the CPU; the CUDA kernel's walk is
modelled in Python below and held to the plain version's grid.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.ops.regex_dfa import compile_regex as ref_compile_regex
from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu.smartmodule import types as ref_types
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol import record
from fluvio_tpu_torch.smartengine import GpuSpill, SmartEngine, SmartModuleConfig, StripeParams
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels, stripes
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer, _next_pow2
from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartmodule.types import SmartModuleInput
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_chain import _module_pair
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_torch_striped_slice import KEY_REWRITE
from tests.test_torch_stripes import PARAMS, S, V, small_stripes  # noqa: F401

STEP = S - V  # a row owns 48 bytes: the last owned byte of row j is 48 j + 47
LAST0, LAST1 = STEP - 1, 2 * STEP - 1
EXPLODE = [("array-map-json", {})]
FILTER_EXPLODE = [("regex-filter", {"regex": "flu[vV]io"}), ("array-map-json", {})]


# ---------------------------------------------------------------------------
# the two engines
# ---------------------------------------------------------------------------


def _chains(specs):
    """specs: [(registry name | (kind, build), params[, initial_data])] ->
    (JAX chain instance, port chain instance). The JAX chain must have no
    striped lowering (its wide batches go to the interpreter), the port's
    one."""
    rb = RefEngine(backend="tpu").builder()
    pb = SmartEngine(device="cpu", stripes=PARAMS).builder()
    for spec, params, *initial in specs:
        init = initial[0] if initial else b""
        ref_m, port_m = (ref_lookup(spec), lookup(spec)) if isinstance(spec, str) else \
            _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(params), initial_data=init), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(params), initial_data=init), port_m)
    ref, port = rb.initialize(), pb.initialize()
    assert ref.backend_in_use == "tpu" and port.backend_in_use == "gpu"
    assert ref.tpu_chain._striped_chain() is None, "the JAX engine lowered it striped"
    assert port.gpu_chain._striped_chain() is not None
    return ref, port


def _inputs(values, keys=None, ts=None, base_offset=0, base_ts=-1):
    def recs(cls):
        return [cls(value=v, key=None if keys is None else keys[i], offset_delta=i,
                    timestamp_delta=0 if ts is None else ts[i]) for i, v in enumerate(values)]

    return (ref_types.SmartModuleInput.from_records(recs(ref_record.Record),
                                                    base_offset=base_offset,
                                                    base_timestamp=base_ts),
            SmartModuleInput.from_records(recs(record.Record), base_offset=base_offset,
                                          base_timestamp=base_ts))


def _same(ref_out, port_out):
    got = [(r.value, r.key, r.offset_delta, r.timestamp_delta) for r in port_out.successes]
    assert got == [(r.value, r.key, r.offset_delta, r.timestamp_delta)
                   for r in ref_out.successes]
    assert (port_out.error is None) == (ref_out.error is None)
    if ref_out.error is not None:
        e, w = port_out.error, ref_out.error
        assert (e.hint, e.offset, e.kind.value, e.record_key, e.record_value) == (
            w.hint, w.offset, w.kind.value, w.record_key, w.record_value)


def _run(specs, batches):
    """Every batch through both engines, in order: equal outputs, errors
    and carries. ``batches``: dicts of `_inputs` arguments."""
    ref, port = _chains(specs)
    outs = []
    for b in batches:
        ref_in, port_in = _inputs(**b)
        ref_out, port_out = ref.process(ref_in), port.process(port_in)
        _same(ref_out, port_out)
        outs.append(port_out)
    ref.tpu_chain._ensure_host_state()
    port.gpu_chain._ensure_host_state()
    assert port.gpu_chain.carries == ref.tpu_chain.carries
    assert any(max(len(v) for v in b["values"]) > PARAMS.threshold for b in batches)
    return port, outs


def _keys(n):
    return [None if i % 3 == 0 else b"k%d" % i for i in range(n)]


# ---------------------------------------------------------------------------
# JSON-array explode: seam edges, each a case
# ---------------------------------------------------------------------------


def _at(pos: int, head: bytes, fill: bytes = b" ") -> bytes:
    """``head`` padded with ``fill`` so that the next byte lands at ``pos``."""
    return head + fill * (pos - len(head))


ELEMENT = b'"' + b"e" * 150 + b'"'
TAIL = b',{"k":[1,2,{"z":"]"}],"s":"a,b"},"x\\"y",  42  ,[[]],' + ELEMENT + b"]"

EXPLODE_CASES = {
    # a quote on the last owned byte of a row: the string opens across the seam
    "quote_on_seam": [_at(LAST0, b"[1,2,") + b'"a,[b]' + b"c" * 60 + b'"' + TAIL,
                      _at(LAST1, b"[") + b'"q"' + TAIL],
    # an escape backslash on the last owned byte: it skips the seam's first byte
    "escape_on_seam": [_at(LAST0, b'["', b"s") + b'\\"' + b'still,inside"' + TAIL,
                       _at(LAST1, b'[7,"', b"t") + b'\\\\",8' + TAIL],
    # an opening bracket or brace on the last owned byte
    "bracket_on_seam": [_at(LAST0, b"[3,") + b"[1,[2,3],4]" + TAIL,
                        _at(LAST1, b"[4,") + b'{"a":[1,2],"b":"}"}' + TAIL],
    # a depth-0 comma on the last owned byte, and a nested one
    "comma_on_seam": [_at(LAST0 - 1, b"[") + b"1," + b"2" + TAIL,
                      _at(LAST1, b"[[1", b"0") + b",2]" + TAIL],
    # an element wider than a stripe, first, last and alone
    "element_past_a_stripe": [b"[" + b"9" * 200 + b"]", b"[" + ELEMENT + b"," + b"7" * 90 + b"]",
                              b'[{"deep":"' + b"d" * 130 + b'"}]'],
    # a fully quoted element across a seam, and one quoted at one end only
    "quoted_across_seam": [_at(LAST0 - 4, b"[5,") + b'"straddles the seam",' + TAIL,
                           _at(LAST0 - 2, b"[6,") + b'"half' + b"h" * 60 + b" x" + TAIL],
    # outer whitespace longer than a stripe on both sides, and inside
    "outer_whitespace": [b" \t" * 40 + b"[1, 2]" + b"\n\x0b\x0c\r " * 20,
                         b"[" + b" " * 80 + b"1" + b" " * 70 + b"," + b"\t" * 60 + b"2]"],
    # empty arrays and empty elements in a wide batch
    "empty_elements": [b"[]", b"[,]", b"[ , 1 ]", b" [ ] ", b"[,,,]", b'["",""]',
                       b"[" + b" ," * 60 + b"]"],
    # records that are no JSON array end the batch at the first of them
    "not_an_array_mid_batch": [TAIL[1:].join([b"[", b""]), b'{"no":' + b"1" * 80 + b"}",
                               b"[1]", b"no json"],
    "unterminated_and_unbalanced": [b'["open' + b"o" * 80 + b"]", b"[" + b"}" * 70 + b",1]",
                                    b"[" + b"[" * 70 + b",1]", b'["\\' + b"]"],
}


@pytest.mark.parametrize("case", sorted(EXPLODE_CASES))
def test_explode_seam_edges(small_stripes, case):
    """The seam case, then a narrow batch; a wide record pads the batch
    where the case's records are all narrow."""
    docs = EXPLODE_CASES[case]
    if max(len(d) for d in docs) <= PARAMS.threshold:
        docs = docs + [b"[" + ELEMENT + b"]"]
    _run(EXPLODE, [dict(values=docs, keys=_keys(len(docs)), base_offset=10),
                   dict(values=[b"[1,2]", b"[3]"], base_offset=20)])


def _random_arrays(rng, n: int):
    """JSON arrays of 0-30 elements: numbers, strings holding , [ ] } and
    escaped quotes, nested arrays and objects, runs of whitespace; one in
    ten is garbage from the same alphabet."""
    parts = [b"1", b"-22", b'"a,b"', b'"[x]"', b'"q\\"r"', b'"\\\\"', b"[1,[2,[3]]]",
             b'{"k":"}","v":[1,2]}', b"true", b'""', b" ", b"\t\x0b", b"null"]
    out = []
    for i in range(n):
        els = [parts[j] for j in rng.integers(0, len(parts), size=int(rng.integers(0, 30)))]
        body = b",".join(b" " * int(rng.integers(0, 4)) + e for e in els)
        doc = b" " * int(rng.integers(0, 3)) + b"[" + body + b"]"
        if i % 10 == 9:
            alphabet = np.frombuffer(b'[]{}",\\ \t1a', dtype=np.uint8)
            doc = alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(0, 200)))].tobytes()
        out.append(doc)
    return out


def test_explode_random_arrays_across_batches(small_stripes):
    rng = np.random.default_rng(41)
    batches = []
    for k in range(3):
        docs = [d for d in _random_arrays(rng, 40) if ref_dsl.json_array_elements(d) is not None]
        batches.append(dict(values=docs, keys=_keys(len(docs)), base_offset=100 * k))
    port, outs = _run(EXPLODE, batches)
    assert outs[0].error is None and len(outs[0].successes) > 100
    assert port.gpu_chain._striped.fanout_json


def test_filter_then_explode_first_error(small_stripes):
    """A filter ahead of the explode: a record that is no JSON array and
    fails the filter raises nothing; the first surviving one ends the
    batch, the elements of the survivors before it delivered."""
    docs = [b'["fluvio",' + b"1," * 40 + b"2]", b'{"kafka":' + b"0" * 70 + b"}",
            b'["fluVio",' + ELEMENT + b"]", b'["kafka",' + b"3," * 40 + b"4]",
            b'{"fluvio":' + b"5" * 70 + b"}", b'["fluvio",6]']
    port, outs = _run(FILTER_EXPLODE, [dict(values=docs, keys=_keys(len(docs)), base_offset=7)])
    assert outs[0].error.record_value == docs[4]


def test_first_error_after_an_overflow(small_stripes):
    """A batch whose elements overflow the learned capacity and that holds
    a record that is no JSON array: the fan-out runs again at the larger
    capacity, then the error's run at that capacity."""
    docs = [b"[" + b"1," * 80 + b"2]"] * 40 + [b"x" * 70] + [b"[1]"]
    port, outs = _run(EXPLODE, [dict(values=docs, base_offset=3)])
    assert port.gpu_chain.redispatches == 1 and outs[0].error is not None


# ---------------------------------------------------------------------------
# the element grid itself
# ---------------------------------------------------------------------------


def _stage(docs):
    buf = RecordBuffer.from_values(docs)
    flat, _ = buf.ragged_values()
    flat = torch.from_numpy(np.ascontiguousarray(flat).view(np.int32))
    lengths = torch.from_numpy(buf.lengths.copy())
    srows = _next_pow2(stripes.plan_rows(buf.lengths, buf.count, S, V), 8)
    plan, sv, _ = stripes.stage_rows(flat, lengths, buf.lengths, buf.count, PARAMS, srows)
    return plan, sv


def _grid_docs():
    rng = np.random.default_rng(42)
    docs = [d for case in sorted(EXPLODE_CASES) for d in EXPLODE_CASES[case]]
    return docs + _random_arrays(rng, 200) + [b""]


CSRC = Path(stripes.__file__).resolve().parent / "csrc"


def _source_constant(name: str) -> int:
    text = (CSRC / "json_array.cu").read_text(encoding="utf-8")
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _str_next(st: int, b: int) -> int:
    if b == 0x22:
        return 0 if st == 1 else 1
    if b == 0x5C:
        return 2 if st == 1 else (1 if st == 2 else 0)
    return 1 if st == 2 else st


def _depth_step(b: int) -> int:
    return 1 if b in (0x5B, 0x7B) else (-1 if b in (0x5D, 0x7D) else 0)


def _compose(a, b):
    """Walks (exit state and depth change from each entry state 0-2),
    ``a`` then ``b``."""
    return (tuple(b[0][x] for x in a[0]), tuple(a[1][e] + b[1][a[0][e]] for e in range(3)))


def _combine(a, b):
    """Marks (boundary seen, first element byte after it, last element
    byte), ``a`` then ``b``."""
    return (a[0] | b[0], b[1] if b[0] else (a[1] if a[1] >= 0 else b[1]),
            b[2] if b[2] >= 0 else a[2])


def _warp_scan(items, op, identity, warp: int):
    """Exclusive prefixes within each warp (a Hillis-Steele shuffle scan)
    and each warp's total."""
    ex, totals = [], []
    for w0 in range(0, len(items), warp):
        inc = list(items[w0:w0 + warp])
        off = 1
        while off < warp:
            inc = [op(inc[i - off], inc[i]) if i >= off else inc[i] for i in range(len(inc))]
            off <<= 1
        ex += [identity] + inc[:-1]
        totals.append(inc[-1])
    return ex, totals


def _block_model(sv, owned, first_row, k, step, threads: int, chunk: int, warp: int = 32):
    """``csrc/json_array.cu``'s block walk in Python: a block a segment,
    tiles of ``threads * chunk`` bytes of a row, ``chunk`` bytes a lane;
    the outer ends by tile reductions, then per tile the lanes' string
    maps scanned by warp and folded over the warps from the carry, the
    boundary and element marks from each lane's exact entry state,
    scanned the same way, and the elements written at their boundaries."""
    sv, owned, first_row, k = (t.numpy() for t in (sv, owned, first_row, k))
    r, s = sv.shape
    tile = threads * chunk
    ident_walk, ident_marks = ((0, 1, 2), (0, 0, 0)), (0, -1, -1)
    flag = np.zeros((r, s), dtype=bool)
    start = np.zeros((r, s), dtype=np.int32)
    elen = np.zeros((r, s), dtype=np.int32)
    err = np.zeros(len(k), dtype=bool)

    def flat(seg, pos):
        j = min(pos // step, k[seg] - 1)
        return first_row[seg] + j, pos - j * step

    def tiles(seg, j):
        own = int(owned[first_row[seg] + j])
        return [(t0, own) for t0 in range(0, own, tile)]

    def lanes(seg, j, t0, own):
        """Each lane's (position, byte) pairs of the tile's owned bytes."""
        row = sv[first_row[seg] + j]
        return [[(j * step + c, int(row[c])) for c in range(t0 + i * chunk, t0 + (i + 1) * chunk)
                 if c < own] for i in range(threads)]

    for seg in range(len(k)):
        if k[seg] <= 0:
            continue
        fa = fb = -1
        for j in range(k[seg]):
            for t0, own in tiles(seg, j):
                hits = [p for lane in lanes(seg, j, t0, own) for p, b in lane
                        if not (9 <= b <= 13 or b == 32)]
                if hits and fa < 0:
                    fa = min(hits)
            if fa >= 0:
                break
        for j in reversed(range(k[seg]) if fa >= 0 else []):
            for t0, own in reversed(tiles(seg, j)):
                hits = [p for lane in lanes(seg, j, t0, own) for p, b in lane
                        if not (9 <= b <= 13 or b == 32)]
                if hits and fb < 0:
                    fb = max(hits)
            if fb >= 0:
                break
        ok = fa >= 0 and fb > fa and sv[flat(seg, fa)] == 0x5B and sv[flat(seg, fb)] == 0x5D
        err[seg] = not ok
        if not ok:
            continue
        st_c, dp_c, f_c, l_c = 0, 0, -1, -1
        for j in range(min((fa + 1) // step, k[seg] - 1), k[seg]):
            stop = False
            for t0, own in tiles(seg, j):
                if j * step + t0 > fb:
                    stop = True
                    break
                body = [[(p, b) for p, b in lane if fa < p <= fb]
                        for lane in lanes(seg, j, t0, own)]
                # 1. maps
                walks = []
                for lane in body:
                    m, d = [0, 1, 2], [0, 0, 0]
                    for p, b in lane:
                        if p < fb:
                            for e in range(3):
                                d[e] += _depth_step(b) if m[e] == 0 else 0
                                m[e] = _str_next(m[e], b)
                    walks.append((tuple(m), tuple(d)))
                w_ex, w_tot = _warp_scan(walks, _compose, ident_walk, warp)
                entry = []
                for q, tot in enumerate(w_tot):
                    entry.append((st_c, dp_c))
                    st_c, dp_c = tot[0][st_c], dp_c + tot[1][st_c]
                # 2. marks
                lane_marks, events = [], []
                for i, lane in enumerate(body):
                    st, dp = entry[i // warp]
                    ex = w_ex[i]
                    st, dp = ex[0][st], dp + ex[1][st]
                    mk, ev = ident_marks, []
                    for p, b in lane:
                        element = False
                        boundary = p == fb
                        if not boundary:
                            boundary = st == 0 and b == 0x2C and dp == 0
                            dp += _depth_step(b) if st == 0 else 0
                            st = _str_next(st, b)
                            element = not boundary and not (9 <= b <= 13 or b == 32)
                        if boundary:
                            mk = (1, -1, mk[2])
                            ev.append(None)
                        elif element:
                            code = (p << 1) | int(b == 0x22)
                            mk = (mk[0], mk[1] if mk[1] >= 0 else code, code)
                            ev.append(code)
                    lane_marks.append(mk)
                    events.append(ev)
                # 3. trimming
                m_ex, m_tot = _warp_scan(lane_marks, _combine, ident_marks, warp)
                pre, c = [], (1, f_c, l_c)
                for tot in m_tot:
                    pre.append(c)
                    c = _combine(c, tot)
                f_c, l_c = c[1], c[2]
                for i, ev in enumerate(events):
                    _, f, l = _combine(pre[i // warp], m_ex[i])
                    for code in ev:
                        if code is not None:
                            f, l = (code if f < 0 else f), code
                            continue
                        if f >= 0:
                            q = int((f & 1) and (l & 1) and (l >> 1) > (f >> 1))
                            st0, ln = (f >> 1) + q, (l >> 1) - (f >> 1) + 1 - 2 * q
                            if ln > 0:
                                row, col = flat(seg, st0)
                                flag[row, col], start[row, col], elen[row, col] = True, st0, ln
                        f = -1
            if stop:
                break
    return flag, start, elen, err


BLOCK_GEOMETRIES = {
    "kernel": lambda: (_source_constant("kThreads"), _source_constant("kChunk"), 32),
    # many tiles a row, lanes and warps a tile at the 64-byte test stripes
    "small": lambda: (8, 4, 4),
}


@pytest.mark.parametrize("geometry", sorted(BLOCK_GEOMETRIES))
def test_json_array_bounds_match_the_interpreter_and_the_kernel_walk(geometry):
    """`stripes.striped_json_array_bounds` (through its wrapper, on the
    CPU) against `dsl.json_array_elements` record by record, and cell for
    cell against the kernel's block walk, at the kernel's own block (its
    constants read from the source) and at a small one whose tiles, lanes
    and warps split the 64-byte rows."""
    docs = _grid_docs()
    plan, sv = _stage(docs)
    args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], plan["step"])
    got = cuda_kernels.json_array_striped(*args)
    model = _block_model(*args, *BLOCK_GEOMETRIES[geometry]())
    for name, g, w in zip(("flag", "start", "elen", "err"), got, model):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    flag, st, ln, err = (t.numpy() for t in got)
    seg = plan["seg"].numpy()
    elems = [[] for _ in docs]
    for r, c in zip(*np.nonzero(flag)):
        elems[seg[r]].append(docs[seg[r]][st[r, c]:st[r, c] + ln[r, c]])
    for i, d in enumerate(docs):
        want = dsl.json_array_elements(d)
        assert want == ref_dsl.json_array_elements(d)
        assert bool(err[i]) == (want is None), d
        assert elems[i] == (want or []), d
    assert cuda_kernels.LAUNCHES["json_array_striped"] == 0  # plain versions count nothing


# ---------------------------------------------------------------------------
# byte-range contributions
# ---------------------------------------------------------------------------

WORD_CASES = {
    "word_past_a_stripe": [b"w" * 150 + b" a b", b"x " + b"y" * 120],
    "whitespace_past_a_stripe": [b"a" + b" " * 100 + b"b", b" " * 130 + b"c d" + b"\n" * 70],
    "vt_ff_between_words": [b"a\x0bb\x0cc\td\re\nf " * 12, b"\x0b\x0c" * 40 + b"z"],
    "word_across_seam": [_at(LAST0, b"a") + b"bcdef" + b" g" * 30,
                         _at(LAST1 - 1, b"", b"q") + b" r" + b" s" * 20],
    "empty_and_blank": [b"", b" ", b"\t" * 90],
}


@pytest.mark.parametrize("case", sorted(WORD_CASES))
def test_word_count_seam_edges(small_stripes, case):
    docs = WORD_CASES[case] + [b"tail words " * 8]
    _run([("word-count", {}, b"3")], [dict(values=[b"one two", b"three"]),
                                      dict(values=docs, keys=_keys(len(docs)), base_offset=5),
                                      dict(values=[b"a b c"])])


def _fields(rng, n: int):
    """Records with the "n" field at every offset around the seams: plain
    integers, signed ones, digit runs longer than a stripe (leading
    zeros), strings with whitespace runs before the digits, missing and
    non-numeric fields."""
    out = []
    for i in range(n):
        num = int(rng.integers(-10**6, 10**6))
        val = [b"%d" % num, b"+%d" % abs(num), b"0" * 90 + b"%d" % abs(num),
               b'"' + b" " * 70 + b"\t%d\"" % num, b'"x%d"' % num, b"- 5"][i % 6]
        pad = b"p" * int(rng.integers(0, 150))
        doc = b'{"pad":"' + pad + b'","n":' + val + b',"z":1}'
        out.append(doc if i % 13 else b'{"pad":"' + pad + b'"}')
    return out


@pytest.mark.parametrize("combine", ["add", "max", "min"])
@pytest.mark.parametrize("window", [0, 100])
def test_aggregate_field(small_stripes, combine, window):
    rng = np.random.default_rng(43 + window)
    params = {"field": "n", "combine": combine, "window_ms": str(window)}
    batches = []
    for k, n in enumerate((30, 8, 25)):
        docs = _fields(rng, n) if k != 1 else [b'{"n":%d}' % i for i in range(n)]
        batches.append(dict(values=docs, keys=_keys(n), ts=[7 * i for i in range(n)],
                            base_offset=50 * k, base_ts=1000 + 90 * k))
    _run([("aggregate-field", params, b"" if window else b"11")], batches)


def _field_at(pos: int, value: bytes) -> bytes:
    """A record whose "n" value starts at byte ``pos``, padded past a stripe."""
    head = b'{"p":"'
    pad = pos - len(head) - len(b'","n":')
    return head + b"q" * pad + b'","n":' + value + b',"z":"' + b"t" * 70 + b'"}'


FIELD_CASES = {
    "digit_run_past_a_stripe": [_field_at(10, b"0" * 150 + b"42"),
                                _field_at(LAST0 - 3, b"-" + b"0" * 100 + b"7")],
    "whitespace_before_digits_past_a_stripe": [_field_at(20, b'"' + b" \t" * 40 + b'\r 31"'),
                                               _field_at(30, b'"' + b" " * 90 + b'-8x"')],
    "digits_across_seam": [_field_at(LAST0 - 2, b"123456789"), _field_at(LAST1, b"98765")],
    "sign_on_seam": [_field_at(LAST0, b"-55"), _field_at(LAST0, b"+66"),
                     _field_at(LAST0, b'"- 5"')],
}


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_aggregate_field_seam_edges(small_stripes, case):
    docs = FIELD_CASES[case]
    _run([("aggregate-field", {"field": "n"}, b"4")],
         [dict(values=docs, keys=_keys(len(docs)), base_offset=3), dict(values=[b'{"n":2}'])])


def test_filter_then_aggregate_field(small_stripes):
    docs = [b'{"name":"fluvio","n":%d,"p":"%s"}' % (i, b"q" * (20 * i)) for i in range(12)]
    docs += [b'{"name":"kafka","n":1000,"p":"%s"}' % (b"q" * 90)]
    _run([("regex-filter", {"regex": "flu[vV]io"}),
          ("aggregate-field", {"field": "n", "combine": "max"})], [dict(values=docs)])


SPAN_AGGREGATES = ["aggregate-sum", "aggregate-max", "aggregate-min", "aggregate-count",
                   "word-count"]


@pytest.mark.parametrize("name", SPAN_AGGREGATES)
def test_aggregate_after_a_span_map(small_stripes, name):
    """``json-map`` then an aggregate: the contribution reads the field's
    bytes, which cross seams, sit past the first stripe or are missing."""
    rng = np.random.default_rng(44)
    docs = []
    for i in range(30):
        pad = b"p" * int(rng.integers(0, 160))
        val = [b'"%d apples and  pears"' % (i * 37 - 400), b'" \t %d"' % i, b"%d" % (i - 9),
               b'"' + b"w " * 40 + b'"', b'"' + b"0" * 80 + b'7"'][i % 5]
        docs.append(b'{"pad":"' + pad + b'","name":' + val + b"}" if i % 11 else
                    b'{"pad":"' + pad + b'"}')
    _run([("json-map", {"field": "name"}), (name, {})],
         [dict(values=docs, keys=_keys(len(docs)), base_offset=9),
          dict(values=[b'{"name":"3 4"}', b'{"name":5}'])])


def test_range_contributions_match_the_interpreter():
    """`striped_count_words` and `striped_parse_int` over whole records and
    over sub-ranges against ``bytes.split()`` and `dsl.parse_int_prefix`
    (wrapped to int64)."""
    rng = np.random.default_rng(45)
    alphabet = np.frombuffer(b" \t\n\r\x0b\x0c+-0123456789ab", dtype=np.uint8)
    docs = [alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(0, 300)))].tobytes()
            for _ in range(120)]
    docs += [b" " * 100 + b"-" + b"0" * 70 + b"42", b"9" * 19, b"+", b""]
    plan, sv = _stage(docs)
    n = plan["k"].shape[0]  # the batch's rows, padded past the records
    pad = [0] * (n - len(docs))
    lengths = torch.tensor([len(d) for d in docs] + pad, dtype=torch.int32)
    lo = torch.tensor([int(rng.integers(0, len(d) + 1)) for d in docs] + pad, dtype=torch.int32)
    hi = torch.minimum(lo + torch.tensor(rng.integers(0, 200, size=n), dtype=torch.int32),
                       lengths)
    for a, b in ((torch.zeros_like(lengths), lengths), (lo, hi)):
        words = stripes.striped_count_words(sv, plan, a, b, n).tolist()
        ints = stripes.striped_parse_int(sv, plan, a, b, n).tolist()
        for i, d in enumerate(docs):
            part = d[int(a[i]): int(b[i])]
            assert words[i] == len(part.split()), part
            # the narrow path's int64 wrap (`test_digit_run_past_int64_...`)
            assert ints[i] == (dsl.parse_int_prefix(part) + 2**63) % 2**64 - 2**63, part


def test_digit_run_past_int64_follows_the_narrow_rule(small_stripes):
    """Reference fault: a digit run past int64 wraps on the port, as on its
    narrow path and the JAX package's; the interpreter that serves the JAX
    package's wide batch keeps Python's unbounded int. Smallest input:
    2**63, nineteen digits."""
    wide = b'{"pad":"' + b"p" * 80 + b'","n":9223372036854775808}'
    ref, port = _chains([("aggregate-field", {"field": "n"})])
    ref_in, port_in = _inputs([wide])
    assert [r.value for r in ref.process(ref_in).successes] == [b"9223372036854775808"]
    assert [r.value for r in port.process(port_in).successes] == [b"-9223372036854775808"]


# ---------------------------------------------------------------------------
# what raised until the striped lowering took it: a key rewrite, a regex past
# the JAX package's DFA gate
# ---------------------------------------------------------------------------

NOW_STRIPED = {
    "key-rewrite": [KEY_REWRITE],
    "regex-past-the-gate": [("regex-filter", {"regex": "(a|b)*a(a|b){6}"})],
}


@pytest.mark.parametrize("name", sorted(NOW_STRIPED))
def test_key_rewrite_and_regex_past_the_gate_run_striped(small_stripes, name):
    """The JAX engine spills these wide batches to its interpreter; the
    port lowers them striped and gives the same records, keys included."""
    docs = [b'{"name":"fluvio","pad":"' + b"ab" * 60 + b'"}',
            _at(LAST0 - 2, b'{"pad":"', b"x") + b'","name":"fliv' + b"ab" * 40 + b'"}',
            _at(LAST0 - 3, b"b", b"x") + b"abbbbbb" + b"x" * 30, b"a" * 30,
            b'{"name":"kafka","pad":"' + b"a" * 5 + b"b" * 90 + b'"}']
    port, _ = _run(NOW_STRIPED[name], [dict(values=docs, keys=_keys(len(docs)), base_offset=4),
                                        dict(values=[b'{"name":"fl"}', b"abababab"])])
    assert port.gpu_chain._striped.computed == (name == "key-rewrite")


# ---------------------------------------------------------------------------
# every compiled regex through the striped DFA composition
# ---------------------------------------------------------------------------

# pattern, its states and classes, a match, and a near miss of it
LARGE_DFAS = {
    "log-scan": ("(ERROR|WARN|FATAL|CRIT).*(timeout|refused|reset|denied|unreachable)", 73, 30,
                 b"ERROR: connection refused", b"ERROR: connection refuse_"),
    "access-log": ('(GET|POST|PUT|DELETE) /api/v[0-9]+/(users|orders|items)/[0-9]+ '
                   'HTTP/1\\.[01]" (4|5)[0-9][0-9]', 59, 33,
                   b'GET /api/v12/orders/42 HTTP/1.1" 404', b'GET /api/v12/orders/42 HTTP/1.1" 304'),
    "dated-fluvio": ("flu[vV]io.{0,16}[0-9]{4}-[0-9]{2}-[0-9]{2}", 242, 11,
                     b"fluVio @ 2026-10-18", b"fluvio" + b"." * 17 + b"2026-10-18"),
    "ab-six": ("(a|b)*a(a|b){6}", 130, 4, b"abbbbbb", b"abbbbb_"),
}


def _placed(match: bytes, at: int, head: bytes, total: int, tail: bytes) -> bytes:
    """``head``, filler, ``match`` at record byte ``at``, filler to
    ``total`` bytes, ``tail``."""
    body = head + b"_" * (at - len(head)) + match
    return body + b"_" * max(total - len(body), 0) + tail


def _dfa_docs(match: bytes, miss: bytes, head: bytes = b"", tail: bytes = b""):
    """The match and its near miss with their first byte at the record's
    (or the field's) first byte and on the last owned byte of rows 0 and
    1, and with their last byte on the first owned byte of rows 1 and 2
    and at the record's (the field's) end; records of 2-4 stripes."""
    first = len(head)
    out = []
    for m in (match, miss):
        for at in (first, LAST0, LAST1, STEP - len(m) + 1, 2 * STEP - len(m) + 1):
            out.append(_placed(m, max(at, first), head, 150, tail))
        out.append(head + b"_" * (170 - len(m)) + m + tail)  # ends the record or field
    return out + [head + b"_" * 120 + tail, head + match + tail]


@pytest.mark.parametrize("where", ["record", "span"])
@pytest.mark.parametrize("name", sorted(LARGE_DFAS))
def test_large_dfa_regexes_run_striped(small_stripes, name, where):
    """A regex past the JAX package's TPU gate (more than 64 states, or 16
    past 32 classes) over the whole record and inside a JsonGet field, a
    match straddling a seam from a row's last owned byte and to a row's
    first: the port composes it across the stripes and equals the JAX
    engine's interpreter spill."""
    pattern, n_states, n_classes, match, miss = LARGE_DFAS[name]
    dfa = ref_compile_regex(pattern)
    assert (dfa.n_states, dfa.n_classes) == (n_states, n_classes)
    assert dfa.n_states > 64 or dfa.n_classes > 32
    if where == "record":
        specs = [("regex-filter", {"regex": pattern})]
        docs = _dfa_docs(match, miss)
    else:
        # a raw (unquoted) value to the closing brace: the access-log
        # pattern holds a quote
        specs = [("json-regex-filter", {"key": "msg", "regex": pattern})]
        docs = _dfa_docs(match, miss, b'{"pad":"p","msg":', b"}")
        docs += [b'{"msg":"' + match + b'","pad":"' + b"q" * 90 + b'"}',
                 b'{"pad":"' + match + b"q" * 90 + b'"}']
    port, outs = _run(specs, [dict(values=docs, keys=_keys(len(docs)), base_offset=1)])
    assert 0 < len(outs[0].successes) < len(docs)
    assert cuda_kernels.LAUNCHES["dfa_compose"] == 0  # the plain versions count nothing


@pytest.mark.parametrize("pattern,packed", [
    (LARGE_DFAS["log-scan"][0], True), (LARGE_DFAS["ab-six"][0], True),
    (LARGE_DFAS["dated-fluvio"][0], True), ("(a|b)*a(a|b){6}c|x" + "d" * 125, False)],
    ids=["73", "130", "242", "257"])
def test_dfa_compose_at_large_tables_matches_a_serial_walk(pattern, packed):
    """`cuda_kernels.dfa_compose_columns` (its plain version here) at 73,
    130, 242 and 257 states (the last with 258 classes, the compiler's
    largest table) against a walk of each row's columns in Python and the
    JAX package's XLA composition; its column split (the kernel's S > 32
    design: segments folded in order) at 32 and 64 columns too."""
    ref = ref_compile_regex(pattern, packed=packed)
    table = np.asarray(ref.table)
    table_t = np.ascontiguousarray(table.T.astype(np.int32))
    rng = np.random.default_rng(ref.n_states)
    cls = rng.integers(0, ref.n_classes, size=(7, 150)).astype(np.int32)
    cls[0] = -1
    cls[2, 10:90] = -1
    cls[4:, 32:64] = -1
    want = np.empty((7, ref.n_states), dtype=np.int32)
    for i in range(7):
        f = np.arange(ref.n_states)
        for c in cls[i]:
            if c >= 0:
                f = table[f, c]
        want[i] = f
    got = cuda_kernels.dfa_compose_columns(torch.from_numpy(cls), torch.from_numpy(table_t))
    np.testing.assert_array_equal(got.numpy(), want)
    xla = jax_kernels.dfa_compose_columns(jnp.asarray(cls), jnp.asarray(table_t), ref.n_states)
    np.testing.assert_array_equal(np.asarray(xla), want)
    for seg_len in (32, 64):
        split = kernels.dfa_compose_columns_split(torch.from_numpy(cls),
                                                  torch.from_numpy(table_t), seg_len)
        np.testing.assert_array_equal(split.numpy(), want)


# ---------------------------------------------------------------------------
# key rewrites and values built from fields
# ---------------------------------------------------------------------------


def _map(value, key=None, predicate=None):
    """A map (a filter_map with ``predicate``) of DSL builders ``value(d)``
    and ``key(d)``, as a `_chains` spec."""
    if predicate is None:
        return (("map", lambda d: d.MapProgram(
            value=value(d), key=None if key is None else key(d))), {})
    return (("filter_map", lambda d: d.FilterMapProgram(
        predicate=predicate(d), value=value(d), key=None if key is None else key(d))), {})


def _name(d):
    return d.JsonGet(arg=d.Value(), key="name")


REKEY = _map(lambda d: d.Concat(args=[d.Const(data=b"<"), _name(d), d.Const(data=b">")]),
             _name, lambda d: d.RegexMatch(arg=d.Value(), pattern="flu[vV]io"))


def _named(name: bytes, at: int, pad_to: int = 160) -> bytes:
    """A record whose "name" value starts at record byte ``at``."""
    head = b'{"pad":"'
    pre = head + b"q" * (at - len(head) - len(b'","name":"')) + b'","name":"'
    doc = pre + name + b'","z":"'
    return doc + b"f" * max(pad_to - len(doc), 0) + b'fluvio"}'


REKEY_CASES = {
    # the name on the last owned byte of a row, across a seam, and past a stripe
    "field_across_seams": [_named(b"fluvio-seam", LAST0), _named(b"kafka-" + b"k" * 70, 20),
                           _named(b"x", LAST1), _named(b"fluVio" + b" " * 60, STEP)],
    # a missing field: an empty key and "<>"
    "missing_field": [b'{"pad":"' + b"f" * 90 + b'fluvio"}', _named(b"", 30),
                      b'{"name":' + b"7" * 100 + b',"fluvio":1}'],
    "the_pinned_chain": None,
}


@pytest.mark.parametrize("case", sorted(REKEY_CASES))
def test_rekey_by_a_field(small_stripes, case):
    """A filter_map re-keying records by their "name" field and building
    the value from it: the field crosses seams, sits past the first
    stripe or is missing (an empty key). Equal to the interpreter's keys,
    values and offsets."""
    spec = KEY_REWRITE if case == "the_pinned_chain" else REKEY
    docs = REKEY_CASES[case] or [_named(b"fliiv-%d" % i, 20 + 9 * i) for i in range(12)]
    port, outs = _run([spec], [dict(values=docs, keys=_keys(len(docs)), base_offset=2),
                               dict(values=[b'{"name":"fluvio"}', b"{}"])])
    assert port.gpu_chain._striped.computed and outs[0].successes


COMPUTED_CHAINS = {
    # the value's length and its leading integer, beside a field and the key
    "lengths_and_ints": [_map(lambda d: d.Concat(args=[
        d.IntToBytes(arg=d.Len(arg=d.Value())), d.Const(data=b":"),
        d.IntToBytes(arg=d.ParseInt(arg=d.Upper(arg=d.Value()))), d.Const(data=b":"),
        d.Lower(arg=_name(d)), d.Key()]))],
    # a fold ahead of the computed map, an aggregate after it
    "fold_then_rekey_then_count": [("regex-filter", {"regex": "flu[vV]io"}),
                                   _map(lambda d: d.Lower(arg=d.Value())),
                                   _map(lambda d: _name(d), lambda d: d.Const(data=b"k")),
                                   _map(lambda d: d.Concat(args=[d.Value(), d.Key()])),
                                   ("word-count", {})],
}


@pytest.mark.parametrize("name", sorted(COMPUTED_CHAINS))
def test_computed_maps_on_striped_batches(small_stripes, name):
    rng = np.random.default_rng(46)
    docs = [b"%d" % int(rng.integers(-999, 999)) + _named(b"fluvio %d w" % i, 12 + 11 * i)
            for i in range(10)] + [b"0" * 90 + b"77" + _named(b"Fluvio", 30), b"-" + b"9" * 15]
    _run(COMPUTED_CHAINS[name], [dict(values=docs, keys=_keys(len(docs)), base_offset=6)])


RESIDUAL_RAISES = {
    # no narrow column holds a field past 64 KiB (buffer.MAX_WIDTH)
    "field-past-64-KiB": ([REKEY], b'{"name":"fluvio' + b"n" * (1 << 16) + b'"}'),
    # the whole record in the output: the output would be as wide
    "whole-record-in-the-value": ([_map(lambda d: d.Concat(args=[d.Value(), d.Const(data=b"!")]),
                                        lambda d: d.Upper(arg=d.Key()))], b"fluvio" * 30),
}


@pytest.mark.parametrize("name", sorted(RESIDUAL_RAISES))
def test_what_no_narrow_column_holds_still_raises(small_stripes, name):
    """Kept divergence: the JAX engine spills the wide batch to its
    interpreter; the port raises ``record-too-wide-unstripeable``: at
    build for a computed value that reads the whole record (no striped
    lowering), at dispatch for a field wider than a narrow column."""
    specs, doc = RESIDUAL_RAISES[name]
    params = PARAMS if name != "field-past-64-KiB" else StripeParams(threshold=1 << 16,
                                                                      width=8192, overlap=128)
    pb = SmartEngine(device="cpu", stripes=params).builder()
    for (kind, build), p in specs:
        pb.add_smart_module(SmartModuleConfig(params=dict(p)), _module_pair(kind, build)[1])
    port = pb.initialize()
    assert (port.gpu_chain._striped_chain() is None) == (name != "field-past-64-KiB")
    _, port_in = _inputs([doc, b'{"name":"fluvio"}'])
    with pytest.raises(GpuSpill) as e:
        port.process(port_in)
    assert e.value.reason == "record-too-wide-unstripeable"
    # a narrow batch of the same chain still runs
    _, narrow_in = _inputs([b'{"name":"fluvio"}'])
    assert port.process(narrow_in).successes


def test_wide_slice_with_a_transform_error_through_the_consume_path():
    """Two stored batches of ~70 KB JSON arrays (the default geometry), the
    second holding a record that is no JSON array: the JAX package spills
    the slice to its interpreter, the port serves it striped, declines the
    coalesced slice at the error (``transform-error-spill``) and serves it
    batch by batch. Both return the same records, next offset and error."""
    from fluvio_tpu.spu import smart_chain as ref_sc
    from fluvio_tpu_torch.smartengine import SmartModuleChainMetrics
    from fluvio_tpu_torch.spu import smart_chain as sc
    from tests.test_torch_consume import EXPLODE as CONSUME_EXPLODE
    from tests.test_torch_consume import _chains as consume_chains
    from fluvio_tpu.protocol import codec as ref_codec
    from fluvio_tpu_torch.protocol import codec
    from tests.test_torch_consume import _decode, _set_bytes, _stored

    wide = [b"[" + b",".join(b'{"i":%d,"s":"a,]\\"b"}' % i for i in range(3_000 + k)) + b"]"
            for k in range(3)]
    bad = b'{"not":"' + b"x" * 70_000 + b'"}'
    wires = _stored([wide[:2], [wide[2], bad, wide[0]]], [0, 2], [10, 20])
    ref_chain, port_chain = consume_chains(CONSUME_EXPLODE)
    ref_b, port_b = _decode(wires)
    m = SmartModuleChainMetrics()
    ref_res = ref_sc.process_batches(ref_chain, ref_b, 1 << 22)
    port_res = sc.process_batches(port_chain, port_b, 1 << 22, m)
    assert port_res.next_offset == ref_res.next_offset
    assert _set_bytes(port_res.records, codec.ByteWriter) == _set_bytes(
        ref_res.records, ref_codec.ByteWriter)
    e, w = port_res.error, ref_res.error
    assert (e.hint, e.offset, e.kind.value, e.record_key, e.record_value) == (
        w.hint, w.offset, w.kind.value, w.record_key, w.record_value)
    assert e.offset == 3 and ref_res.records.total_records() == 3_000 + 3_001 + 3_002
    assert m.fallback_reasons == {"transform-error-spill": 1}
