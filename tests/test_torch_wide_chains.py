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

import numpy as np
import pytest
import torch

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu.smartmodule import types as ref_types
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol import record
from fluvio_tpu_torch.smartengine import GpuSpill, SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, stripes
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


def _kernel_model(sv, owned, first_row, k, step):
    """``csrc/json_array.cu``'s walk, a thread a segment, in Python."""
    sv, owned, first_row, k = (t.numpy() for t in (sv, owned, first_row, k))
    r, s = sv.shape
    flag = np.zeros((r, s), dtype=bool)
    start = np.zeros((r, s), dtype=np.int32)
    elen = np.zeros((r, s), dtype=np.int32)
    err = np.zeros(len(k), dtype=bool)

    def flat(seg, pos):
        j = min(pos // step, k[seg] - 1)
        return first_row[seg] + j, pos - j * step

    for seg in range(len(k)):
        if k[seg] <= 0:
            continue
        order = [(j * step + c, sv[first_row[seg] + j, c]) for j in range(k[seg])
                 for c in range(owned[first_row[seg] + j])]
        nonws = [p for p, b in order if not (9 <= b <= 13 or b == 32)]
        fa, fb = (nonws[0], nonws[-1]) if nonws else (-1, -1)
        ok = fa >= 0 and fb > fa and sv[flat(seg, fa)] == 0x5B and sv[flat(seg, fb)] == 0x5D
        err[seg] = not ok
        if not ok:
            continue
        in_str = esc = False
        depth, fnw, lnw, first_b, last_b = 0, -1, -1, 0, 0
        for p, b in order[fa + 1: fb + 1]:
            boundary = p == fb
            if not boundary:
                if in_str:
                    if esc:
                        esc = False
                    elif b == 0x5C:
                        esc = True
                    elif b == 0x22:
                        in_str = False
                elif b == 0x22:
                    in_str = True
                elif b in (0x5B, 0x7B):
                    depth += 1
                elif b in (0x5D, 0x7D):
                    depth -= 1
                elif b == 0x2C and depth == 0:
                    boundary = True
                if not boundary and not (9 <= b <= 13 or b == 32):
                    if fnw < 0:
                        fnw, first_b = p, b
                    lnw, last_b = p, b
            if boundary:
                if fnw >= 0:
                    q = int(first_b == 0x22 and last_b == 0x22 and lnw > fnw)
                    st, ln = fnw + q, lnw - 2 * q - fnw + 1
                    if ln > 0:
                        row, col = flat(seg, st)
                        flag[row, col], start[row, col], elen[row, col] = True, st, ln
                fnw = lnw = -1
    return flag, start, elen, err


def test_json_array_bounds_match_the_interpreter_and_the_kernel_walk():
    """`stripes.striped_json_array_bounds` (through its wrapper, on the
    CPU) against `dsl.json_array_elements` record by record, and cell for
    cell against the kernel's walk."""
    docs = _grid_docs()
    plan, sv = _stage(docs)
    args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], plan["step"])
    got = cuda_kernels.json_array_striped(*args)
    for name, g, w in zip(("flag", "start", "elen", "err"), got, _kernel_model(*args)):
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
# what still raises
# ---------------------------------------------------------------------------

STILL_RAISES = {
    "key-rewrite": [KEY_REWRITE],
    "regex-past-the-gate": [("regex-filter", {"regex": "(a|b)*a(a|b){6}"})],
}


@pytest.mark.parametrize("name", sorted(STILL_RAISES))
def test_key_rewrite_and_regex_past_the_gate_still_raise(small_stripes, name):
    """Kept divergence: no striped lowering on either side. The JAX engine
    spills the wide batch to its interpreter; the port raises."""
    specs = STILL_RAISES[name]
    pb = SmartEngine(device="cpu", stripes=PARAMS).builder()
    for spec, params in specs:
        port_m = lookup(spec) if isinstance(spec, str) else _module_pair(*spec)[1]
        pb.add_smart_module(SmartModuleConfig(params=dict(params)), port_m)
    port = pb.initialize()
    assert port.gpu_chain._striped_chain() is None
    _, port_in = _inputs([b'{"name":"fluvio","pad":"' + b"ab" * 60 + b'"}'])
    with pytest.raises(GpuSpill) as e:
        port.process(port_in)
    assert e.value.reason == "record-too-wide-unstripeable"


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
