"""Wide batches of the chains the striped lowering takes only in part, and
the comparisons and byte-valued integers of the narrow lowering, on the
CPU against the JAX package, tolerance 0.

A chain whose striped lowering stops at a program runs its longest
stripeable prefix striped and, when that prefix leaves narrow values (a
span map, a computed map or an aggregate ran), the rest of the chain on
the executor's narrow stages over the prefix's output: a second pass over
the same batch inside the same executor (``tail_from``,
``tail_batches``); where that output is a span map's fields past the
stripe threshold, the rest of the chain runs striped again over them
(``field_tail_batches``). The JAX package has no striped lowering for these
chains, so its engine spills each wide batch to its interpreter: that
rerun is the reference (``backend="tpu"``). Where the interpreter and the
JAX engine's native backend differ (a comparison of bytes with an
integer, a bytes value read as an integer), the port is held to the
native backend (``backend="auto"``), and the interpreter's answer is
pinned beside it.

Both sides run at small stripes (64 bytes overlapping by 16 above a
64-byte threshold: the JAX side through ``FLUVIO_STRIPE_*``, the port
through ``StripeParams(64, 64, 16)``): a row OWNS its first 48 bytes.
Inputs are fixed bytes or made with numpy from fixed seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fluvio_tpu.analysis import preflight_for_specs as ref_preflight_for_specs
from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu_torch.analysis import analyze_entries, preflight_for_specs
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.smartengine import GpuSpill, SmartEngine, SmartModuleConfig, StripeParams
from fluvio_tpu_torch.smartengine.gpu import stripes
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartengine.gpu.kernels import split_bounds
from fluvio_tpu_torch.telemetry import TELEMETRY
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_chain import _module_pair
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_torch_stripes import PARAMS, S, THRESHOLD, V, small_stripes  # noqa: F401
from tests.test_torch_wide_chains import _inputs, _keys, _same

STEP = S - V  # a row owns 48 bytes: the last owned byte of row j is 48 j + 47
LAST0, LAST1 = STEP - 1, 2 * STEP - 1


# ---------------------------------------------------------------------------
# the two engines
# ---------------------------------------------------------------------------


def _engines(specs, backend="tpu", params=PARAMS):
    """specs: [(registry name | (kind, build), params[, initial_data])] ->
    (JAX chain instance at ``backend``, port chain instance)."""
    rb = RefEngine(backend=backend).builder()
    pb = SmartEngine(device="cpu", stripes=params).builder()
    for spec, p, *initial in specs:
        init = initial[0] if initial else b""
        ref_m, port_m = (ref_lookup(spec), lookup(spec)) if isinstance(spec, str) else \
            _module_pair(*spec)
        rb.add_smart_module(RefConfig(params=dict(p), initial_data=init), ref_m)
        pb.add_smart_module(SmartModuleConfig(params=dict(p), initial_data=init), port_m)
    return rb.initialize(), pb.initialize()


def _both(specs, batches, backend="tpu", tail=True, params=PARAMS):
    """Every batch through both engines' ``process``, in order: equal
    outputs and errors; each wide batch (past ``params``' threshold) handed
    its prefix's output to a tail exactly when ``tail`` says so, each
    narrow batch none. Returns (port chain, outputs)."""
    ref, port = _engines(specs, backend, params)
    if backend == "tpu":
        assert ref.tpu_chain is not None and ref.tpu_chain._striped_chain() is None
    ex = port.gpu_chain
    assert ex is not None, "the chain must stay one fused card segment"
    sc = ex._striped_chain()
    assert sc is not None and (sc.tail_from is not None) == tail
    outs = []
    for b in batches:
        ref_in, port_in = _inputs(**b)
        before = ex.tail_batches
        ref_out, port_out = ref.process(ref_in), port.process(port_in)
        _same(ref_out, port_out)
        wide = max(len(v) for v in b["values"]) > params.threshold
        assert ex.tail_batches - before == int(wide and tail)
        outs.append(port_out)
    if backend == "tpu" and ex.agg_configs:
        ref.tpu_chain._ensure_host_state()
        ex._ensure_host_state()
        assert ex.carries == ref.tpu_chain.carries
    return port, outs


def _map(value, key=None, predicate=None):
    """A map (a filter_map with ``predicate``) of DSL builders, as a spec."""
    if predicate is None:
        return (("map", lambda d: d.MapProgram(
            value=value(d), key=None if key is None else key(d))), {})
    return (("filter_map", lambda d: d.FilterMapProgram(
        predicate=predicate(d), value=value(d), key=None if key is None else key(d))), {})


def _filter(pred):
    return (("filter", lambda d: d.FilterProgram(predicate=pred(d))), {})


def _field(key):
    return lambda d: d.JsonGet(arg=d.Value(), key=key)


def _split(sep: bytes):
    return (("array_map", lambda d: d.ArrayMapProgram(mode="split", sep=sep)), {})


def _named(name: bytes, at: int, pad_to: int = 160, extra: bytes = b"") -> bytes:
    """A record whose "name" value starts at record byte ``at``."""
    head = b'{"pad":"'
    pre = head + b"q" * (at - len(head) - len(b'","name":"')) + b'","name":"'
    doc = pre + name + b'"' + extra + b',"z":"'
    return doc + b"f" * max(pad_to - len(doc), 0) + b'"}'


SMALLEST = b'{"pad":"' + b"p" * 100 + b'","name":"fluvio one"}'


# ---------------------------------------------------------------------------
# the six chain shapes the striped lowering refuses whole
# ---------------------------------------------------------------------------

SHAPES = {
    # a filter after a span map (json-map upper-cases the field)
    "filter_after_span": ([("json-map", {"field": "name"}),
                           ("regex-filter", {"regex": "FLU[vV]IO"})],
                          [SMALLEST, _named(b"fluvio-seam", LAST0), _named(b"kafka", 70),
                           _named(b"x" * 70 + b"fluvio", 20), _named(b"", 30), b"{}",
                           b'{"name":"fluvio"}']),
    # a computed map after a span map: the JAX engine gives FLUVIO ONE keyed k
    "computed_after_span": ([("json-map", {"field": "name"}),
                             _map(lambda d: d.Value(), lambda d: d.Const(data=b"k"))],
                            [SMALLEST, _named(b"fluvio-seam", LAST1), _named(b"", 90)]),
    # a filter after a computed map (the value and the key are the field:
    # a value that holds the whole record beside a rewritten key stays a
    # residual raise, ROADMAP 3)
    "filter_after_computed": ([_map(_field("name"), _field("name")),
                               ("regex-filter", {"regex": "flu[vV]io"})],
                              [SMALLEST, _named(b"kafka", 50), _named(b"fluVio-" + b"v" * 60, 40),
                               _named(b"fluvio", LAST0)]),
    # a fan-out after a computed map: the field's words
    "fanout_after_computed": ([_map(lambda d: d.Concat(args=[
        _field("name")(d), d.Const(data=b" "), d.Key()])), ("array-map-lines", {})],
        [SMALLEST, _named(b"a\\nb c", LAST0), _named(b"", 40)]),
    # a second span map: the "name" field of the "obj" field
    "second_span": ([_map(_field("obj")), _map(_field("name"))],
                    [b'{"pad":"' + b"p" * 90 + b'","obj":{"name":"fluvio one","n":3}}',
                     b'{"obj":{"k":1,"name":"' + b"w" * 70 + b'"},"pad":"' + b"p" * 40 + b'"}',
                     b'{"obj":7,"pad":"' + b"p" * 80 + b'"}']),
    # a fan-out after an aggregate: the running sums' decimals split on "2"
    "fanout_after_aggregate": ([("aggregate-sum", {}), _split(b"2")],
                               [b" " * 70 + b"1222", b"12" + b"x" * 80, b"-7" + b" " * 70,
                                b" " * 60 + b"123456"]),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_each_refused_shape_runs_a_striped_prefix_and_a_narrow_tail(small_stripes, name):
    """Each shape on a wide batch (a record past the 64-byte threshold)
    equals the JAX engine's interpreter spill: values, keys, offsets and
    timestamps, over keyed records with a base offset and timestamp, then
    a narrow batch of the same chain, which runs fused."""
    specs, docs = SHAPES[name]
    _both(specs, [dict(values=docs, keys=_keys(len(docs)), ts=list(range(len(docs))),
                       base_offset=7, base_ts=1_000),
                  dict(values=[b'{"name":"fluvio","obj":{"name":"7"}}', b"12", b"{}"])])


def test_the_smallest_inputs_give_what_the_reference_gives(small_stripes):
    """ROADMAP 3's smallest inputs, one record each."""
    _, outs = _both(SHAPES["computed_after_span"][0], [dict(values=[SMALLEST])])
    assert [(r.value, r.key) for r in outs[0].successes] == [(b"FLUVIO ONE", b"k")]
    _, outs = _both(SHAPES["filter_after_computed"][0], [dict(values=[SMALLEST])])
    assert [(r.value, r.key) for r in outs[0].successes] == [(b"fluvio one", b"fluvio one")]
    split = b"a\r\nb\r\n" + b"c" * 80
    _, outs = _both([_split(b"\r\n")], [dict(values=[split])], tail=False)
    assert [r.value for r in outs[0].successes] == [b"a", b"b", b"c" * 80]


def test_tail_chain_keeps_one_fused_segment_for_narrow_batches(small_stripes):
    """A chain with a narrow tail keeps ``gpu_chain``: its narrow batch is
    one fused pass (the fused path's records grow, no tail pass, no
    stripe), its wide batch the striped path with one tail pass."""
    _, port = _engines(SHAPES["filter_after_span"][0])
    ex = port.gpu_chain
    assert ex is not None and port.backend_in_use == "gpu" and len(port.segments) == 1
    paths = TELEMETRY.path_records()
    _, narrow_in = _inputs([b'{"name":"fluvio"}', b'{"name":"kafka"}'])
    assert [r.value for r in port.process(narrow_in).successes] == [b"FLUVIO"]
    grew = {k: v - paths.get(k, 0) for k, v in TELEMETRY.path_records().items()}
    assert grew["fused"] == 2 and grew["striped"] == 0 and ex.tail_batches == 0
    _, wide_in = _inputs([SMALLEST])
    assert [r.value for r in port.process(wide_in).successes] == [b"FLUVIO ONE"]
    assert ex.tail_batches == 1 and ex._striped.tail_from == 1


# ---------------------------------------------------------------------------
# carries through a tail aggregate, the deferred finish, an overflow
# ---------------------------------------------------------------------------


def _obj_docs(rng, n: int, wide: bool):
    out = []
    for _ in range(n):
        num = int(rng.integers(-500, 500))
        pad = b"p" * int(rng.integers(60, 120)) if wide else b""
        out.append(b'{"pad":"%s","obj":{"n":%d,"s":"x"}}' % (pad, num))
    return out


def test_tail_aggregate_carries_across_narrow_and_wide_batches(small_stripes):
    """``map obj`` -> ``map n`` -> ``aggregate-sum``: the second span map
    and the aggregate run as the tail of wide batches, fused on narrow
    ones, through the same carry slot. The port's stream (pipelined, its
    view finishes deferred) equals the JAX engine batch by batch, and the
    carries are equal after it."""
    specs = [_map(_field("obj")), _map(_field("n")), ("aggregate-sum", {}, b"5")]
    rng = np.random.default_rng(260)
    batches = [_obj_docs(rng, 9, wide=k % 2 == 1) for k in range(6)]
    ref, port = _engines(specs)
    ex = port.gpu_chain
    ref_outs = [ref.process(_inputs(b)[0]) for b in batches]
    bufs = [RecordBuffer.from_smartmodule_input(_inputs(b)[1]) for b in batches]
    outs = list(ex.process_stream(bufs))
    for r, p in zip(ref_outs, outs):
        assert p.value_list() == [x.value for x in r.successes]
    assert ex.tail_batches == 3
    ref.tpu_chain._ensure_host_state()
    ex._ensure_host_state()
    assert ex.carries == ref.tpu_chain.carries


def test_tail_explode_overflow_redispatches_from_the_prefix_carries(small_stripes):
    """``aggregate-sum`` -> ``map`` -> a split of the rendering, then a
    second aggregate over the elements: wide batches whose tail explodes
    past its capacity run the tail again from the carries the striped
    prefix left; narrow batches between them move the same carries."""
    specs = [("aggregate-sum", {}),
             _map(lambda d: d.Concat(args=[d.Value(), d.Const(data=b",1,2,3,4,5,6")])),
             _split(b","), ("aggregate-sum", {})]
    rng = np.random.default_rng(261)

    def docs(wide: bool):
        pad = b" " * 70 if wide else b""
        return [pad + b"%d" % int(rng.integers(1, 9)) for _ in range(700)]

    port, _ = _both(specs, [dict(values=docs(True)), dict(values=docs(False)),
                            dict(values=docs(True))])
    assert port.gpu_chain.redispatches >= 1


def test_tail_json_explode_first_error(small_stripes):
    """A JSON-array explode after a computed map: a record whose field is
    no JSON array ends the batch with the interpreter's first error (its
    key and value as the explode saw them), after the elements before it,
    and the carries of an aggregate ahead of it."""
    specs = [_map(_field("items"), lambda d: d.Const(data=b"k")), ("array-map-json", {})]
    docs = [b'{"pad":"%s","items":[1,"a,b",{"c":[2]}]}' % (b"p" * 70),
            b'{"items":[]}', b'{"pad":"%s","items":{"no":1}}' % (b"p" * 60),
            b'{"items":[3]}']
    _both(specs, [dict(values=docs, base_offset=40)])


# ---------------------------------------------------------------------------
# a tail input past the stripe threshold: the tail's own striped rung
# ---------------------------------------------------------------------------

WIDE = 170  # a field of this many bytes and more spans four rows of its own


def _big(rng, n: int, sep: bytes = b",") -> bytes:
    """``n`` random decimals joined by ``sep``."""
    return sep.join(b"%d" % x for x in rng.integers(0, 10**6, size=n))


def _field_docs(key: bytes, body: bytes, pad: int = 0) -> bytes:
    return b'{"pad":"%s","%s":%s,"z":1}' % (b"p" * pad, key, body)


def _field_cases():
    """{case: (specs, batches of values, the rung's passes)}: fields past
    the threshold, their matches, elements and errors across the rung's
    seams."""
    rng = np.random.default_rng(262)
    name = lambda head: b'"' + head + b"n" * WIDE + b'"'  # noqa: E731
    obj = b'{"pad":"%s","name":"fluvio obj","n":7}' % (b"o" * WIDE)
    return {
        # a regex filter over the field (json-map upper-cases it); a wide
        # record with a narrow field and a narrow record share the batch
        "filter": ([("json-map", {"field": "name"}), ("regex-filter", {"regex": "FLU[vV]IO"})],
                   [[_field_docs(b"name", name(b"fluvio ")), _field_docs(b"name", name(b"kafka ")),
                     _field_docs(b"name", b'"fluvio"', pad=WIDE), b'{"name":"fluvio"}']], 1),
        # a split of the field, its elements across the rung's seams, past
        # the explode's first capacity
        "split": ([_map(_field("name")), _split(b",")],
                  [[_field_docs(b"name", b'"' + _big(rng, 100) + b'"') for _ in range(11)]
                   + [_field_docs(b"name", b'"a,,b"', pad=WIDE)]], 1),
        # a second span map over a wide field, then a filter: the rung's
        # own prefix hands a narrow field to a narrow tail; in the second
        # batch a field of that field is past the threshold too, and the
        # rung runs again over it
        "second_span_then_filter": (
            [_map(_field("obj")), _map(_field("name")), ("regex-filter", {"regex": "obj$"})],
            [[_field_docs(b"obj", obj), _field_docs(b"obj", b'{"name":"kafka"}', pad=WIDE),
              _field_docs(b"obj", obj.replace(b"fluvio obj", b"fluvio"))],
             [_field_docs(b"obj", obj.replace(b"fluvio obj", b"m" * WIDE + b" obj")),
              _field_docs(b"obj", obj)]], 3),
        # a filter and an aggregate over the field, narrow and wide batches
        # through the same carry slot
        "aggregate": ([("json-map", {"field": "name"}), ("regex-filter", {"regex": "FLU"}),
                       ("aggregate-count", {})],
                      [[_field_docs(b"name", name(b"fluvio ")), _field_docs(b"name", name(b"x"))],
                       [b'{"name":"fluvio"}', b'{"name":"kafka"}'],
                       [_field_docs(b"name", name(b"flu")), b'{"name":"flu"}']], 2),
        # a JSON-array explode of the field: a field that is no array ends
        # the batch with the first error, its value the field as the
        # explode saw it
        "json_explode_first_error": (
            [_map(_field("items")), ("array-map-json", {})],
            [[_field_docs(b"items", b"[" + _big(rng, 120) + b"]"),
              _field_docs(b"items", b'{"no":[1,2]}', pad=WIDE),
              _field_docs(b"items", b"[1,2]")]], 1),
    }


FIELD_CASES = _field_cases()


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_a_field_past_the_threshold_runs_the_tail_striped(small_stripes, name):
    """A wide batch whose span map leaves a field past the stripe
    threshold: as the batch's own width ladder would, the rest of the
    chain runs striped over the fields, cut into rows of their own
    (``field_tail_batches``), equal to the JAX engine's interpreter spill
    (values, keys, offsets, timestamps, the first error, the carries); a
    narrow batch runs fused."""
    specs, batches, passes = FIELD_CASES[name]
    port, _ = _both(specs, [dict(values=b, keys=_keys(len(b)), base_offset=11, base_ts=500)
                            for b in batches])
    assert port.gpu_chain.field_tail_batches == passes
    if name == "split":
        assert port.gpu_chain.redispatches >= 1


def test_a_filtered_out_field_does_not_widen_the_tail(small_stripes):
    """Only surviving records size the tail's input: a field past the
    threshold whose record a filter ahead of the span map dropped leaves
    the tail narrow."""
    specs = [("regex-filter", {"regex": "keep"}), ("json-map", {"field": "name"}),
             ("regex-filter", {"regex": "FLUVIO"})]
    docs = [_field_docs(b"name", b'"fluvio' + b"n" * WIDE + b'"'),
            _field_docs(b"name", b'"fluvio keep"', pad=WIDE)]
    port, _ = _both(specs, [dict(values=docs)])
    assert port.gpu_chain.field_tail_batches == 0 and port.gpu_chain.tail_batches == 1


# ---------------------------------------------------------------------------
# splits on separators of several bytes, across the seams
# ---------------------------------------------------------------------------


def _around_seams(sep: bytes, filler: bytes, rng) -> list:
    """Records with the separator placed over every seam position of the
    first two rows (starting 1..len(sep) bytes before an owned row's end),
    runs of it, at the record's ends, and random fill."""
    out = [sep * 9, sep + b"x" + sep, filler * 3]
    for last in (LAST0, LAST1):
        for back in range(len(sep) + 1):
            at = last + 1 - back
            out.append((filler * at)[:at] + sep + (filler * 20)[:20] + sep)
    for _ in range(12):
        parts = [filler * int(rng.integers(0, 30)) for _ in range(int(rng.integers(1, 8)))]
        out.append(sep.join(parts) + (sep if rng.random() < 0.3 else b""))
    return [r for r in out if len(r) > THRESHOLD] + [b"short" + sep + b"x"]


SEPARATORS = {
    "crlf": (b"\r\n", b"ab"),
    "aa": (b"aa", b"a"),  # over runs of a: each match hides the next byte
    "abab": (b"abab", b"ab"),
    "comma_space": (b", ", b"x,"),
    "past_the_overlap": (b"<separator-0123456789>", b"s<"),  # 22 bytes, overlap 16
    "bordered_past_the_overlap": (b"ab" * 11, b"ab"),
}


@pytest.mark.parametrize("name", sorted(SEPARATORS))
def test_split_on_a_separator_of_several_bytes(small_stripes, name):
    """``value.split(sep)`` with empty elements dropped, matched left to
    right without overlap, over records whose matches straddle the seams:
    the whole chain runs striped, equal to the interpreter."""
    sep, filler = SEPARATORS[name]
    rng = np.random.default_rng(len(sep) * 7 + filler[0])
    docs = _around_seams(sep, filler, rng)
    _both([("regex-filter", {"regex": "."}), _split(sep)], [dict(values=docs, base_offset=3)],
          tail=False)


@pytest.mark.parametrize("name", sorted(SEPARATORS))
def test_striped_separator_matches_equal_the_narrow_split(name):
    """The striped split's grid against the narrow `kernels.split_bounds`
    (the reference's column scan) at three geometries, down to a step of
    4 bytes, where a separator spans many rows."""
    sep, filler = SEPARATORS[name]
    rng = np.random.default_rng(len(sep) + 11)
    docs = _around_seams(sep, filler, rng) + [b"", sep, filler]
    for params in (PARAMS, StripeParams(threshold=64, width=8, overlap=4),
                   StripeParams(threshold=64, width=128, overlap=32)):
        buf = RecordBuffer.from_values(docs)
        ln = torch.from_numpy(buf.lengths.astype(np.int32))
        rows = stripes.plan_rows(buf.lengths, buf.count, params.width, params.overlap)
        flat, _ = buf.ragged_values()
        flat = torch.from_numpy(np.concatenate([flat, np.zeros(4, np.uint8)]).view(np.int32))
        plan, sv, kmax = stripes.stage_rows(flat, ln, buf.lengths, buf.count, params, rows)
        flag, st, el = stripes.striped_split_bounds(sv, plan, sep, len(docs), kmax)
        got = [[] for _ in docs]
        seg = plan["seg"].numpy()
        for r_, c_ in zip(*np.nonzero(flag.numpy())):
            got[seg[r_]].append((int(st[r_, c_]), int(el[r_, c_])))
        want = []
        for d in docs:
            v = torch.from_numpy(np.frombuffer(d + b"\0", np.uint8).copy())[None, :]
            f, s_, e_, ff, fs, fl, _ = split_bounds(v, torch.tensor([len(d)]), sep)
            cells = [(int(s_[0, j]), int(e_[0, j])) for j in np.nonzero(f[0].numpy())[0]]
            if bool(ff[0]):
                cells.append((int(fs[0]), int(fl[0])))
            want.append(cells)
        assert got == want
        assert want == [[(i, len(e)) for i, e in _py_split(d, sep)] for d in docs]


def _py_split(d: bytes, sep: bytes):
    at = 0
    for e in d.split(sep):
        if e:
            yield at, e
        at += len(e) + len(sep)


# ---------------------------------------------------------------------------
# comparisons of bytes and bytes values read as integers
# ---------------------------------------------------------------------------

PROBES = [b"12", b" 5", b"1_0", b"+3", b"abc", b"-", b"9" * 20, b"\t4\n", b'{"n":3}', b"7",
          b"", b"\xff", b"\x80a", b"ab", b"abc\x00", b"-3"]
PROBE_KEYS = [b"7", b"5", b"10", b"3", b"abd", b"", b"1", b"4", b"3", b"7",
              None, b"\x7f", b"\x80", b"abc", b"abc", b"-3"]
OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def _wide(values, at=70):
    """Each value behind a JSON field past the first stripes, and the
    record padded past the threshold."""
    return [b'{"pad":"' + b"p" * at + b'","v":"' + v.replace(b'"', b"'") + b'"}' for v in values]


CMPS = {
    "value_key": lambda d: (d.Value(), d.Key()),
    "field_key": lambda d: (d.JsonGet(arg=d.Value(), key="v"), d.Key()),
    "field_const": lambda d: (d.Upper(arg=d.JsonGet(arg=d.Value(), key="v")), d.Const(data=b"AB")),
    "const_field": lambda d: (d.Const(data=b"9" * 20), d.JsonGet(arg=d.Value(), key="v")),
    "value_int": lambda d: (d.Value(), d.Len(arg=d.Key())),
    "field_int": lambda d: (d.JsonGet(arg=d.Value(), key="v"), d.ParseInt(arg=d.Key())),
}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pair", sorted(CMPS))
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_comparisons_follow_the_native_backend(small_stripes, pair, op, wide):
    """A filter ``Cmp(op, left, right)``: two bytes operands in Python
    ``bytes`` order (bytes past 0x7f unsigned, a proper prefix smaller), a
    bytes operand against an int through its leading integer. Held to the
    JAX engine at ``backend="auto"`` (its native backend), narrow and on a
    wide batch (striped, the record's prefix, fields and leading integer
    as narrow columns)."""
    keys = PROBE_KEYS
    if pair.startswith(("field", "const")):
        values = _wide(PROBES, at=70 if wide else 1)
    elif wide:
        # wide keys too: equal to the value, a proper prefix of it
        values = [v + b" " * 70 for v in PROBES]
        keys = [values[i] if i % 3 == 0 else values[i][:60] if i % 3 == 1 else k
                for i, k in enumerate(PROBE_KEYS)]
        # a key as wide as the key column (128 bytes), the value's first 128
        # bytes: only the record's first w + 1 bytes order them
        values.append(b"k" * 128 + b"tail")
        keys.append(b"k" * 128)
    else:
        values = PROBES
    pred = lambda d: d.Cmp(cmp=op, left=CMPS[pair](d)[0], right=CMPS[pair](d)[1])  # noqa: E731
    ref, port = _engines([_filter(pred)], backend="auto")
    ref_in, port_in = _inputs(values, keys=keys, base_offset=9)
    _same(ref.process(ref_in), port.process(port_in))
    if wide:
        assert port.gpu_chain._striped_chain().tail_from is None


def test_mixed_comparison_interpreter_divergence_is_pinned():
    """Reference divergence (ROADMAP 3): the JAX interpreter evaluates a
    comparison's six outcomes at once as Python does, so a bytes value
    against an int raises ``TypeError`` (its ``lt`` does) for every
    operator, ``eq`` included; the native backend (and the port) read the
    bytes' leading integer."""
    for op, want in (("eq", [b"1"]), ("lt", []), ("ge", [b"1", b"2"])):
        pred = lambda d, op=op: d.Cmp(cmp=op, left=d.Value(), right=d.Len(arg=d.Key()))  # noqa
        ref, port = _engines([_filter(pred)], backend="python")
        ref_in, port_in = _inputs([b"1", b"2"], keys=[b"k", b"k"])
        with pytest.raises(TypeError):
            ref.process(ref_in)
        native, _ = _engines([_filter(pred)], backend="auto")
        assert [r.value for r in native.process(ref_in).successes] == want
        assert [r.value for r in port.process(port_in).successes] == want


CONTRIBUTIONS = {
    "upper_value": lambda d: d.Upper(arg=d.Value()),
    "field": lambda d: d.JsonGet(arg=d.Value(), key="v"),
    "key": lambda d: d.Key(),
}


@pytest.mark.parametrize("combine", ["add", "max", "min"])
@pytest.mark.parametrize("source", sorted(CONTRIBUTIONS))
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_bytes_contribution_reads_its_leading_integer(small_stripes, source, combine, wide):
    """An aggregate whose contribution is a bytes value takes its leading
    integer (the native backend's rule), over the probe records, narrow
    and wide, across two batches: held to ``backend="auto"``."""
    values = list(PROBES)
    if wide:
        values = _wide(PROBES) if source == "field" else [b" " * 70 + v for v in PROBES]
    contribution = CONTRIBUTIONS[source]
    agg = (("aggregate", lambda d: d.AggregateProgram(contribution=contribution(d),
                                                     combine=combine)), {})
    ref, port = _engines([agg], backend="auto")
    for k in range(2):
        ref_in, port_in = _inputs(values[k::2], keys=PROBE_KEYS[k::2])
        _same(ref.process(ref_in), port.process(port_in))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_int_to_bytes_of_bytes(small_stripes, wide):
    """``IntToBytes`` of a bytes value renders its leading integer, as a
    key rewrite beside a field value: held to ``backend="auto"``."""
    values = _wide(PROBES, at=70 if wide else 1)
    spec = _map(lambda d: d.Concat(args=[d.IntToBytes(arg=d.JsonGet(arg=d.Value(), key="v")),
                                         d.Const(data=b"|"), d.IntToBytes(arg=d.Value())]),
                lambda d: d.IntToBytes(arg=d.Key()))
    ref, port = _engines([spec], backend="auto")
    ref_in, port_in = _inputs(values, keys=PROBE_KEYS)
    _same(ref.process(ref_in), port.process(port_in))


def test_byte_valued_integer_interpreter_divergence_is_pinned():
    """Reference divergence (ROADMAP 3): the JAX interpreter reads a bytes
    contribution with Python's ``int()``: ``1_0`` is 10 where the native
    backend and the port read 1, and ``abc`` raises ``ValueError``."""
    agg = (("aggregate", lambda d: d.AggregateProgram(contribution=d.Value(), combine="add")),
           {})
    ref, port = _engines([agg], backend="python")
    ref_in, port_in = _inputs([b"1_0"])
    assert [r.value for r in ref.process(ref_in).successes] == [b"10"]
    assert [r.value for r in port.process(port_in).successes] == [b"1"]
    ref_in, _ = _inputs([b"abc"])
    with pytest.raises(ValueError):
        ref.process(ref_in)


# ---------------------------------------------------------------------------
# what still raises, and the preflight
# ---------------------------------------------------------------------------

STILL_RAISES = {
    # the record compared with itself: no narrow column to compare against
    "record_against_itself": ([_filter(lambda d: d.Cmp(cmp="lt", left=d.Value(),
                                                       right=d.Upper(arg=d.Value())))],
                              PARAMS, b"fluvio" * 20, "the record value with itself"),
    # a stage after a striped fan-out: the elements are rows of no record
    "stage_after_a_fanout": ([("array-map-lines", {}), ("regex-filter", {"regex": "a[0-9]"})],
                             PARAMS, b"a1\nb\n" * 30, "stage after a striped terminal stage"),
    # a value that holds the whole of a field past the threshold, beside
    # a rewritten key: the tail's own striped rung has no lowering for it
    "computed_over_a_wide_field": (SHAPES["computed_after_span"][0], PARAMS,
                                   b'{"name":"fluvio' + b"n" * WIDE + b'"}',
                                   "no striped lowering of the stages from 1"),
}


@pytest.mark.parametrize("name", sorted(STILL_RAISES))
def test_what_the_striped_path_still_refuses_raises_with_its_reason(small_stripes, name):
    """Kept divergences (ROADMAP 3): the JAX engine spills the wide batch
    to its interpreter; the port raises ``record-too-wide-unstripeable``
    with the refusal in its message, and a narrow batch still runs."""
    specs, params, doc, reason = STILL_RAISES[name]
    _, port = _engines(specs, backend="auto", params=params)
    _, port_in = _inputs([doc, b'{"name":"fluvio"}'])
    with pytest.raises(GpuSpill) as e:
        port.process(port_in)
    assert e.value.reason == "record-too-wide-unstripeable" and reason in str(e.value)
    _, narrow_in = _inputs([b'{"name":"fluvio"}'])
    port.process(narrow_in)


PREFLIGHT = {
    **{k: v[0] for k, v in SHAPES.items()},
    "crlf_split": [_split(b"\r\n")],
    "bytes_cmp": [_filter(lambda d: d.Cmp(cmp="eq", left=d.Value(), right=d.Key()))],
    "bytes_contribution": [(("aggregate", lambda d: d.AggregateProgram(
        contribution=d.Upper(arg=d.Value()), combine="add")), {})],
    "record_against_itself": STILL_RAISES["record_against_itself"][0],
}


@pytest.mark.parametrize("name", sorted(PREFLIGHT))
def test_preflight_predicts_the_path_the_executor_takes(small_stripes, name):
    """At a narrow and a wide width, `analyze_entries` predicts the path
    the executor takes: ``fused``; ``striped`` with the narrow tail's
    first stage where a tail runs (the executor's ``tail_batches``), or
    a raise with the spill's reason, as its counters show."""
    specs = PREFLIGHT[name]
    _, port = _engines(specs, backend="auto")
    entries = [(m, c) for m, c in zip([i.module for i in port.instances],
                                      [i.config for i in port.instances])]
    engine = SmartEngine(device="cpu", stripes=PARAMS)
    report = analyze_entries(entries, widths=(40, 300), engine=engine)
    assert not [h for h in report.errors() if h.code == "unlowerable"]
    narrow, wide = report.predictions
    assert narrow.path == "fused" and narrow.tail_from is None
    ex = port.gpu_chain
    spills = dict(TELEMETRY.spills)
    doc = (SHAPES.get(name, ([], [b'{"name":"x"}' + b" " * 300]))[1][0] + b" " * 300)[:300]
    _, wide_in = _inputs([doc])
    try:
        port.process(wide_in)
        observed, reasons = "striped", []
    except GpuSpill as e:
        observed, reasons = "raise", [e.reason]
    grew = sorted(k for k, v in TELEMETRY.spills.items() if v > spills.get(k, 0))
    assert wide.path == observed and list(wide.spill_reasons) == reasons == grew
    assert (wide.tail_from is not None) == (ex.tail_batches == 1)
    if wide.tail_from is not None:
        assert wide.tail_from == ex._striped.tail_from


TAIL_REGISTRY_CHAINS = {
    "filter_after_span": [("json-map", {"field": "name"}), ("regex-filter", {"regex": "FLU[vV]IO"})],
    "second_span": [("json-map", {"field": "name"}), ("json-map", {"field": "n"})],
    "fanout_after_aggregate": [("aggregate-sum", None), ("array-map-lines", None)],
}


@pytest.mark.parametrize("name", sorted(TAIL_REGISTRY_CHAINS))
def test_tail_chains_predict_striped_where_the_reference_preflight_spills(name):
    """A pinned difference: past the stripe threshold the port's preflight
    predicts ``striped`` with a narrow tail from the second module for
    these registry chains; the JAX preflight predicts its interpreter
    spill (it has no striped lowering for them)."""
    specs = TAIL_REGISTRY_CHAINS[name]
    width = (1 << 16) + 1
    pred = preflight_for_specs(specs, width, engine=SmartEngine(device="cpu"))
    assert pred["path"] == "striped" and pred["tail_from"] == 1
    assert not pred.get("spill_reasons")
    ref = ref_preflight_for_specs(specs, width)
    assert ref["path"] == "interpreter"
    assert ref["spill_reasons"] == ["record-too-wide-unstripeable"]
