"""Striped wide-record layout on the card.

The port's counterpart of ``fluvio_tpu/smartengine/tpu/stripes.py`` for
filter, map, filter_map, aggregate and split array_map chains. A record
wider than the narrow layout (`StripeParams.threshold`) becomes K
consecutive device rows ("stripes") of ``width`` bytes sharing a segment
id; consecutive stripes overlap by ``overlap`` bytes. The row sidecar
(segment, stripe index, byte offset, stripe length) is derived on the
card from the record lengths, so the upload stays the narrow path's one
ragged flat.

- Literals up to the overlap (start-anchored: the stripe width) are whole
  in some stripe: a windowed compare per stripe, OR-reduced per segment.
- Non-literal regexes, and literals past the overlap, chain DFA state
  across stripes: each row's OWNED bytes reduce to one transition
  function (`cuda_kernels.dfa_compose_columns`, which takes every table
  the compiler emits), the rows of a segment compose in order, and EOS
  applies once per segment.
- A single-level ``JsonGet`` carries the structural machine across the
  stripes (`cuda_kernels.striped_json_span`) and gives record-absolute
  (start, length) views; predicates over the field window-compare or
  chain an in-span DFA inside that span.
- Maps are the position-wise case folds (upper/lower), which commute with
  striping, or one JsonGet view; outputs ship as the segment survivor mask
  or (start, length) descriptors, and the host rebuilds the bytes. A map
  that rewrites the key or builds its value from fields computes narrow
  columns instead: the narrow lowering over the segment state, each
  JsonGet field gathered from the stripes into a narrow column
  (`striped_field_bytes`); its outputs ship as the narrow path's computed
  values do.
- A comparison reads the record's first bytes, a JsonGet field or the
  record's leading integer as narrow columns (`_lower_striped_cmp`).
- Aggregates run the executor's narrow stage over the segment state (the
  full record lengths and the first stripe's bytes), so their carries
  are the narrow path's. What that state cannot give exactly is a
  contribution over a per-segment byte range, computed here over the
  owned bytes of every stripe and handed to the stage: a word count over
  the whole record or a JsonGet span, an integer parsed from the start
  of a JsonGet span (`striped_count_words`, `striped_parse_int`).
- A ``split`` explode emits its elements from the owned bytes of every
  stripe (`striped_split_bounds`; a separator of several bytes reads past
  the row where it must, and one whose occurrences can overlap selects
  its matches left to right across the seams, `striped_separator_matches`);
  a JSON-array explode carries its
  string, escape and depth state across the stripe seams
  (`cuda_kernels.json_array_striped`, plain version
  `striped_json_array_bounds`).

A chain the striped lowering takes only in part runs as its longest
prefix that leaves narrow values (a span map, a computed map or an
aggregate ran) and hands that output to the executor's narrow stages for
the rest (`try_build_striped`'s ``tail_from``); a span map's field past
the stripe threshold is cut into stripe rows of its own
(`restripe_field`) and the rest lowered striped over it.

The stripe geometry is an explicit `StripeParams`, never read from the
environment.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.ops.regex_dfa import UnsupportedRegex, compile_regex_cached, literal_of
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels
from fluvio_tpu_torch.smartengine.gpu.buffer import MAX_WIDTH
from fluvio_tpu_torch.smartengine.gpu.lower import (
    Column,
    Unlowerable,
    apply_postops,
    as_int_expr,
    cmp_operands,
    infer_type,
    lower_expr,
)
from fluvio_tpu_torch.smartmodule import dsl

@dataclass(frozen=True)
class StripeParams:
    """Stripe geometry: batches wider than ``threshold`` bytes stage as
    rows of ``width`` bytes overlapping by ``overlap`` bytes. The step
    (width - overlap) stays 4-aligned so stripe starts land on i32 words of
    the ragged upload."""

    threshold: int = MAX_WIDTH
    width: int = 8192
    overlap: int = 128

    def __post_init__(self) -> None:
        s, v = self.width, self.overlap
        if s % 4 or v % 4 or v >= s:
            raise ValueError(f"bad stripe params width={s} overlap={v}")
        if not 0 < self.threshold <= MAX_WIDTH:
            raise ValueError(
                f"stripe threshold {self.threshold} outside the narrow layout (1..{MAX_WIDTH})"
            )

    @property
    def step(self) -> int:
        return self.width - self.overlap


def stripe_counts(lengths: np.ndarray, s: int, v: int) -> np.ndarray:
    """Host mirror of the card's stripe-count formula (must agree)."""
    step = s - v
    lengths = np.asarray(lengths, dtype=np.int64)
    return np.maximum(1, (np.maximum(lengths - v, 0) + step - 1) // step)


def plan_rows(lengths: np.ndarray, count: int, s: int, v: int) -> int:
    """Exact live stripe-row total for a batch (host side)."""
    if count == 0:
        return 1
    return int(stripe_counts(lengths[:count], s, v).sum())


def plan_device(lengths: torch.Tensor, live: torch.Tensor, r: int, s: int, v: int) -> dict:
    """Derive the stripe sidecar on the card from the record lengths.

    ``lengths`` i32[n] (zero past the live count), ``live`` bool[n], ``r``
    the stripe-row count. Returns per stripe-row tensors ``seg`` (record
    row), ``stripe_idx``, ``abs_start`` (byte offset of the stripe within
    its record), ``stripe_len``, ``row_live``, ``is_last``, the per-record
    ``first_row`` and stripe count ``k``, and the ints ``step``, ``s``,
    ``v``."""
    step = s - v
    n = lengths.shape[0]
    dev = lengths.device
    lengths = lengths.to(torch.int32)
    k = torch.where(
        live, torch.clamp((torch.clamp(lengths - v, min=0) + step - 1) // step, min=1), 0
    ).to(torch.int32)
    cum = torch.cumsum(k, 0).to(torch.int32)
    rr = torch.arange(r, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(cum, rr, right=True).to(torch.int32).clamp(0, n - 1)
    seg_l = seg.to(torch.int64)
    first_row = cum - k
    stripe_idx = rr - first_row[seg_l]
    row_live = rr < cum[-1]
    abs_start = stripe_idx * step
    stripe_len = torch.where(row_live, (lengths[seg_l] - abs_start).clamp(0, s), 0).to(torch.int32)
    is_last = row_live & (stripe_idx == k[seg_l] - 1)
    return {
        "seg": seg,
        "stripe_idx": stripe_idx,
        "abs_start": abs_start,
        "stripe_len": stripe_len,
        "row_live": row_live,
        "is_last": is_last,
        "first_row": first_row,
        "k": k,
        "step": step,
        "s": s,
        "v": v,
    }


def striped_repad_words(flat: torch.Tensor, lengths: torch.Tensor, plan: dict, s: int):
    """Build the striped byte matrix u8[r, s] from the 4-aligned ragged
    upload (i32 words), as the narrow ``ragged_repad_words`` does for one
    row per record; stripe starts are word-aligned because the step is.
    Overlap bytes are gathered twice from the same flat (device memory
    only, never link bytes)."""
    lengths4 = (lengths.to(torch.int64) + 3) & ~3
    word_starts = (torch.cumsum(lengths4, 0) - lengths4) >> 2
    ws = word_starts[plan["seg"].to(torch.int64)] + (plan["abs_start"].to(torch.int64) >> 2)
    jw = torch.arange(s // 4, dtype=torch.int64, device=flat.device)[None, :]
    words = flat[(ws[:, None] + jw).clamp(0, flat.shape[0] - 1)]
    shifts = torch.arange(4, dtype=torch.int32, device=flat.device) * 8
    gathered = ((words[:, :, None] >> shifts) & 0xFF).reshape(words.shape[0], s)
    keep = torch.arange(s, dtype=torch.int32, device=flat.device)[None, :] < plan["stripe_len"][:, None]
    return torch.where(keep, gathered, 0).to(torch.uint8)


def stage_rows(flat: torch.Tensor, lengths: torch.Tensor, host_lengths: np.ndarray,
               count: int, params: StripeParams, srows: int):
    """Re-pad one uploaded batch into stripe rows: (plan, sv u8[srows, s],
    kmax). ``flat`` is the ragged upload as i32 words, ``lengths`` i32[n]
    its record lengths on the card, ``host_lengths`` the same lengths on
    the host, which give ``kmax`` (the most stripes of any live record)
    without waiting on the card."""
    s, v = params.width, params.overlap
    live = torch.arange(lengths.shape[0], device=lengths.device) < count
    plan = plan_device(lengths, live, srows, s, v)
    sv = striped_repad_words(flat, lengths, plan, s)
    kmax = int(stripe_counts(host_lengths[:count], s, v).max()) if count else 1
    return plan, sv, kmax


def owned_lengths(plan: dict) -> torch.Tensor:
    """Bytes of each stripe row OWNED by it: the overlap tail belongs to
    the next stripe, the last stripe owns through the record's end. Every
    record byte is owned by exactly one row, in (segment, stripe) order."""
    return torch.where(
        plan["is_last"], plan["stripe_len"], plan["stripe_len"].clamp(max=plan["step"])
    ).to(torch.int32)


def seg_any(verdict: torch.Tensor, plan: dict, n: int) -> torch.Tensor:
    """Per-segment OR of per-stripe verdicts (a max over the sorted
    segment ids)."""
    x = (verdict & plan["row_live"]).to(torch.int32)
    out = torch.zeros((n,), dtype=torch.int32, device=x.device)
    return out.scatter_reduce(0, plan["seg"].to(torch.int64), x, "amax") > 0


def _dfa_device(dfa, device):
    """(byte_class i32[256], table_t i32[C, S], flat table i64[S*C],
    accept bool[S]) on ``device``, uploaded once per device."""
    key = f"striped:{device}"
    tables = dfa.device_tables.get(key)
    if tables is None:
        tables = (
            torch.from_numpy(dfa.byte_class.astype(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(dfa.table.T, dtype=np.int32)).to(device),
            torch.from_numpy(dfa.table.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(dfa.accept.astype(bool)).to(device),
        )
        dfa.device_tables[key] = tables
    return tables


def stripe_classes(sv: torch.Tensor, plan: dict, dfa, span=None) -> torch.Tensor:
    """Class symbols i32[r, s] of every row's OWNED bytes, -1 (identity)
    elsewhere: the input of the record-level DFA chain. With ``span`` =
    (vst, vln), only the owned bytes inside each segment's field span
    [vst, vst+vln) keep their class: the input of the in-span chain."""
    byte_class = _dfa_device(dfa, sv.device)[0]
    jidx = torch.arange(sv.shape[1], dtype=torch.int32, device=sv.device)[None, :]
    keep = jidx < owned_lengths(plan)[:, None]
    if span is not None:
        lo, hi = _span_bounds(plan, *span)
        abs_pos = plan["abs_start"][:, None] + jidx
        keep &= (abs_pos >= lo[:, None]) & (abs_pos < hi[:, None])
    # an int32 index keeps the lookup free of an int64 temporary of the
    # matrix's size
    return torch.where(keep, byte_class[sv.to(torch.int32)], -1)


def striped_dfa_verdict(sv: torch.Tensor, plan: dict, dfa, kmax: int) -> torch.Tensor:
    """Regex match per segment by chaining DFA state across stripes: each
    row's OWNED bytes reduce to one transition function, rows compose in
    segment order, EOS applies once (`seg_dfa_accept`). Un-owned columns
    compose as identity, so no overlap containment is needed."""
    return seg_dfa_accept(stripe_classes(sv, plan, dfa), plan, dfa, kmax)


def seg_dfa_accept(cls: torch.Tensor, plan: dict, dfa, kmax: int) -> torch.Tensor:
    """Segment verdicts from per-position classes i32[r, s] (-1 =
    identity): per-row composition (the kernel), then each segment's rows
    folded in order — row j of the segment composes where ``j < k``, which
    equals the JAX package's segmented associative scan by associativity —
    one EOS step per segment and the accept check. ``kmax`` (>= every
    segment's stripe count) comes from the host, so nothing waits on the
    card."""
    r = cls.shape[0]
    _, table_t, table_flat, accept = _dfa_device(dfa, cls.device)
    rowf = cuda_kernels.dfa_compose_columns(cls.contiguous(), table_t)  # [r, S]
    first = plan["first_row"].to(torch.int64)
    k = plan["k"]
    f = rowf[first.clamp(0, r - 1)]
    for j in range(1, max(kmax, 1)):
        nxt = rowf[(first + j).clamp(0, r - 1)]
        f = torch.where((j < k)[:, None], kernels.dfa_compose(f, nxt), f)
    state = f[:, dfa.start].to(torch.int64)
    state = table_flat[state * dfa.n_classes + dfa.eos_class]
    return accept[state] & (k > 0)


def _span_bounds(plan: dict, vst: torch.Tensor, vln: torch.Tensor):
    """Each stripe row's segment field span [lo, hi) (record-absolute)."""
    seg = plan["seg"].to(torch.int64)
    lo = vst.to(torch.int32)[seg]
    return lo, lo + vln.to(torch.int32)[seg]


def striped_dfa_in_span(sv, plan: dict, dfa, vst, vln, kmax: int) -> torch.Tensor:
    """Regex match per segment INSIDE a JsonGet field span [vst, vst+vln):
    the same cross-stripe chain with the classes outside the span (or
    un-owned) as identity, so the composition covers exactly the field
    bytes. A missing or empty field composes pure identity and EOS tests
    the empty string, as the narrow extract's ``b""`` does."""
    return seg_dfa_accept(stripe_classes(sv, plan, dfa, (vst, vln)), plan, dfa, kmax)


def striped_json_span(sv, plan: dict, lengths, key: str, kmax: int):
    """Per-SEGMENT JsonGet field span over the stripe rows: record-absolute
    (start, length) view descriptors, the machine's state carried from
    each stripe into the next (`cuda_kernels.striped_json_span`)."""
    return cuda_kernels.striped_json_span(
        sv.contiguous(), owned_lengths(plan).contiguous(),
        plan["first_row"].contiguous(), plan["k"].contiguous(),
        lengths.to(torch.int32).contiguous(), key, kmax, plan["step"],
    )


def striped_literal_in_span(sv, plan: dict, lit: bytes, vst, vln, kind: str, n: int):
    """Literal predicate INSIDE a per-segment field span [vst, vst+vln).

    Per stripe row the windowed compare runs at OWNED byte positions; a
    window of <= overlap bytes starting at an owned byte lies wholly in its
    row, so the per-row verdict OR per segment is exact. ``kind``:
    contains | startswith | endswith | equals (pinned to the span's
    bounds)."""
    r, s = sv.shape
    k = len(lit)
    dev = sv.device
    if k == 0:
        # an empty literal matches every field, except that "equals" (an
        # anchored-empty regex) still needs the field to be empty
        if kind == "equals":
            return vln.to(torch.int32) == 0
        return torch.ones((n,), dtype=torch.bool, device=dev)
    if k > s:
        return torch.zeros((n,), dtype=torch.bool, device=dev)
    lo, hi = _span_bounds(plan, vst, vln)
    span = s - k + 1
    acc = torch.ones((r, span), dtype=torch.bool, device=dev)
    for i, b in enumerate(lit):
        acc &= sv[:, i : i + span] == b
    jidx = torch.arange(span, dtype=torch.int32, device=dev)[None, :]
    abs_pos = plan["abs_start"][:, None] + jidx
    owned = jidx < owned_lengths(plan)[:, None]
    fits = jidx + k <= plan["stripe_len"][:, None]
    in_span = (abs_pos >= lo[:, None]) & (abs_pos + k <= hi[:, None])
    if kind in ("startswith", "equals"):
        in_span &= abs_pos == lo[:, None]
    elif kind == "endswith":
        in_span &= abs_pos + k == hi[:, None]
    hit = seg_any((acc & owned & fits & in_span).any(dim=1), plan, n)
    if kind == "equals":
        hit &= vln.to(torch.int32) == k
    return hit


def seg_state_of(plan: dict, sv: torch.Tensor, lengths: torch.Tensor, arrays: dict) -> dict:
    """Segment-level state: full record lengths and the first stripe's
    bytes, beside the un-striped meta columns. Narrow lowerings over it
    are exact for length, key and const expressions."""
    r = sv.shape[0]
    live = plan["k"] > 0
    seg_values = sv[plan["first_row"].to(torch.int64).clamp(0, r - 1)]
    return {
        "values": torch.where(live[:, None], seg_values, 0),
        "lengths": lengths.to(torch.int32),
        "keys": arrays["keys"],
        "key_lengths": arrays["key_lengths"],
        "offset_deltas": arrays["offset_deltas"],
        "timestamp_deltas": arrays["timestamp_deltas"],
    }


# ---------------------------------------------------------------------------
# Build-time lowering
# ---------------------------------------------------------------------------

_SEG_EXACT_NODES = (
    dsl.Cmp, dsl.Len, dsl.ParseInt, dsl.Value, dsl.Key, dsl.Const,
    dsl.Upper, dsl.Lower, dsl.And, dsl.Or, dsl.Not, dsl.Contains,
    dsl.StartsWith, dsl.EndsWith,
)
_KINDS = {dsl.Contains: "contains", dsl.StartsWith: "startswith", dsl.EndsWith: "endswith"}


def _check_seg_exact(expr) -> None:
    """Whitelist for expressions evaluated on the segment-level state:
    length, key and const reads; anything that reads the record bytes
    structurally (JsonGet, Concat, regex, value searches) is refused."""
    if not isinstance(expr, _SEG_EXACT_NODES):
        raise Unlowerable(f"{type(expr).__name__} not stripeable")
    for f in ("arg", "left", "right"):
        sub = getattr(expr, f, None)
        if isinstance(sub, dsl.Expr):
            _check_seg_exact(sub)
    for sub in getattr(expr, "args", []) or []:
        _check_seg_exact(sub)
    if isinstance(expr, (dsl.Contains, dsl.StartsWith, dsl.EndsWith)):
        if _value_postops(expr.arg) is not None:
            raise Unlowerable("value search must lower striped")


def _value_postops(arg) -> Optional[Tuple[str, ...]]:
    """``arg`` as a fold chain over the record value (``Upper(Lower(
    Value()))`` -> ("lower", "upper")); None for key/const sources (exact
    on the segment state); raises for any other source."""
    if isinstance(arg, dsl.Value):
        return ()
    if isinstance(arg, (dsl.Upper, dsl.Lower)):
        inner = _value_postops(arg.arg)
        if inner is None:
            return None
        return inner + ("upper" if isinstance(arg, dsl.Upper) else "lower",)
    if isinstance(arg, (dsl.Key, dsl.Const)):
        return None
    raise Unlowerable(f"{type(arg).__name__} not stripeable as a byte source")


def _jsonget_source(arg):
    """``arg`` as a fold-wrapped single-level JsonGet over the record
    value: ``(key, pre, outer)`` — ``pre`` the folds inside the JsonGet
    (the machine must see them), ``outer`` those applied to the field.
    None when the source is no JsonGet; raises for a nested one."""
    outer: List[str] = []
    expr = arg
    while isinstance(expr, (dsl.Upper, dsl.Lower)):
        outer.append("upper" if isinstance(expr, dsl.Upper) else "lower")
        expr = expr.arg
    if not isinstance(expr, dsl.JsonGet):
        return None
    pre = _value_postops(expr.arg)
    if pre is None:
        raise Unlowerable("striped JsonGet must read the record value")
    outer.reverse()
    return expr.key, pre, tuple(outer)


def _cached_json_span(ctx: dict, key: str, pre):
    """Run the span machine once per batch for each (key, folds) source,
    however many predicates and maps read it. An entry holds the stripe
    bytes it was computed from and is valid only while ``ctx["sv"]`` is
    that very tensor (a fold stage in between rebinds it)."""
    cache = ctx.setdefault("_span_cache", {})
    ck = (key, tuple(pre))
    hit = cache.get(ck)
    if hit is None or hit[0] is not ctx["sv"]:
        sv_pre = apply_postops(ctx["sv"], pre)
        span = striped_json_span(sv_pre, ctx["plan"], ctx["seg_state"]["lengths"], key, ctx["kmax"])
        hit = cache[ck] = (ctx["sv"], sv_pre, span)
    return hit[1], hit[2]


def _literal_kind(info) -> Tuple[bytes, str]:
    lit, a_start, a_end = info
    if a_start and a_end:
        return lit, "equals"
    if a_start:
        return lit, "startswith"
    if a_end:
        return lit, "endswith"
    return lit, "contains"


def _lower_striped_json_literal(kind: str, lit: bytes, key: str, pre, outer, v: int):
    """A literal predicate over a JsonGet field: the span machine gives
    the field's record-absolute span, the literal windows inside it. The
    field can start anywhere, so every kind needs the overlap."""
    if len(lit) > v:
        raise Unlowerable(f"JsonGet-sourced literal of {len(lit)} bytes exceeds the overlap ({v})")

    def fn(ctx):
        sv_pre, (vst, vln) = _cached_json_span(ctx, key, pre)
        # outer folds keep lengths, so the span positions stay valid
        sv_m = apply_postops(sv_pre, outer)
        return striped_literal_in_span(sv_m, ctx["plan"], lit, vst, vln, kind, ctx["n"])

    return fn


def _lower_striped_literal(kind: str, lit: bytes, postops, s: int, v: int):
    """A literal predicate over the stripe bytes: windows up to the overlap
    are whole in some stripe, so the per-stripe OR is exact; anchored
    forms also pin the first (last) stripe and, for equals, the length."""
    limit = s if kind in ("startswith", "equals") else v
    if len(lit) > limit:
        raise Unlowerable(f"literal of {len(lit)} bytes exceeds the stripe limit ({limit})")

    def fn(ctx):
        sv = apply_postops(ctx["sv"], postops)
        plan, n = ctx["plan"], ctx["n"]
        slen = plan["stripe_len"]
        if kind == "contains":
            return seg_any(kernels.literal_search(sv, slen, lit), plan, n)
        if kind == "endswith":
            return seg_any(kernels.literal_endswith(sv, slen, lit) & plan["is_last"], plan, n)
        row = kernels.literal_startswith(sv, slen, lit) & (plan["stripe_idx"] == 0)
        hit = seg_any(row, plan, n)
        if kind == "equals":
            hit &= ctx["seg_state"]["lengths"] == len(lit)
        return hit

    return fn


def _literal_regex(lit: bytes, kind: str) -> str:
    """A literal predicate as an equivalent regex (every byte \\xhh-escaped)
    for the DFA chain that takes literals past the overlap."""
    body = "".join(f"\\x{b:02x}" for b in lit)
    pre = "^" if kind in ("startswith", "equals") else ""
    post = "$" if kind in ("endswith", "equals") else ""
    return pre + body + post


def _striped_dfa(pattern: str):
    """Compile a DFA for the cross-stripe chain. Every table the compiler
    emits composes on the card (`cuda_kernels.dfa_compose_columns` takes
    up to 257 states and 258 classes), so the JAX package's TPU cost gate
    on states and classes has no counterpart here; only a pattern the
    compiler refuses is unstripeable."""
    try:
        return compile_regex_cached(pattern)
    except UnsupportedRegex as e:
        raise Unlowerable(str(e)) from e


def _lower_striped_dfa(pattern: str, postops):
    dfa = _striped_dfa(pattern)

    def fn(ctx):
        sv = apply_postops(ctx["sv"], postops)
        return striped_dfa_verdict(sv, ctx["plan"], dfa, ctx["kmax"])

    return fn


def _lower_striped_dfa_in_span(pattern: str, key: str, pre, outer):
    dfa = _striped_dfa(pattern)

    def fn(ctx):
        sv_pre, (vst, vln) = _cached_json_span(ctx, key, pre)
        sv_m = apply_postops(sv_pre, outer)
        return striped_dfa_in_span(sv_m, ctx["plan"], dfa, vst, vln, ctx["kmax"])

    return fn


def _lower_byte_predicate(kind: str, lit: bytes, pattern: Optional[str], arg, s: int, v: int):
    """A literal (``pattern`` None) or regex predicate over ``arg``: the
    windowed compare where the literal fits, the DFA chain otherwise,
    inside a JsonGet field span when ``arg`` is one."""
    json_src = _jsonget_source(arg)
    if json_src is not None:
        key, pre, outer = json_src
        if lit is not None:
            try:
                return _lower_striped_json_literal(kind, lit, key, pre, outer, v)
            except Unlowerable:
                pass  # past the overlap: in-span DFA below
        return _lower_striped_dfa_in_span(pattern or _literal_regex(lit, kind), key, pre, outer)
    postops = _value_postops(arg)
    if postops is None:
        raise Unlowerable("striped regex must read the record value")
    if lit is not None:
        try:
            return _lower_striped_literal(kind, lit, postops, s, v)
        except Unlowerable:
            pass  # past the limit: chain it as a DFA instead
    return _lower_striped_dfa(pattern or _literal_regex(lit, kind), postops)


def lower_striped_predicate(expr, s: int, v: int, exact: bool = False) -> Callable:
    """Lower a filter predicate to fn(ctx) -> bool[n] (segment level).
    ``ctx`` carries ``sv`` (stripe bytes, upstream folds applied),
    ``plan``, ``seg_state``, ``n`` and ``kmax``. With ``exact`` a
    comparison reads the whole record (the interpreter's answer) where the
    JAX package's rule reads its first stripe."""
    if isinstance(expr, (dsl.And, dsl.Or)):
        fns = [lower_striped_predicate(a, s, v, exact) for a in expr.args]
        is_and = isinstance(expr, dsl.And)

        def bool_fn(ctx):
            out = fns[0](ctx)
            for f in fns[1:]:
                out = (out & f(ctx)) if is_and else (out | f(ctx))
            return out

        return bool_fn
    if isinstance(expr, dsl.Not):
        inner = lower_striped_predicate(expr.arg, s, v, exact)
        return lambda ctx: ~inner(ctx)
    if isinstance(expr, dsl.Cmp):
        if not exact and infer_type(expr.left) == "int" and infer_type(expr.right) == "int":
            try:
                # the JAX package's rule: exact on the segment state, its
                # first-stripe prefix parse included
                _check_seg_exact(expr)
                fn = lower_expr(expr)
                return lambda ctx: fn(ctx["seg_state"])
            except Unlowerable:
                pass
        return _lower_striped_cmp(expr)
    if isinstance(expr, (dsl.Contains, dsl.StartsWith, dsl.EndsWith)):
        kind = _KINDS[type(expr)]
        if _jsonget_source(expr.arg) is None and _value_postops(expr.arg) is None:
            _check_seg_exact(expr)  # key/const source: exact on the segment state
            fn = lower_expr(expr)
            return lambda ctx: fn(ctx["seg_state"])
        return _lower_byte_predicate(kind, expr.literal, None, expr.arg, s, v)
    if isinstance(expr, dsl.RegexMatch):
        info = literal_of(expr.pattern)
        lit, kind = _literal_kind(info) if info is not None else (None, "contains")
        return _lower_byte_predicate(kind, lit, expr.pattern, expr.arg, s, v)
    raise Unlowerable(f"{type(expr).__name__} not stripeable as a predicate")


def _striped_view(value):
    """Classify a striped map value: ``("postops", ops)`` for a fold chain
    over the record value, ``("span", key, pre, total)`` for a single-level
    JsonGet view (``pre`` the folds the machine sees, ``total`` all the
    folds the host applies). Anything else raises Unlowerable."""
    outer: List[str] = []
    expr = value
    while isinstance(expr, (dsl.Upper, dsl.Lower)):
        outer.append("upper" if isinstance(expr, dsl.Upper) else "lower")
        expr = expr.arg
    outer.reverse()  # application order is innermost-first
    if isinstance(expr, dsl.JsonGet):
        pre = _value_postops(expr.arg)
        if pre is None:
            raise Unlowerable("striped JsonGet must read the record value")
        return ("span", expr.key, pre, pre + tuple(outer))
    post = _value_postops(value)
    if post is None:
        raise Unlowerable("striped map must transform the record value")
    return ("postops", post)


def _make_span_fn(key: str, pre: Tuple[str, ...]):
    def fn(ctx):
        return _cached_json_span(ctx, key, pre)[1]

    return fn


# ---------------------------------------------------------------------------
# Computed maps: key rewrites and values built from fields
# ---------------------------------------------------------------------------


class NarrowOverflow(Exception):
    """A striped computed map met a field wider than a narrow column
    holds (`buffer.MAX_WIDTH`); the executor raises its `GpuSpill`."""


def striped_field_bytes(sv: torch.Tensor, plan: dict, vst: torch.Tensor, vln: torch.Tensor,
                        width: int) -> torch.Tensor:
    """u8[n, width]: each segment's bytes [vst, vst + vln), gathered from
    the rows that own them (any number of seams), zero past the length."""
    r, s = sv.shape
    n = vst.shape[0]
    dev = sv.device
    j = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    seg = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    flat = _owner_flat(vst.to(torch.int64)[:, None] + j, seg, plan["first_row"], plan["k"],
                       plan["step"], r, s)
    return torch.where(j < vln.to(torch.int64)[:, None], sv.reshape(-1)[flat], 0)


def restripe_field(sv: torch.Tensor, plan: dict, vst: torch.Tensor, vln: torch.Tensor,
                   host_lengths: np.ndarray, params: StripeParams, srows: int):
    """(plan, sv u8[srows, s], kmax): each segment's bytes [vst, vst + vln)
    of ``sv``'s rows, gathered from the rows that own them and cut into
    stripe rows of their own, as `stage_rows` cuts records (a field past
    the stripe threshold, which the rest of the chain reads as its
    record). ``host_lengths`` are ``vln`` on the host."""
    s, v = params.width, params.overlap
    n = vln.shape[0]
    dev = sv.device
    out = plan_device(vln, torch.ones((n,), dtype=torch.bool, device=dev), srows, s, v)
    j = torch.arange(s, dtype=torch.int64, device=dev)[None, :]
    seg = out["seg"].to(torch.int64)[:, None]
    pos = vst.to(torch.int64)[seg] + out["abs_start"].to(torch.int64)[:, None] + j
    flat = _owner_flat(pos, seg, plan["first_row"], plan["k"], plan["step"], *sv.shape)
    keep = (j < out["stripe_len"].to(torch.int64)[:, None]) & out["row_live"][:, None]
    kmax = int(stripe_counts(host_lengths, s, v).max()) if n else 1
    return out, torch.where(keep, sv.reshape(-1)[flat], 0), kmax


def _value_folds(arg) -> Optional[Tuple[str, ...]]:
    """``arg``'s folds when it is a fold chain over the record value, else
    None (a key or const source, or any other expression)."""
    try:
        return _value_postops(arg)
    except Unlowerable:
        return None


def _bind_record_reads(expr, binds: list):
    """``expr`` with each read of the wide record's bytes bound to a
    narrow column (`lower.Column`), the binding appended to ``binds``:
    a single-level JsonGet over folds of the value to its field's bytes
    (``("field", name, key, folds)``), an integer parse of the value to
    the parse over the whole record (``("int", name)``). Key, const and
    length reads stay: they are exact on the segment state. The value's
    own bytes, which no narrow column holds, raise."""
    if isinstance(expr, dsl.JsonGet):
        pre = _value_postops(expr.arg)  # raises for a nested JsonGet
        if pre is None:
            raise Unlowerable("striped JsonGet must read the record value")
        name = f"_field{len(binds)}"
        binds.append(("field", name, expr.key, pre))
        return Column(name=name)
    if isinstance(expr, dsl.Len) and _value_folds(expr.arg) is not None:
        return expr  # the segment state's lengths are the records'
    if isinstance(expr, dsl.ParseInt) and _value_folds(expr.arg) is not None:
        name = f"_int{len(binds)}"
        binds.append(("int", name))  # case folds change no digit, sign or space
        return Column(name=name, kind="int")
    if isinstance(expr, (dsl.Key, dsl.Const)):
        return expr
    if isinstance(expr, dsl.IntToBytes):
        # a bytes argument reads as its leading integer (`lower.as_int_expr`)
        return dataclasses.replace(expr, arg=_bind_record_reads(as_int_expr(expr.arg), binds))
    if isinstance(expr, (dsl.Upper, dsl.Lower, dsl.Len, dsl.ParseInt)):
        return dataclasses.replace(expr, arg=_bind_record_reads(expr.arg, binds))
    if isinstance(expr, dsl.Concat):
        return dataclasses.replace(expr, args=[_bind_record_reads(a, binds) for a in expr.args])
    if isinstance(expr, dsl.Value):
        raise Unlowerable("a striped computed map cannot output the whole record")
    raise Unlowerable(f"{type(expr).__name__} not stripeable in a computed map")


def narrow_field(sv: torch.Tensor, plan: dict, vst: torch.Tensor, vln: torch.Tensor,
                 what: str):
    """(values u8[n, w], lengths i32[n]): each segment's bytes [vst, vst +
    vln) as a narrow column, ``w`` the power of two above the longest.
    Raises `NarrowOverflow` past what a narrow column holds
    (`buffer.MAX_WIDTH`); ``what`` names the value in the message. The
    longest length is read on the host, one wait on the card."""
    longest = int(vln.max()) if vln.numel() else 0
    if longest > MAX_WIDTH:
        raise NarrowOverflow(f"{what} of {longest} bytes exceeds a narrow column ({MAX_WIDTH})")
    width = 1 << max(longest - 1, 0).bit_length()
    return striped_field_bytes(sv, plan, vst, vln, width), vln.to(torch.int32)


def _fill_binds(ctx: dict, st: dict, binds: list) -> None:
    """Put the narrow column of each binding of `_bind_record_reads` (and
    of `_bind_cmp_operand`'s record prefixes, which go last) in ``st``."""
    for b in binds:
        if b[0] == "int":
            st[b[1]] = striped_parse_int(ctx["sv"], ctx["plan"],
                                         torch.zeros_like(st["lengths"]), st["lengths"], ctx["n"])
        elif b[0] == "field":
            _, name, key, pre = b
            sv_pre, (vst, vln) = _cached_json_span(ctx, key, pre)
            st[name] = narrow_field(sv_pre, ctx["plan"], vst, vln, f"field {key!r}")
        else:  # ("prefix", name, folds, the other operand's fn)
            _, name, folds, other = b
            # the record's first w + 1 bytes order it against any operand
            # of at most w bytes as the whole record does
            width = other(st)[0].shape[1] + 1
            keep = torch.clamp(st["lengths"], max=width)
            st[name] = (striped_field_bytes(apply_postops(ctx["sv"], folds), ctx["plan"],
                                            torch.zeros_like(keep), keep, width),
                        keep.to(torch.int32))


def _bind_cmp_operand(expr, binds: list, prefixes: list):
    """A comparison operand with its reads of the wide record bound to
    narrow columns: a fold chain over the record value (bytes order) to a
    prefix of the record (`_fill_binds`), queued in ``prefixes`` until the
    other operand is bound; everything else as `_bind_record_reads` binds
    it (JsonGet fields, the whole record's leading integer, lengths)."""
    folds = _value_folds(expr)
    if folds is not None and infer_type(expr) == "bytes":
        name = f"_prefix{len(binds) + len(prefixes)}"
        prefixes.append((name, folds))
        return Column(name=name)
    return _bind_record_reads(expr, binds)


def _lower_striped_cmp(expr) -> Callable:
    """fn(ctx) -> bool[n]: a comparison whose operands read the wide
    record, exact at any record width. Each operand is bound to narrow
    columns (`_bind_cmp_operand`): a JsonGet field gathered from the
    stripes, an integer parsed over the whole record, or, for the record
    value itself in bytes order, its first ``w + 1`` bytes, ``w`` the
    other operand's width (a narrow key, constant or field); then the
    narrow comparison runs on the segment state. Two reads of the record
    value itself have no narrow column to compare against."""
    left, right, _ = cmp_operands(expr)  # bound, the operands keep their types
    binds: list = []
    prefixes: list = []
    bound = [_bind_cmp_operand(e, binds, prefixes) for e in (left, right)]
    if len(prefixes) > 1:
        raise Unlowerable("a comparison of the record value with itself")
    if prefixes:
        name, folds = prefixes[0]
        other = bound[1] if bound[0] == Column(name=name) else bound[0]
        binds.append(("prefix", name, folds, lower_expr(other)))
    return _on_bound_state(lower_expr(dataclasses.replace(expr, left=bound[0], right=bound[1])),
                           binds)


def _on_bound_state(fn: Callable, binds: list) -> Callable:
    """fn(ctx): ``fn`` over a copy of the segment state that holds the
    narrow columns of ``binds`` (`_fill_binds`)."""
    def run(ctx):
        st = ctx["seg_state"].copy()
        _fill_binds(ctx, st, binds)
        return fn(st)

    return run


def _lower_computed_map(prog, bind: bool) -> Callable:
    """fn(ctx) rewriting ``ctx["seg_state"]``'s value (and key) by the
    narrow lowering, as the narrow map stage does: ``bind`` for the
    chain's first computed map, whose record reads are bound to columns
    built per batch (fields gathered from the stripes, each at the power
    of two above its longest); after it the segment state is narrow and
    whole, so later maps lower on it as they are."""
    binds: list = []
    exprs = [prog.value] + ([prog.key] if prog.key is not None else [])
    if bind:
        exprs = [_bind_record_reads(e, binds) for e in exprs]
    fns = [lower_expr(e) for e in exprs]

    def fn(ctx):
        st = ctx["seg_state"].copy()
        _fill_binds(ctx, st, binds)
        out = ctx["seg_state"]
        v, ln = fns[0](st)
        out["values"], out["lengths"] = v, ln.to(torch.int32)
        if len(fns) > 1:
            kv, kl = fns[1](st)
            out["keys"], out["key_lengths"] = kv, kl.to(torch.int32)

    return fn


def _check_contribution(prog) -> None:
    """An aggregate's contribution must be exact on the segment state:
    length, key and const reads and the stripe-0 prefix parse of the
    canned kinds; a JsonGet contribution (``aggregate-field``) is not."""
    if prog.contribution is not None:
        _check_seg_exact(prog.contribution)
    elif prog.kind == "word_count":
        # per-stripe word counts double-count tokens spanning the overlap
        raise Unlowerable("word_count is not stripeable")


# ---------------------------------------------------------------------------
# Contributions over a per-segment byte range
# ---------------------------------------------------------------------------


def _range_grid(sv: torch.Tensor, plan: dict, lo: torch.Tensor, hi: torch.Tensor):
    """(in range bool[r, s], record-absolute position i64[r, s], segment
    i64[r]): the owned bytes of each row that fall in its segment's byte
    range [lo, hi)."""
    seg = plan["seg"].to(torch.int64)
    jidx = torch.arange(sv.shape[1], dtype=torch.int64, device=sv.device)[None, :]
    pos = plan["abs_start"].to(torch.int64)[:, None] + jidx
    inr = ((jidx < owned_lengths(plan)[:, None]) & (pos >= lo.to(torch.int64)[seg][:, None])
           & (pos < hi.to(torch.int64)[seg][:, None]))
    return inr, pos, seg


def _seg_reduce(x: torch.Tensor, seg: torch.Tensor, n: int, how: str, init: int) -> torch.Tensor:
    """Per-segment ``how`` ("amin" | "amax" | "sum") of per-row values."""
    out = torch.full((n,), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg, x, how)


def _byte_at(sv: torch.Tensor, plan: dict, pos: torch.Tensor) -> torch.Tensor:
    """The byte at record-absolute ``pos`` i64[n] of each segment, read from
    the row that owns it (positions outside the record read a clamped
    byte: callers mask them)."""
    r, s = sv.shape
    seg = torch.arange(pos.shape[0], dtype=torch.int64, device=sv.device)
    return sv.reshape(-1)[_owner_flat(pos, seg, plan["first_row"], plan["k"], plan["step"], r, s)]


def _owner_flat(pos, seg, first_row, k, step: int, r: int, s: int) -> torch.Tensor:
    """Flat index into the ``[r, s]`` stripe grid of the row that OWNS
    record-absolute byte ``pos`` of segment ``seg`` (row ``pos // step``,
    the last row past it), clamped into the grid."""
    pos = pos.to(torch.int64)
    kk = k.to(torch.int64)[seg]
    j = torch.minimum(torch.div(pos, step, rounding_mode="floor"), kk - 1).clamp(min=0)
    flat = (first_row.to(torch.int64)[seg] + j) * s + (pos - j * step)
    return flat.clamp(0, r * s - 1)


def striped_count_words(sv: torch.Tensor, plan: dict, lo: torch.Tensor, hi: torch.Tensor,
                        n: int) -> torch.Tensor:
    """``len(bytes.split())`` of each segment's bytes [lo, hi), i64[n]: the
    token starts among the owned bytes, a token starting where the byte
    before it in record order is whitespace (``bytes.split()``'s set, VT
    and FF included) or where the range starts. Column 0's predecessor is
    the previous row's last owned byte, so a token across a seam counts
    once."""
    inr, pos, seg = _range_grid(sv, plan, lo, hi)
    ws = kernels._is_ws(sv)
    step = plan["step"]
    col0_prev = torch.cat([torch.ones((1,), dtype=torch.bool, device=sv.device),
                           ws[:-1, step - 1]])
    prev_ws = torch.cat([col0_prev[:, None], ws[:, :-1]], dim=1)
    starts = inr & ~ws & (prev_ws | (pos == lo.to(torch.int64)[seg][:, None]))
    return _seg_reduce(starts.sum(dim=1), seg, n, "sum", 0)


def striped_parse_int(sv: torch.Tensor, plan: dict, lo: torch.Tensor, hi: torch.Tensor,
                      n: int) -> torch.Tensor:
    """`dsl.parse_int_prefix` of each segment's bytes [lo, hi), i64[n], on
    the narrow `kernels.parse_int`'s arithmetic: skip space, tab, CR and LF,
    an optional sign, then the digit run, wrapping in int64 (only the run's
    last 64 digits can reach the wrapped value). The skip and the run may
    cross any number of seams."""
    inr, pos, seg = _range_grid(sv, plan, lo, hi)
    big = torch.iinfo(torch.int64).max
    hi64 = hi.to(torch.int64)
    ws4 = (sv == 32) | (sv == 9) | (sv == 13) | (sv == 10)
    first = _seg_reduce(torch.where(inr & ~ws4, pos, big).amin(dim=1), seg, n, "amin", big)
    first = torch.minimum(first, hi64)
    c0 = _byte_at(sv, plan, first)
    sign = (first < hi64) & ((c0 == 0x2B) | (c0 == 0x2D))
    neg = sign & (c0 == 0x2D)
    ds = first + sign.to(torch.int64)
    is_digit = (sv >= 0x30) & (sv <= 0x39)
    after = inr & (pos >= ds[seg][:, None])
    end = _seg_reduce(torch.where(after & ~is_digit, pos, big).amin(dim=1), seg, n, "amin", big)
    end = torch.minimum(end, hi64)
    end_r = end[seg][:, None]
    run = after & (pos < end_r) & (pos >= end_r - kernels._PARSE_WINDOW)
    weights = kernels._pow10_wrapped(kernels._PARSE_WINDOW, sv.device)
    k = (end_r - 1 - pos).clamp(0, kernels._PARSE_WINDOW - 1)
    terms = torch.where(run, (sv.to(torch.int64) - 0x30) * weights[k], 0)
    num = _seg_reduce(terms.sum(dim=1), seg, n, "sum", 0)
    return torch.where(neg, -num, num)


def _whole_record(ctx: dict):
    lengths = ctx["seg_state"]["lengths"]
    return torch.zeros_like(lengths), lengths


def _span_range(key: str, pre):
    def fn(ctx):
        _sv, (vst, vln) = _cached_json_span(ctx, key, pre)
        return vst, vst + vln
    return fn


def _range_contribution(kind: str, range_fn):
    """fn(ctx) -> i64[n]: a word count (``kind`` "words") or an integer
    parse ("int") over each segment's byte range ``range_fn(ctx)``."""
    op = striped_count_words if kind == "words" else striped_parse_int

    def fn(ctx):
        lo, hi = range_fn(ctx)
        return op(ctx["sv"], ctx["plan"], lo, hi, ctx["n"])

    return fn


def _bound_contribution(expr) -> Callable:
    """fn(ctx) -> i64[n]: an integer contribution with its record reads
    bound to narrow columns (`_bind_record_reads`); the leading integer of
    a JsonGet field is parsed over the field's bytes in the stripes, at
    any width."""
    if isinstance(expr, dsl.ParseInt):
        src = _jsonget_source(expr.arg)
        if src is not None:  # case folds change no digit, sign or whitespace byte
            return _range_contribution("int", _span_range(src[0], src[1]))
    binds: list = []
    return _on_bound_state(lower_expr(_bind_record_reads(expr, binds)), binds)


def _striped_contribution(prog, span_src, first_agg: bool,
                          exact: bool = False) -> Optional[Callable]:
    """How a striped aggregate gets its contribution: None where the
    segment state gives it exactly (the stage's own contribution, the JAX
    package's rule, its first-stripe prefix parse included), else fn(ctx)
    -> i64[n] over a byte range of the stripes. ``span_src`` is the
    (key, folds) of the chain's span map, None without one. Only the
    chain's first aggregate reads the record: a later one reads the
    decimals its predecessor rendered, whole in the segment state. With
    ``exact`` an integer parse of the record reads the whole record (the
    interpreter's answer), never only its first stripe."""
    if not first_agg:
        _check_contribution(prog)
        return None
    if prog.contribution is not None:
        if span_src is not None:
            raise Unlowerable("a custom contribution after a striped span map")
        if exact or infer_type(prog.contribution) != "int":
            # a bytes contribution reads as its leading integer, over the
            # whole record or field (the JAX native backend's rule)
            return _bound_contribution(as_int_expr(prog.contribution))
        try:
            _check_seg_exact(prog.contribution)
            return None
        except Unlowerable:
            if not isinstance(prog.contribution, dsl.ParseInt):
                raise
            src = _jsonget_source(prog.contribution.arg)
            if src is None:
                raise
            # case folds change no digit, sign or whitespace byte
            return _range_contribution("int", _span_range(src[0], src[1]))
    if prog.kind == "count":
        return None
    if prog.kind == "word_count":
        rng = _whole_record if span_src is None else _span_range(*span_src)
        return _range_contribution("words", rng)
    if span_src is not None:  # sum_int / max_int / min_int of the span's bytes
        return _range_contribution("int", _span_range(*span_src))
    if exact:
        return _range_contribution("int", _whole_record)
    return None


# ---------------------------------------------------------------------------
# Striped JSON-array explode
# ---------------------------------------------------------------------------

# the explode's string state: 0 outside a string, 1 inside, 2 inside after a
# backslash. A byte acts on the three as a map, coded f(0) + 3 f(1) + 9 f(2)
_STR_IDENTITY = 0 + 3 * 1 + 9 * 2  # a byte outside the array's body
_STR_QUOTE = 1 + 3 * 0 + 9 * 1
_STR_BACKSLASH = 0 + 3 * 2 + 9 * 1
_STR_OTHER = 0 + 3 * 1 + 9 * 1
_STR_RESET = 0  # the opening bracket: every state to outside


def _str_compose_table() -> np.ndarray:
    """``table[g * 27 + f]`` = the code of g after f."""
    out = np.zeros(27 * 27, dtype=np.int32)
    for g in range(27):
        gi = (g % 3, g // 3 % 3, g // 9)
        for f in range(27):
            fi = (f % 3, f // 3 % 3, f // 9)
            out[g * 27 + f] = sum(gi[fi[x]] * 3 ** x for x in range(3))
    return out


_STR_COMPOSE = _str_compose_table()


def striped_json_array_bounds(sv: torch.Tensor, owned: torch.Tensor, first_row: torch.Tensor,
                              k: torch.Tensor, step: int):
    """Element grid of `dsl.json_array_elements` over the stripe rows: the
    plain torch version of ``csrc/json_array.cu`` (same arguments, same
    outputs, bit for bit).

    Each segment's bytes are read in record order over the bytes each row
    OWNS (the overlap tail belongs to the next row). The outer first and
    last non-whitespace bytes must be ``[`` and ``]`` (``err`` where not);
    inside, a quote opens or closes a string, a backslash in a string skips
    the next byte (across a seam too), brackets and braces outside strings
    move the depth, and a comma at depth 0 outside strings ends an element,
    as does the closing bracket. Each element is trimmed of
    ``bytes.strip()``'s whitespace and of its quotes when fully quoted;
    empty ones are dropped. Returns (flag bool[r, s], abs_start i32[r, s],
    elen i32[r, s], err bool[n]): an element's flag, record-absolute start
    and length sit at the row and column that own its trimmed start, so the
    row-major flag order is record order.

    The walk is computed in scans over the flattened grid: the string
    state as a prefix composition of the bytes' state maps (reset at each
    record's ``[``), the depth as a prefix sum, an element's start as the
    first non-whitespace byte after a comma or the ``[``, and its end as
    the last non-whitespace byte before the next boundary."""
    r, s = sv.shape
    n = first_row.shape[0]
    dev = sv.device
    first_row = first_row.to(torch.int64)
    k = k.to(torch.int64)
    rr = torch.arange(r, dtype=torch.int64, device=dev)
    seg_r = torch.searchsorted(first_row + k, rr, right=True).clamp(0, n - 1)
    jidx = torch.arange(s, dtype=torch.int64, device=dev)[None, :]
    pos = ((rr - first_row[seg_r]) * step)[:, None] + jidx
    own = jidx < owned.to(torch.int64)[:, None]
    flat_sv = sv.reshape(-1)
    big = torch.iinfo(torch.int64).max

    # outer trim and the brackets
    nonws = own & ~kernels._is_ws(sv)
    fa = _seg_reduce(torch.where(nonws, pos, big).amin(dim=1), seg_r, n, "amin", big)
    fb = _seg_reduce(torch.where(nonws, pos, -1).amax(dim=1), seg_r, n, "amax", -1)
    segs = torch.arange(n, dtype=torch.int64, device=dev)
    has = fa < big
    b_fa = flat_sv[_owner_flat(torch.where(has, fa, 0), segs, first_row, k, step, r, s)]
    b_fb = flat_sv[_owner_flat(torch.where(has, fb, 0), segs, first_row, k, step, r, s)]
    live = k > 0
    ok = live & has & (fb > fa) & (b_fa == 0x5B) & (b_fb == 0x5D)
    ok_r = ok[seg_r][:, None]
    fa_r, fb_r = fa[seg_r][:, None], fb[seg_r][:, None]
    body = own & ok_r & (pos > fa_r) & (pos < fb_r)
    at_fa = own & ok_r & (pos == fa_r)
    at_fb = own & ok_r & (pos == fb_r)

    # string state before each byte
    code = torch.where(sv == 0x22, _STR_QUOTE, torch.where(sv == 0x5C, _STR_BACKSLASH, _STR_OTHER))
    code = torch.where(body, code, _STR_IDENTITY)
    code = torch.where(at_fa, _STR_RESET, code).to(torch.int32).reshape(-1)
    table = torch.from_numpy(_STR_COMPOSE).to(dev)
    d = 1
    while d < code.shape[0]:
        code = torch.cat([code[:d], table[code[d:] * 27 + code[:-d]]])
        d <<= 1
    after = code % 3
    outside = torch.cat([after.new_zeros(1), after[:-1]]).reshape(r, s) == 0
    del code, after

    # depth before each byte
    up = body & outside & ((sv == 0x5B) | (sv == 0x7B))
    dn = body & outside & ((sv == 0x5D) | (sv == 0x7D))
    delta = up.to(torch.int64) - dn.to(torch.int64)
    csum = torch.cumsum(delta.reshape(-1), 0)
    base = csum[(first_row[seg_r] * s).clamp(0, r * s - 1)]
    depth = csum.reshape(r, s) - delta - base[:, None]
    del up, dn, delta, csum
    comma = body & outside & (sv == 0x2C) & (depth == 0)
    del depth, outside
    boundary = comma | at_fb
    opener = comma | at_fa

    # an element starts at the first non-whitespace byte after an opener
    segcode = seg_r[:, None] * _ENC_BASE + pos
    last_nw = torch.cummax(torch.where(nonws, segcode * 2 + opener, -1).reshape(-1), 0).values
    prev_nw = torch.cat([last_nw.new_full((1,), -1), last_nw[:-1]]).reshape(r, s)
    del last_nw
    same = (prev_nw >= 0) & (torch.div(prev_nw >> 1, _ENC_BASE, rounding_mode="floor")
                             == seg_r[:, None])
    starts = body & nonws & ~comma & same & ((prev_nw & 1) == 1)
    # ... and ends at the last non-whitespace byte before the next boundary
    prev_pos = (prev_nw >> 1) % _ENC_BASE
    del prev_nw
    nxt = torch.cummin(torch.where(boundary, segcode, _DEAD).reshape(-1).flip(0), 0)
    nb = (nxt.values.flip(0).reshape(r, s)) % _ENC_BASE
    del nxt, segcode
    seg_g = seg_r[:, None].expand(r, s)
    last = prev_pos.reshape(-1)[_owner_flat(nb, seg_g, first_row, k, step, r, s)]
    b_last = flat_sv[_owner_flat(last, seg_g, first_row, k, step, r, s)]
    quoted = (sv == 0x22) & (b_last == 0x22) & (last > pos)
    st = pos + quoted.to(torch.int64)
    ln = last - pos + 1 - 2 * quoted.to(torch.int64)
    emit = starts & (ln > 0)
    at = torch.where(emit, _owner_flat(st, seg_g, first_row, k, step, r, s), r * s).reshape(-1)
    flag = torch.zeros((r * s + 1,), dtype=torch.bool, device=dev).scatter_(
        0, at, emit.reshape(-1))
    abs_start = torch.zeros((r * s + 1,), dtype=torch.int32, device=dev).scatter_(
        0, at, torch.where(emit, st, 0).to(torch.int32).reshape(-1))
    elen = torch.zeros((r * s + 1,), dtype=torch.int32, device=dev).scatter_(
        0, at, torch.where(emit, ln, 0).to(torch.int32).reshape(-1))
    return (flag[:-1].reshape(r, s), abs_start[:-1].reshape(r, s), elen[:-1].reshape(r, s),
            live & ~ok)


# ---------------------------------------------------------------------------
# Striped fan-out (array_map split mode)
# ---------------------------------------------------------------------------

# packs (segment, byte position) into one int64 for the segment-fenced
# suffix minimum; a dead row encodes as _DEAD, past every live code
_ENC_BASE = 1 << 22  # > MAX_RECORD_WIDTH
_DEAD = 2**62


def striped_split_bounds(sv: torch.Tensor, plan: dict, sep: bytes, n: int, kmax: int = 1):
    """Element emission grid of ``value.split(sep)``, empty elements
    dropped, over stripe rows (the JAX package's ``stripes.
    striped_split_bounds`` for one byte, `striped_separator_matches` for
    longer separators).

    Each byte position is OWNED by exactly one stripe row (the overlap
    tail belongs to the next stripe), so a separator counts once and the
    row-major flag order is record order within a segment. An element
    starts at the record's start or where a separator match ends, and
    ends at the next match or the record's end: the next match within the
    row, else the first of a later row of the segment, found by a suffix
    minimum over the segment's rows (fenced by the segment id in the high
    bits of the code). Returns (flag bool[r, s], abs_start i32[r, s],
    elen i32[r, s]), starts record-absolute. ``sep`` is the separator's
    bytes (an int: one byte, as the JAX function takes it); ``kmax`` (>=
    every segment's stripe count, from the host) bounds a longer
    separator's walk."""
    if isinstance(sep, int):
        sep = bytes([sep])
    r, s = sv.shape
    dev = sv.device
    step = plan["step"]
    jidx = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    owned = jidx < owned_lengths(plan)[:, None]
    seg = plan["seg"].to(torch.int64)
    # each segment's record length: its last row's end, broadcast to the
    # segment's rows
    seg_len = torch.zeros((n,), dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, torch.where(plan["is_last"], plan["abs_start"] + plan["stripe_len"], 0), "amax")
    abs_pos = plan["abs_start"][:, None] + jidx
    if len(sep) == 1:
        m = (sv == sep[0]) & owned
        # column 0's predecessor in record order: the previous row's last
        # owned byte (a row that is not its record's last owns exactly
        # `step` bytes), or the record's start
        prev_last = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev), m[:-1, step - 1]])
        col0_boundary = (plan["stripe_idx"] == 0) | prev_last
        after_match = torch.cat([col0_boundary[:, None], m[:, :-1]], dim=1)
    else:
        m = striped_separator_matches(sv, plan, sep, seg_len, kmax)
        after_match = _match_ends(m, plan, len(sep), seg_len) | (abs_pos == 0)
    starts = owned & ~m & after_match
    del owned, after_match

    # the next separator at or after each position: within the row where
    # there is one, else the first separator of a later row of the segment
    row_next = kernels._next_index_ge(m)  # s where none
    has_sep = m.any(dim=1)
    del m
    first_abs = torch.where(has_sep, plan["abs_start"] + row_next[:, 0], _ENC_BASE - 1)
    enc = torch.where(plan["row_live"], seg * _ENC_BASE + first_abs.to(torch.int64), _DEAD)
    suffix = torch.cummin(enc.flip(0), 0).values.flip(0)
    after = torch.cat([suffix[1:], suffix.new_full((1,), _DEAD)])
    cross_next = torch.where(
        (after // _ENC_BASE == seg) & (after % _ENC_BASE < _ENC_BASE - 1),
        after % _ENC_BASE, -1,
    ).to(torch.int32)
    fallback = torch.where(cross_next >= 0, cross_next, seg_len[seg])
    next_abs = torch.where(row_next < s, abs_pos - jidx + row_next, fallback[:, None])
    del row_next
    elen = torch.where(starts, next_abs - abs_pos, 0)
    del next_abs
    return starts, torch.where(starts, abs_pos, 0), elen


def _has_border(sep: bytes) -> bool:
    """Whether a proper prefix of ``sep`` is also its suffix: only then can
    two occurrences overlap (``aa``, ``abab``; not ``\\r\\n``)."""
    return any(sep[:k] == sep[-k:] for k in range(1, len(sep)))


def striped_separator_matches(sv: torch.Tensor, plan: dict, sep: bytes,
                              seg_len: torch.Tensor, kmax: int) -> torch.Tensor:
    """bool[r, s]: the owned positions where ``value.split(sep)`` matches
    its separator, left to right without overlap, for a separator of two
    or more bytes.

    An occurrence starts at an owned position and reads ``len(sep) - 1``
    bytes past it: the row's overlap tail holds them up to the overlap,
    the bytes past it are gathered from the rows that own them. Where no
    proper prefix of the separator is also its suffix, occurrences cannot
    overlap and each is a match, as with one byte. Otherwise the matches
    are the path through the occurrences that starts at a record's first
    occurrence and steps to the first occurrence at or past each match's
    end (a match hides the next ``len(sep) - 1`` bytes): its nodes are
    marked by pointer doubling over that step, on the occurrences alone
    (their flat indices, in record order within a segment, one wait on
    the card for their count), so the walk across rows and seams takes
    log2(the longest path) rounds."""
    r, s = sv.shape
    dev = sv.device
    sep_len = len(sep)
    step = plan["step"]
    seg = plan["seg"].to(torch.int64)
    jidx = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    # the bytes each position's window reads: the row, then the record's
    # bytes past the row's end (none within the overlap)
    extra = max(0, sep_len - 1 - (s - step))
    ext = sv
    if extra:
        t = torch.arange(extra, dtype=torch.int64, device=dev)[None, :]
        flat = _owner_flat(plan["abs_start"].to(torch.int64)[:, None] + s + t,
                           seg[:, None], plan["first_row"], plan["k"], step, r, s)
        ext = torch.cat([sv, sv.reshape(-1)[flat]], dim=1)
    ext = torch.nn.functional.pad(ext, (0, s + sep_len - 1 - ext.shape[1]))
    occ = (jidx < owned_lengths(plan)[:, None]) & (
        plan["abs_start"][:, None] + jidx + sep_len <= seg_len[seg][:, None])
    for i, b in enumerate(sep):
        occ &= ext[:, i:i + s] == b
    del ext
    if not _has_border(sep):
        return occ
    at = occ.reshape(-1).nonzero().squeeze(1)  # ascending
    m = at.numel()
    if m == 0:
        return occ
    # the step: from an occurrence to the first one at or past its end, in
    # the same record (the sink, index m, where there is none)
    oseg = seg[at // s]
    seg_end = ((plan["first_row"].to(torch.int64) + plan["k"].to(torch.int64)) * s)
    end = plan["abs_start"].to(torch.int64)[at // s] + at % s + sep_len
    nxt = torch.searchsorted(at, _owner_flat(end, oseg, plan["first_row"], plan["k"], step,
                                             r, s))
    ok = (end < seg_len.to(torch.int64)[oseg]) & (nxt < m)
    ok &= at[nxt.clamp(max=m - 1)] < seg_end[oseg]
    jump = torch.cat([torch.where(ok, nxt, m), nxt.new_full((1,), m)])
    # each record's first occurrence starts the path
    head = torch.searchsorted(at, plan["first_row"].to(torch.int64) * s)
    live = (plan["k"] > 0) & (head < m)
    live &= at[head.clamp(max=m - 1)] < seg_end
    on_path = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
    on_path[torch.where(live, head, m)] = 1
    for _ in range(min(m, max(kmax, 1) * s // sep_len + 1).bit_length()):
        on_path = on_path.scatter_add(0, jump, on_path).clamp(max=1)
        jump = jump[jump]
    out = torch.zeros((r * s,), dtype=torch.bool, device=dev)
    out[at[on_path[:m] > 0]] = True
    return out.reshape(r, s)


def _match_ends(m: torch.Tensor, plan: dict, sep_len: int, seg_len: torch.Tensor):
    """bool[r, s]: the positions right after a match (inside its record),
    marked at the rows that own them."""
    r, s = m.shape
    at = m.reshape(-1).nonzero().squeeze(1)
    seg = plan["seg"].to(torch.int64)[at // s]
    end = plan["abs_start"].to(torch.int64)[at // s] + at % s + sep_len
    inside = end < seg_len.to(torch.int64)[seg]
    out = torch.zeros((r * s,), dtype=torch.bool, device=m.device)
    out[_owner_flat(end[inside], seg[inside], plan["first_row"], plan["k"], plan["step"],
                    r, s)] = True
    return out.reshape(r, s)


# ---------------------------------------------------------------------------
# Chain build + run
# ---------------------------------------------------------------------------


@dataclass
class StripedChain:
    """Stripe-capable lowering of a whole chain.

    ``ops`` entries: ("filter", fn) | ("postops", folds) | ("span", fn) |
    ("computed", fn) | ("agg", (aggregate stage, contribution fn or
    None)) | ("fanout", None). ``postops`` accumulates every fold the host
    applies when it rebuilds view outputs (it must equal the narrow
    build's view postops). A span op (JsonGet map) makes the outputs
    sub-record views: the executor ships their (start, length)
    descriptors instead of whole records. A computed op (a key rewrite, a
    value built from fields, ``computed``) rewrites the segment state's
    narrow value and key columns, which ship in byte mode as the narrow
    path's do (`_lower_computed_map`). An aggregate op runs the executor's own narrow stage on the
    segment state, with the contribution column a byte-range op computed
    where the state cannot give it (`_striped_contribution`); a fan-out op
    (last, program ``fanout_stage``) gives the explode's emission grid: a
    split's on the separator ``fanout_sep`` or a JSON array's
    (``fanout_json``). With ``tail_from`` set the ops are a prefix of the
    chain's programs, whose narrow output the executor hands to its
    narrow stages from ``tail_from`` on."""

    ops: List = field(default_factory=list)
    postops: Tuple[str, ...] = ()
    has_span: bool = False
    has_agg: bool = False
    computed: bool = False
    fanout_sep: Optional[bytes] = None
    fanout_json: bool = False
    fanout_stage: int = 0
    # the first program the narrow tail runs (None: the whole chain is
    # striped)
    tail_from: Optional[int] = None

    @property
    def fanout(self) -> bool:
        return self.fanout_sep is not None or self.fanout_json

    def fan_grid(self, ctx: dict):
        """The fan-out's (flag, abs_start, elen, err) grid over ``ctx``'s
        stripe bytes, as the chain's last op computes it; ``err`` (bool[n],
        the records that are no JSON array) is None for a split."""
        plan = ctx["plan"]
        if self.fanout_json:
            return cuda_kernels.json_array_striped(
                ctx["sv"].contiguous(), owned_lengths(plan).contiguous(),
                plan["first_row"].contiguous(), plan["k"].contiguous(), plan["step"])
        return (*striped_split_bounds(ctx["sv"], plan, self.fanout_sep, ctx["n"], ctx["kmax"]),
                None)

    def run(self, ctx: dict, valid: torch.Tensor, carries, base_ts: int, agg_ctx: dict):
        """Returns (valid bool[n], seg_state, carries, fan, vspan): ``fan``
        the emission grid of a fan-out chain, ``vspan`` the per-segment
        (start, length) of a span chain, else None. ``ctx["seg_state"]``
        must copy to its own type (the executor's deferred-column state)."""
        fan = vspan = None
        for kind, arg in self.ops:
            if kind == "filter":
                valid = valid & arg(ctx)
            elif kind == "postops":
                ctx["sv"] = apply_postops(ctx["sv"], arg)
                ctx["seg_state"]["values"] = apply_postops(ctx["seg_state"]["values"], arg)
            elif kind == "span":
                vspan = arg(ctx)
            elif kind == "computed":
                arg(ctx)
                ctx["seg_state"]["valid"] = valid  # what the byte-mode ship reads
            elif kind == "agg":
                stage, contribution = arg
                st = ctx["seg_state"].copy()
                st["valid"] = valid
                if contribution is not None:
                    st["contribution"] = contribution(ctx)
                st, carries = stage.apply(st, carries, base_ts, agg_ctx)
                ctx["seg_state"] = st
            else:  # fanout (terminal)
                fan = self.fan_grid(ctx)
        return valid, ctx["seg_state"], carries, fan, vspan


def try_build_striped(programs, stages, s: int, v: int, first: int = 0,
                      why: Optional[list] = None) -> Optional[StripedChain]:
    """Striped lowering of the chain's resolved programs from ``first`` on
    (the JAX package's build rules); None when not even a prefix of them
    stripes (wide batches then spill), the reason appended to ``why``.
    ``stages`` are the executor's narrow stages, one a program: an
    aggregate op reuses its stage, so the striped and narrow paths share
    carry slots and scans.

    - aggregates only as a chain suffix; the first one's contribution is
      exact on the segment state, or a word count or a JsonGet integer
      over a byte range, or after a span map a canned kind over the span,
      or a bytes value's leading integer (`_striped_contribution`);
    - a fan-out only last, a ``split`` or a JSON-array explode, never
      after an aggregate or a span map;
    - no filter after a span map, one span map a chain;
    - a map that rewrites the key, or whose value is neither a fold chain
      nor a JsonGet view, computes narrow columns (`_lower_computed_map`):
      never after a span map, and no filter or fan-out after it; its
      record reads are JsonGet fields, lengths and integer parses, never
      the whole value;
    - a comparison reads the record, a JsonGet field or the record's
      leading integer as narrow columns (`_lower_striped_cmp`).

    Beyond the JAX package's rules it lowers the JSON-array explode, the
    word count, the JsonGet contribution, an aggregate after a span map,
    the computed map, a split on a separator of several bytes and a
    comparison of the record's bytes, which the JAX package spills to its
    interpreter, and a regex of any DFA the compiler emits, where the JAX
    package gates the states and classes for its TPU.

    A chain refused at program ``i`` whose programs before ``i`` leave
    narrow values (a span map, a computed map or an aggregate ran: every
    value is a field, a computed column or a rendered integer) lowers as
    that prefix, ``tail_from`` = i: the executor runs the rest over the
    prefix's output (`GpuChainExecutor._hand_off`), on its narrow stages,
    or, over fields past the stripe threshold, through this lowering again
    from ``first`` = i.

    The JAX package has no striped lowering for a chain with a tail, so
    its wide batches take its interpreter: such a prefix, and any lowering
    from ``first`` > 0, is lowered ``exact``, its comparisons and integer
    contributions reading the whole record where the JAX package's
    striped rule reads the first stripe."""
    chain, span_src = StripedChain(), None
    for index in range(first, len(programs)):
        narrow = (chain.has_span or chain.computed or chain.has_agg) and not chain.fanout
        try:
            span_src = _build_step(chain, index, programs[index], stages[index], span_src,
                                   s, v, exact=first > 0)
        except Unlowerable as e:
            refusal = f"program {index}: {e}"
            if narrow:
                try:
                    return _build_prefix(programs, stages, first, index, s, v)
                except Unlowerable as e2:
                    refusal = f"{refusal}; its prefix, exact: {e2}"
            if why is not None:
                why.append(refusal)
            return None
    return chain


def _build_prefix(programs, stages, first: int, end: int, s: int, v: int) -> StripedChain:
    """Programs ``first`` to ``end`` lowered ``exact``, with the narrow
    tail from ``end``."""
    chain, span_src = StripedChain(tail_from=end), None
    for i in range(first, end):
        span_src = _build_step(chain, i, programs[i], stages[i], span_src, s, v, exact=True)
    return chain


def _build_step(chain: StripedChain, index: int, prog, stage, span_src, s: int, v: int,
                exact: bool = False):
    """Append program ``index``'s striped ops to ``chain``; returns the
    chain's span source. Raises `Unlowerable` where it does not stripe,
    ``chain`` then perhaps extended in part (the caller rebuilds it,
    `_build_prefix`)."""
    if chain.fanout or (chain.has_agg and not isinstance(prog, dsl.AggregateProgram)):
        raise Unlowerable("stage after a striped terminal stage")
    if chain.computed and isinstance(prog, (dsl.FilterProgram, dsl.FilterMapProgram,
                                            dsl.ArrayMapProgram)):
        raise Unlowerable("filter or fan-out after a striped computed map")
    if isinstance(prog, dsl.FilterProgram):
        if chain.has_span:
            # a later filter would read the extracted view, not the stripe
            # bytes the striped predicates scan
            raise Unlowerable("filter after a striped span map")
        chain.ops.append(("filter", lower_striped_predicate(prog.predicate, s, v, exact)))
    elif isinstance(prog, (dsl.MapProgram, dsl.FilterMapProgram)):
        if isinstance(prog, dsl.FilterMapProgram):
            if chain.has_span:
                raise Unlowerable("filter after a striped span map")
            chain.ops.append(("filter", lower_striped_predicate(prog.predicate, s, v, exact)))
        view = None
        if prog.key is None and not chain.computed:
            try:
                view = _striped_view(prog.value)
            except Unlowerable:
                pass  # computed below
        if view is None:
            if chain.has_span:
                raise Unlowerable("computed map after a striped span map")
            chain.ops.append(("computed", _lower_computed_map(prog, not chain.computed)))
            chain.computed = True
        elif view[0] == "postops":
            if view[1] and not chain.has_span:
                # after a span map the stripe bytes are dead; the fold
                # applies on the host through `postops`
                chain.ops.append(("postops", view[1]))
            chain.postops += view[1]
        else:
            _, key, pre, total = view
            if chain.has_span:
                raise Unlowerable("one striped span map per chain")
            chain.ops.append(("span", _make_span_fn(key, pre)))
            chain.has_span = True
            chain.postops += total
            span_src = (key, pre)
    elif isinstance(prog, dsl.AggregateProgram):
        # after a computed map the segment state is narrow and whole
        contribution = None if chain.computed else _striped_contribution(
            prog, span_src, not chain.has_agg, exact)
        chain.ops.append(("agg", (stage, contribution)))
        chain.has_agg = True
    elif isinstance(prog, dsl.ArrayMapProgram):
        if chain.has_agg or chain.has_span:
            raise Unlowerable("striped fan-out after an aggregate or a span map")
        if prog.mode == "json_array":
            chain.fanout_json = True
        elif prog.mode != "split" or not prog.sep:
            raise Unlowerable(f"striped array_map mode {prog.mode}")
        else:
            chain.fanout_sep = bytes(prog.sep)
        chain.ops.append(("fanout", None))
        chain.fanout_stage = index
    else:
        raise Unlowerable(f"{type(prog).__name__} not stripeable")
    return span_src
