"""DSL expression -> torch/CUDA lowering.

The port's counterpart of ``fluvio_tpu/smartengine/tpu/lower.py``.
Compiles resolved (param-substituted) DSL expression trees into functions
over the chain state (values/lengths/keys/key_lengths tensors). Types are
inferred: ``bytes`` results are (values u8[N, W], lengths i32[N]) pairs,
``int`` is i64[N], ``bool`` is bool[N]. A non-literal regex compiles to DFA
tables at lowering time; an unsupported pattern or expression raises
:class:`Unlowerable`.

The reference picks among Pallas, associative and sequential kernels by
backend and DFA size; on the card that choice collapses into "call the
wrapper": every JSON span, span extraction and DFA verdict goes through
``cuda_kernels``, whose CUDA DFA kernel takes every table the compiler
emits. ``Len``, ``ParseInt`` and ``IntToBytes`` lower to torch code
(`kernels.parse_int`, `kernels.int_to_ascii`). A bytes value where an
integer is needed (``IntToBytes`` of bytes, the bytes side of a ``Cmp``
against an int, an aggregate's bytes contribution) reads as ``ParseInt``
of it, the JAX engine's native rule (``as_int``, `as_int_expr`); a
``Cmp`` of two bytes values is Python ``bytes`` order
(`kernels.bytes_compare`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.ops.regex_dfa import UnsupportedRegex, compile_regex_cached, literal_of
from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels


class Unlowerable(Exception):
    """Expression/program outside the GPU-compilable subset."""


BytesVal = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class Column(dsl.Expr):
    """A value its caller put in the state under ``name``: a (values,
    lengths) pair when ``kind`` is "bytes", i64[N] when "int". The
    striped build binds the record reads of a computed map to such
    columns (`stripes._bind_record_reads`)."""

    name: str = ""
    kind: str = "bytes"


def _span(v: torch.Tensor, l: torch.Tensor, key: str) -> BytesVal:
    return cuda_kernels.json_get_span(v.contiguous(), l.to(torch.int32).contiguous(), key)


def materialize_span(values: torch.Tensor, start: torch.Tensor, lengths: torch.Tensor):
    """Per-record substring extraction — the one home of the extract
    kernel call (byte-mode JsonGet and view-stage materialization)."""
    return cuda_kernels.extract_span(
        values.contiguous(),
        start.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(),
    )


def lower_span(expr: dsl.Expr):
    """Descriptor lowering: ``(fn, postops)`` where ``fn(state) -> (start,
    length)`` within the CURRENT value bytes, or ``None`` when the
    expression's output is not a (position-wise transformed) view of them.

    Chains whose final values are views of the stored record bytes ship
    (row, start, length) descriptors to the host, which rebuilds outputs
    from the bytes it already holds. ``postops`` is a static tuple of
    length-preserving byte-wise folds (``"upper"``/``"lower"``) the host
    applies after the gather."""
    if isinstance(expr, dsl.Value):
        return (lambda s: (torch.zeros_like(s["lengths"]), s["lengths"])), ()

    if isinstance(expr, (dsl.Upper, dsl.Lower)):
        inner = lower_span(expr.arg)
        if inner is None:
            return None
        fn, post = inner
        tag = "upper" if isinstance(expr, dsl.Upper) else "lower"
        return fn, post + (tag,)

    if isinstance(expr, dsl.JsonGet):
        inner = lower_span(expr.arg)
        if inner is None:
            return None
        inner_fn, inner_post = inner
        inner_bytes = lower_expr(expr.arg)
        key = expr.key

        def fn(s):
            v, l = inner_bytes(s)
            st, ln = _span(v, l, key)
            ist, _ = inner_fn(s)
            return ist + st, ln

        return fn, inner_post

    return None


def apply_postops(values: torch.Tensor, postops) -> torch.Tensor:
    """Apply static span postops on the device (host mirror:
    `buffer.apply_postops_host`)."""
    for op in postops:
        values = kernels.ascii_upper(values) if op == "upper" else kernels.ascii_lower(values)
    return values


def infer_type(expr: dsl.Expr) -> str:
    if isinstance(expr, Column):
        return expr.kind
    if isinstance(expr, (dsl.Value, dsl.Key, dsl.Const, dsl.Upper, dsl.Lower,
                         dsl.Concat, dsl.JsonGet, dsl.IntToBytes)):
        return "bytes"
    if isinstance(expr, (dsl.Len, dsl.ParseInt)):
        return "int"
    if isinstance(expr, (dsl.RegexMatch, dsl.Contains, dsl.StartsWith,
                         dsl.EndsWith, dsl.Cmp, dsl.And, dsl.Or, dsl.Not)):
        return "bool"
    raise Unlowerable(f"cannot type {type(expr).__name__}")


_CMP = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
    "le": torch.le, "gt": torch.gt, "ge": torch.ge,
}


def as_int_expr(expr: dsl.Expr) -> dsl.Expr:
    """``expr`` where an integer is needed: itself when int-typed,
    ``ParseInt`` of it when bytes-typed (the JAX native backend's
    ``as_int``: the leading ASCII integer, 0 where there is none)."""
    kind = infer_type(expr)
    if kind == "int":
        return expr
    if kind == "bytes":
        return dsl.ParseInt(arg=expr)
    raise Unlowerable(f"a {kind} value where an integer is needed")


def cmp_operands(expr: dsl.Cmp) -> Tuple[dsl.Expr, dsl.Expr, bool]:
    """(left, right, bytes order) of a comparison: two bytes operands
    compare in bytes order; otherwise both read as integers
    (`as_int_expr`), as the native backend's ``val_cmp`` does."""
    if infer_type(expr.left) == "bytes" and infer_type(expr.right) == "bytes":
        return expr.left, expr.right, True
    return as_int_expr(expr.left), as_int_expr(expr.right), False


def lower_expr(expr: dsl.Expr) -> Callable[[Dict[str, torch.Tensor]], object]:
    """Lower one expression; returns fn(state) -> typed result."""

    if isinstance(expr, dsl.Value):
        return lambda s: (s["values"], s["lengths"])

    if isinstance(expr, Column):
        name = expr.name
        return lambda s: s[name]

    if isinstance(expr, dsl.Key):
        # null key reads as b"" (parity with the interpreter)
        return lambda s: (s["keys"], s["key_lengths"].clamp(min=0))

    if isinstance(expr, dsl.Const):
        data = np.frombuffer(expr.data, dtype=np.uint8)

        def const_fn(s):
            n = s["lengths"].shape[0]
            dev = s["lengths"].device
            if len(data):
                vals = torch.from_numpy(data.copy()).to(dev).expand(n, len(data)).contiguous()
            else:
                vals = torch.zeros((n, 1), dtype=torch.uint8, device=dev)
            lens = torch.full((n,), len(data), dtype=torch.int32, device=dev)
            return vals, lens

        return const_fn

    if isinstance(expr, (dsl.Upper, dsl.Lower)):
        inner = lower_expr(expr.arg)
        op = kernels.ascii_upper if isinstance(expr, dsl.Upper) else kernels.ascii_lower

        def case_fn(s):
            v, l = inner(s)
            return op(v), l

        return case_fn

    if isinstance(expr, dsl.JsonGet):
        inner = lower_expr(expr.arg)
        key = expr.key

        def json_fn(s):
            v, l = inner(s)
            st, ln = _span(v, l, key)
            return materialize_span(v, st, ln), ln

        return json_fn

    if isinstance(expr, (dsl.RegexMatch, dsl.Contains, dsl.StartsWith, dsl.EndsWith)):
        inner = lower_expr(expr.arg)

        def _literal_fn(lit: bytes, anchor_start: bool, anchor_end: bool):
            def fn(s):
                v, l = inner(s)
                if anchor_start and anchor_end:
                    return kernels.literal_startswith(v, l, lit) & (l == len(lit))
                if anchor_start:
                    return kernels.literal_startswith(v, l, lit)
                if anchor_end:
                    return kernels.literal_endswith(v, l, lit)
                return kernels.literal_search(v, l, lit)

            return fn

        if isinstance(expr, dsl.Contains):
            return _literal_fn(expr.literal, False, False)
        if isinstance(expr, dsl.StartsWith):
            return _literal_fn(expr.literal, True, False)
        if isinstance(expr, dsl.EndsWith):
            return _literal_fn(expr.literal, False, True)

        # RegexMatch: windowed compare for pure literals, the DFA otherwise
        lit_info = literal_of(expr.pattern)
        if lit_info is not None:
            return _literal_fn(*lit_info)
        try:
            dfa = compile_regex_cached(expr.pattern)
        except UnsupportedRegex as e:
            raise Unlowerable(str(e)) from e

        def regex_fn(s):
            v, l = inner(s)
            return cuda_kernels.dfa_match(v.contiguous(), l.to(torch.int32).contiguous(), dfa)

        return regex_fn

    if isinstance(expr, dsl.Len):
        inner = lower_expr(expr.arg)
        return lambda s: inner(s)[1].to(torch.int64)

    if isinstance(expr, dsl.ParseInt):
        inner = lower_expr(expr.arg)
        return lambda s: kernels.parse_int(*inner(s))

    if isinstance(expr, dsl.IntToBytes):
        inner = lower_expr(as_int_expr(expr.arg))
        return lambda s: kernels.int_to_ascii(inner(s))

    if isinstance(expr, dsl.Cmp):
        left, right, by_bytes = cmp_operands(expr)
        lf, rf = lower_expr(left), lower_expr(right)
        op = _CMP[expr.cmp]
        if by_bytes:
            return lambda s: op(kernels.bytes_compare(*lf(s), *rf(s)), 0)
        return lambda s: op(lf(s), rf(s))

    if isinstance(expr, (dsl.And, dsl.Or)):
        fns = [lower_expr(a) for a in expr.args]
        is_and = isinstance(expr, dsl.And)

        def bool_fn(s):
            out = fns[0](s)
            for f in fns[1:]:
                out = (out & f(s)) if is_and else (out | f(s))
            return out

        return bool_fn

    if isinstance(expr, dsl.Not):
        inner = lower_expr(expr.arg)
        return lambda s: ~inner(s)

    if isinstance(expr, dsl.Concat):
        fns = [lower_expr(a) for a in expr.args]

        def concat_fn(s):
            parts = [f(s) for f in fns]
            total_w = sum(p[0].shape[1] for p in parts)
            n = parts[0][0].shape[0]
            dev = parts[0][0].device
            out_len = sum(p[1].to(torch.int32) for p in parts).to(torch.int32)
            out = torch.zeros((n, total_w), dtype=torch.uint8, device=dev)
            # each output column selects from the part covering it
            j = torch.arange(total_w, dtype=torch.int64, device=dev)[None, :]
            starts = torch.zeros((n,), dtype=torch.int64, device=dev)
            for pv, pl in parts:
                pl = pl.to(torch.int64)
                rel = j - starts[:, None]
                in_part = (rel >= 0) & (rel < pl[:, None])
                gathered = torch.gather(pv, 1, rel.clamp(0, pv.shape[1] - 1))
                out = torch.where(in_part, gathered, out)
                starts = starts + pl
            return out, out_len

        return concat_fn

    raise Unlowerable(f"no lowering for {type(expr).__name__}")
