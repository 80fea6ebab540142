"""Declarative transform DSL — the port's copy of ``fluvio_tpu/smartmodule/dsl.py``.

A DSL program is pure data. The port lowers it to torch code and CUDA
kernels over the batched record buffer (``smartengine/gpu/lower.py``);
the per-record interpreter below (`eval_expr`) is the host truth that
``chip_smoke.py`` holds the card's output against. Byte-level semantics
are the JAX package's: `json_get_bytes`, `json_array_elements`,
`parse_int_prefix`, `count_words`, `ascii_upper`, `ascii_lower`.

Expression types (over one record):

    Value()                  record value bytes
    Key()                    record key bytes (b"" when absent)
    Const(b)                 literal bytes
    Param(name, default)     chain-config parameter (resolved at build time)
    Upper(e) / Lower(e)      ASCII case fold
    Concat([e...])           byte concatenation
    JsonGet(e, key)          top-level JSON field extraction (see below)
    RegexMatch(e, pattern)   unanchored regex search -> bool
    Contains/StartsWith/EndsWith(e, lit) -> bool
    Len(e)                   length -> int
    ParseInt(e)              leading-integer parse -> int
    IntToBytes(i)            ASCII decimal render
    Cmp(op, a, b)            int comparison -> bool
    And/Or/Not               boolean combinators

Programs (one per transform kind):

    FilterProgram(predicate)
    MapProgram(value, key=None)          key=None preserves the input key
    FilterMapProgram(predicate, value, key=None)
    ArrayMapProgram(mode="json_array" | "split", sep=b"\\n")
    AggregateProgram(kind="sum_int"|"count"|"word_count"|"max_int"|"min_int",
                     window_ms=None)     window_ms -> windowed materialized
                                         view (accumulator resets per
                                         timestamp window; record key set to
                                         the window start)
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Byte-level primitive semantics
# ---------------------------------------------------------------------------


def json_get_bytes(value: bytes, key: str) -> bytes:
    """Extract a top-level JSON field's bytes by structural scan.

    Deterministic byte-level semantics: find ``"key"`` at brace depth 1,
    skip ``:`` and whitespace, then

    - string value: the raw bytes between the quotes (escapes NOT
      processed; values containing escaped quotes are unsupported),
    - other values: bytes up to the next top-level ``,`` or ``}``,
      whitespace-trimmed.

    Missing key, non-object input, or malformed structure yield ``b""``.

    One corner differs from the device span kernels (the JAX package's
    and the port's): ``bytes.strip`` also trims ``\\x0b`` and ``\\x0c``,
    while the kernels trim only space, tab, CR and LF from a raw value.
    The port follows the kernels; ``tests/test_torch_kernels.py`` pins it.
    """
    needle = b'"' + key.encode("utf-8") + b'"'
    n = len(value)
    depth = 0
    in_str = False
    i = 0
    while i < n:
        c = value[i]
        if in_str:
            if c == 0x5C:  # backslash
                i += 2
                continue
            if c == 0x22:  # quote
                in_str = False
            i += 1
            continue
        if c == 0x22:
            # quote opens a string; check for the needle at depth 1
            if depth == 1 and value[i : i + len(needle)] == needle:
                j = i + len(needle)
                while j < n and value[j] in b" \t\r\n":
                    j += 1
                if j < n and value[j] == 0x3A:  # ':'
                    j += 1
                    while j < n and value[j] in b" \t\r\n":
                        j += 1
                    if j < n and value[j] == 0x22:  # string value
                        k = j + 1
                        while k < n and value[k] != 0x22:
                            if value[k] == 0x5C:
                                k += 1
                            k += 1
                        return value[j + 1 : k]
                    # scalar / nested value: until top-level , or }
                    k = j
                    d2 = 0
                    while k < n:
                        ck = value[k]
                        if ck in b"[{":
                            d2 += 1
                        elif ck in b"]}":
                            if d2 == 0:
                                break
                            d2 -= 1
                        elif ck == 0x2C and d2 == 0:  # ','
                            break
                        k += 1
                    return value[j:k].strip()
            in_str = True
            i += 1
            continue
        if c == 0x7B:  # '{'
            depth += 1
        elif c == 0x7D:  # '}'
            depth -= 1
        i += 1
    return b""


def json_array_elements(value: bytes) -> Optional[List[bytes]]:
    """Split a top-level JSON array into element byte-slices.

    Strings keep their quotes stripped; other elements are raw trimmed
    bytes. Returns None if the input is not a JSON array (transform error).
    """
    s = value.strip()
    if not s.startswith(b"[") or not s.endswith(b"]"):
        return None
    body = s[1:-1]
    elements: List[bytes] = []
    i = 0
    n = len(body)
    start = 0
    depth = 0
    in_str = False

    def push(seg: bytes) -> None:
        seg = seg.strip()
        if seg.startswith(b'"') and seg.endswith(b'"') and len(seg) >= 2:
            seg = seg[1:-1]
        if seg:
            elements.append(seg)

    while i < n:
        c = body[i]
        if in_str:
            if c == 0x5C:
                i += 2
                continue
            if c == 0x22:
                in_str = False
        elif c == 0x22:
            in_str = True
        elif c in b"[{":
            depth += 1
        elif c in b"]}":
            depth -= 1
        elif c == 0x2C and depth == 0:
            push(body[start:i])
            start = i + 1
        i += 1
    if start < n:
        push(body[start:n])
    return elements


def parse_int_prefix(value: bytes) -> int:
    """Parse a leading ASCII integer (optional ``-``); 0 if none."""
    i = 0
    n = len(value)
    while i < n and value[i] in b" \t\r\n":
        i += 1
    neg = False
    if i < n and value[i] in b"+-":
        neg = value[i] == 0x2D
        i += 1
    num = 0
    seen = False
    while i < n and 0x30 <= value[i] <= 0x39:
        num = num * 10 + (value[i] - 0x30)
        seen = True
        i += 1
    if not seen:
        return 0
    return -num if neg else num


def ascii_upper(value: bytes) -> bytes:
    return bytes((c - 32) if 0x61 <= c <= 0x7A else c for c in value)


def ascii_lower(value: bytes) -> bytes:
    return bytes((c + 32) if 0x41 <= c <= 0x5A else c for c in value)


def count_words(value: bytes) -> int:
    return len(value.split())


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


@dataclass
class Expr:
    pass


@dataclass
class Value(Expr):
    pass


@dataclass
class Key(Expr):
    pass


@dataclass
class Const(Expr):
    data: bytes = b""


@dataclass
class Param(Expr):
    """Chain-config parameter, resolved at build time to Const bytes."""

    name: str = ""
    default: Optional[str] = None


@dataclass
class Upper(Expr):
    arg: Expr = field(default_factory=Value)


@dataclass
class Lower(Expr):
    arg: Expr = field(default_factory=Value)


@dataclass
class Concat(Expr):
    args: List[Expr] = field(default_factory=list)


@dataclass
class JsonGet(Expr):
    arg: Expr = field(default_factory=Value)
    key: str = ""


@dataclass
class RegexMatch(Expr):
    arg: Expr = field(default_factory=Value)
    pattern: str = ""


@dataclass
class Contains(Expr):
    arg: Expr = field(default_factory=Value)
    literal: bytes = b""


@dataclass
class StartsWith(Expr):
    arg: Expr = field(default_factory=Value)
    literal: bytes = b""


@dataclass
class EndsWith(Expr):
    arg: Expr = field(default_factory=Value)
    literal: bytes = b""


@dataclass
class Len(Expr):
    arg: Expr = field(default_factory=Value)


@dataclass
class ParseInt(Expr):
    arg: Expr = field(default_factory=Value)


@dataclass
class IntToBytes(Expr):
    arg: Expr = None


@dataclass
class Cmp(Expr):
    cmp: str = "eq"  # eq ne lt le gt ge
    left: Expr = None
    right: Expr = None


@dataclass
class And(Expr):
    args: List[Expr] = field(default_factory=list)


@dataclass
class Or(Expr):
    args: List[Expr] = field(default_factory=list)


@dataclass
class Not(Expr):
    arg: Expr = None


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


@dataclass
class FilterProgram(Expr):
    predicate: Expr = None


@dataclass
class MapProgram(Expr):
    value: Expr = None
    key: Optional[Expr] = None  # None -> preserve input key


@dataclass
class FilterMapProgram(Expr):
    predicate: Expr = None
    value: Expr = None
    key: Optional[Expr] = None


@dataclass
class ArrayMapProgram(Expr):
    mode: str = "json_array"  # or "split"
    sep: bytes = b"\n"


AGGREGATE_COMBINES = ("add", "max", "min")  # associative monoids


@dataclass
class AggregateProgram(Expr):
    """Stateful reduction (ref transforms/aggregate.rs:22-101).

    Two authoring forms:

    - canned ``kind`` (the 5 classic reductions), or
    - a user ``contribution`` int expression over the record combined
      into the accumulator by an associative ``combine`` monoid —
      e.g. max-by-json-field: ``contribution=ParseInt(JsonGet(Value(),
      "price")), combine="max"``. Associativity is what lets every
      backend (interpreter, native, TPU segmented scan) share exact
      semantics; the canned kinds are just prebuilt instances.
    """

    kind: str = "sum_int"
    window_ms: Optional[int] = None  # windowed materialized view when set
    contribution: Optional[Expr] = None  # int expr over the record
    combine: Optional[str] = None  # one of AGGREGATE_COMBINES


# ---------------------------------------------------------------------------
# Build-time resolution & interpretation (reference semantics)
# ---------------------------------------------------------------------------


def _subst_str(s: str, params: Dict[str, str]) -> str:
    """``@param:name`` or ``@param:name=default`` string substitution."""
    if not isinstance(s, str) or not s.startswith("@param:"):
        return s
    spec = s[len("@param:") :]
    name, _, default = spec.partition("=")
    if name in params:
        return str(params[name])
    if _:
        return default
    raise KeyError(f"missing required SmartModule param {name!r}")


def resolve_params(expr: Expr, params: Dict[str, str]) -> Expr:
    """Substitute Param nodes and ``@param:`` strings (chain build time)."""
    if isinstance(expr, Param):
        if expr.name in params:
            return Const(str(params[expr.name]).encode("utf-8"))
        if expr.default is not None:
            return Const(expr.default.encode("utf-8"))
        raise KeyError(f"missing required SmartModule param {expr.name!r}")
    kwargs = {}
    for k, v in expr.__dict__.items():
        if isinstance(v, Expr):
            kwargs[k] = resolve_params(v, params)
        elif isinstance(v, list) and v and isinstance(v[0], Expr):
            kwargs[k] = [resolve_params(x, params) for x in v]
        elif isinstance(v, str):
            kwargs[k] = _subst_str(v, params)
        else:
            kwargs[k] = v
    resolved = type(expr)(**kwargs)
    # typed post-fixups for non-string fields configured via @param
    if isinstance(resolved, AggregateProgram) and isinstance(resolved.window_ms, str):
        resolved.window_ms = int(resolved.window_ms)
    return resolved


class _Interp:
    """Per-record interpreter over resolved expressions."""

    def __init__(self) -> None:
        self._regex_cache: Dict[str, Any] = {}

    def _regex(self, pattern: str):
        r = self._regex_cache.get(pattern)
        if r is None:
            r = _re.compile(pattern.encode("utf-8"))
            self._regex_cache[pattern] = r
        return r

    def eval(self, expr: Expr, value: bytes, key: Optional[bytes]):
        e = self.eval
        if isinstance(expr, Value):
            return value
        if isinstance(expr, Key):
            return key if key is not None else b""
        if isinstance(expr, Const):
            return expr.data
        if isinstance(expr, Upper):
            return ascii_upper(e(expr.arg, value, key))
        if isinstance(expr, Lower):
            return ascii_lower(e(expr.arg, value, key))
        if isinstance(expr, Concat):
            return b"".join(e(a, value, key) for a in expr.args)
        if isinstance(expr, JsonGet):
            return json_get_bytes(e(expr.arg, value, key), expr.key)
        if isinstance(expr, RegexMatch):
            return self._regex(expr.pattern).search(e(expr.arg, value, key)) is not None
        if isinstance(expr, Contains):
            return expr.literal in e(expr.arg, value, key)
        if isinstance(expr, StartsWith):
            return e(expr.arg, value, key).startswith(expr.literal)
        if isinstance(expr, EndsWith):
            return e(expr.arg, value, key).endswith(expr.literal)
        if isinstance(expr, Len):
            return len(e(expr.arg, value, key))
        if isinstance(expr, ParseInt):
            return parse_int_prefix(e(expr.arg, value, key))
        if isinstance(expr, IntToBytes):
            return str(int(e(expr.arg, value, key))).encode("ascii")
        if isinstance(expr, Cmp):
            a = e(expr.left, value, key)
            b = e(expr.right, value, key)
            return {
                "eq": a == b,
                "ne": a != b,
                "lt": a < b,
                "le": a <= b,
                "gt": a > b,
                "ge": a >= b,
            }[expr.cmp]
        if isinstance(expr, And):
            return all(e(a, value, key) for a in expr.args)
        if isinstance(expr, Or):
            return any(e(a, value, key) for a in expr.args)
        if isinstance(expr, Not):
            return not e(expr.arg, value, key)
        raise TypeError(f"cannot interpret {type(expr).__name__}")


INTERP = _Interp()


def eval_expr(expr: Expr, value: bytes, key: Optional[bytes]):
    return INTERP.eval(expr, value, key)
