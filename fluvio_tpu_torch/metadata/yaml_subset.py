"""The YAML the port reads and writes for its stored documents: the SC's
metadata files (`metadata/client.py`) and the client profile
(`client/config.py`), in place of `yaml`, which the card's machine lacks.

- `dumps` writes JSON text. JSON is YAML, so the JAX package's
  ``yaml.safe_load`` reads it to the same document: floats always carry a
  dot and a signed exponent (YAML 1.1 reads ``1e5`` as a string), and
  every character YAML does not print, or reads as a line break, is
  written as a ``\\u`` escape. Non-finite floats raise.
- `loads` reads JSON (with the same float rule) and the block style that
  ``yaml.safe_dump`` emits for such documents: nested maps, lists, ``{}``
  and ``[]``, plain, single- and double-quoted one-line strings, decimal
  ints, floats, ``true`` / ``false`` and ``null``, each resolved as
  ``yaml.safe_load`` resolves it.

Anything else (anchors, aliases, tags, block scalars, a scalar folded
over several lines, flow collections with content, comments, a plain
scalar that YAML 1.1 would read as anything but a string, an int or a
float of the forms above) raises :class:`YamlSubsetError`: the reader
never guesses.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple


class YamlSubsetError(ValueError):
    """A document outside the subset, or malformed."""


# -- writer --------------------------------------------------------------------

# characters YAML does not print (PyYAML's reader refuses them) or reads
# as a line break inside a quoted scalar
_UNSAFE = re.compile(
    "[^\x09\x0a\x0d\x20-\x7e\xa0-\u2027\u202a-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]"
)


def _str(s: str) -> str:
    return _UNSAFE.sub(lambda m: f"\\u{ord(m.group()):04x}", json.dumps(s, ensure_ascii=False))


def _float(x: float) -> str:
    if not math.isfinite(x):
        raise YamlSubsetError(f"non-finite float {x!r}")
    r = repr(x)
    mant, e, exp = r.partition("e")
    if "." not in mant:
        mant += ".0"
    return mant + e + exp


def _dump(obj: Any, indent: int, sort_keys: bool) -> str:
    if obj is None:
        return "null"
    if obj is True:
        return "true"
    if obj is False:
        return "false"
    if isinstance(obj, int):
        return str(int(obj))
    if isinstance(obj, float):
        return _float(obj)
    if isinstance(obj, str):
        return _str(obj)
    pad = "  " * (indent + 1)
    end = "  " * indent
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        items = [pad + _dump(v, indent + 1, sort_keys) for v in obj]
        return "[\n" + ",\n".join(items) + "\n" + end + "]"
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        keys = []
        for k in obj:
            if isinstance(k, bool) or not isinstance(k, (str, int)):
                raise YamlSubsetError(f"unsupported key {k!r}")
            keys.append(k)
        if sort_keys:
            keys.sort(key=str)
        items = [f"{pad}{_str(str(k))}: {_dump(obj[k], indent + 1, sort_keys)}" for k in keys]
        return "{\n" + ",\n".join(items) + "\n" + end + "}"
    raise YamlSubsetError(f"unsupported value of type {type(obj).__name__}")


def dumps(obj: Any, sort_keys: bool = False) -> str:
    """``obj`` (None, bool, int, float, str, lists and dicts of them, keys
    str or int) as JSON text that ``yaml.safe_load`` reads back equal (an
    int key comes back as its string, as with `json`)."""
    return _dump(obj, 0, sort_keys) + "\n"


# -- reader --------------------------------------------------------------------

# YAML 1.1 floats as PyYAML resolves them, narrowed to what the subset keeps
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
# PyYAML's implicit resolvers (YAML 1.1) for every plain form that is
# no string; the subset keeps `_INT`, `_FLOAT`, null and true / false of
# them and refuses the rest
_OTHER_IMPLICIT = re.compile(
    r"""(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
       |~|null|Null|NULL
       |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
       |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
       |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
       |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
       |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[\ \t]+)[0-9][0-9]?
        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?
       |<<|=)""",
    re.X,
)
_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
    "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_HEX = {"x": 2, "u": 4, "U": 8}


def _json_float(text: str) -> float:
    if not _FLOAT.fullmatch(text):
        raise YamlSubsetError(f"{text!r} is no float to YAML 1.1")
    return float(text)


def _json_constant(text: str):
    raise YamlSubsetError(f"non-finite float {text!r}")


def _plain(text: str) -> Any:
    if text in ("", "~", "null"):
        return None
    if text == "true":
        return True
    if text == "false":
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _OTHER_IMPLICIT.fullmatch(text):
        raise YamlSubsetError(f"plain scalar {text!r} is outside the subset")
    if text[0] in "-?:,[]{}#&*!|>'\"%@`" and not (text[0] in "-?:" and len(text) > 1
                                                   and text[1] != " "):
        raise YamlSubsetError(f"plain scalar {text!r} starts with an indicator")
    if ": " in text or " #" in text or text.endswith(":") or text != text.strip():
        raise YamlSubsetError(f"plain scalar {text!r} is outside the subset")
    return text


def _double(text: str) -> Tuple[str, int]:
    """(value, index past the closing quote) of a double-quoted scalar at
    the start of ``text``; it must close on its line."""
    out: List[str] = []
    i = 1
    while i < len(text):
        c = text[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= len(text):
                raise YamlSubsetError("a double-quoted scalar over several lines")
            e = text[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                n = _HEX[e]
                digits = text[i + 2 : i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YamlSubsetError(f"bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise YamlSubsetError(f"bad escape \\{e} in {text!r}")
        else:
            out.append(c)
            i += 1
    raise YamlSubsetError("a double-quoted scalar over several lines")


def _single(text: str) -> Tuple[str, int]:
    out: List[str] = []
    i = 1
    while i < len(text):
        c = text[i]
        if c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YamlSubsetError("a single-quoted scalar over several lines")


def _scalar(text: str) -> Any:
    """A whole one-line value: quoted, ``{}`` / ``[]`` or plain."""
    if text[:1] in ("'", '"'):
        value, end = (_single if text[0] == "'" else _double)(text)
        if text[end:].strip():
            raise YamlSubsetError(f"text after a quoted scalar: {text!r}")
        return value
    if text == "{}":
        return {}
    if text == "[]":
        return []
    return _plain(text)


def _split_key(content: str):
    """(key, rest after ``:``) of a mapping entry line, or None when the
    line is no entry."""
    if content[:1] in ("'", '"'):
        key, end = (_single if content[0] == "'" else _double)(content)
        rest = content[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if content.startswith("? "):
        raise YamlSubsetError("complex keys are outside the subset")
    i = content.find(": ")
    if i < 0:
        if content.endswith(":"):
            return _plain(content[:-1]), ""
        return None
    return _plain(content[:i]), content[i + 2 :].strip()


class _Block:
    def __init__(self, text: str):
        lines = text.split("\n")
        while lines and not lines[-1].strip():
            lines.pop()
        if lines and lines[0] == "---":
            lines.pop(0)
        if lines and lines[-1] == "...":
            lines.pop()
        self.lines: List[Tuple[int, str]] = []
        for raw in lines:
            if not raw.strip():
                raise YamlSubsetError("a blank line inside a block document")
            content = raw.lstrip(" ")
            if content[0] == "\t" or raw.endswith("\t"):
                raise YamlSubsetError("tabs outside quoted scalars")
            if content.startswith("#") or content in ("---", "..."):
                raise YamlSubsetError("comments and several documents are outside the subset")
            if content[0] in "&*!|>%" or content.startswith(("[", "{")) and content not in ("[]", "{}"):
                raise YamlSubsetError(f"{content!r} is outside the subset")
            self.lines.append((len(raw) - len(content), content.rstrip(" ")))
        self.i = 0

    def _peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else (None, None)

    def node(self, indent: int) -> Any:
        ind, content = self._peek()
        if content.startswith("- ") or content == "-":
            return self.sequence(ind)
        if _split_key(content) is not None:
            return self.mapping(ind)
        if ind != 0 or len(self.lines) != 1:
            raise YamlSubsetError(f"a scalar over several lines near {content!r}")
        self.i += 1
        return _scalar(content)

    def _child(self, indent: int, allow_seq_at_indent: bool) -> Any:
        """The block below an entry whose value is on the next lines."""
        ind, content = self._peek()
        if ind is None or ind < indent:
            return None
        if ind > indent:
            return self.node(ind)
        if allow_seq_at_indent and (content.startswith("- ") or content == "-"):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            ind, content = self._peek()
            if ind is None or ind < indent:
                return out
            if ind > indent:
                raise YamlSubsetError(f"a scalar over several lines near {content!r}")
            entry = _split_key(content)
            if entry is None:
                if content.startswith("- ") or content == "-":
                    return out  # a sequence at this indent closes the mapping
                raise YamlSubsetError(f"{content!r} is no mapping entry")
            key, rest = entry
            if isinstance(key, (dict, list)):
                raise YamlSubsetError("a collection as a key")
            self.i += 1
            out[key] = _scalar(rest) if rest else self._child(indent, True)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            ind, content = self._peek()
            if ind is None or ind < indent:
                return out
            if ind > indent:
                raise YamlSubsetError(f"a scalar over several lines near {content!r}")
            if not (content.startswith("- ") or content == "-"):
                return out
            if content == "-":
                self.i += 1
                out.append(self._child(indent + 1, False))
                continue
            rest = content[2:].lstrip(" ")
            inner = indent + len(content) - len(rest)
            if rest.startswith("- ") or rest == "-" or _split_key(rest) is not None:
                # the item is a block at the column of its content
                self.lines[self.i] = (inner, rest)
                out.append(self.node(inner))
            else:
                self.i += 1
                out.append(_scalar(rest))


def loads(text: str) -> Any:
    """A document of the subset (JSON, or ``yaml.safe_dump``'s block
    style) as ``yaml.safe_load`` reads it; raises :class:`YamlSubsetError`
    outside the subset."""
    if text.startswith("\ufeff"):
        text = text[1:]
    stripped = text.strip()
    if not stripped:
        return None
    if stripped[0] in "{[" and stripped not in ("{}", "[]"):
        try:
            return json.loads(stripped, parse_float=_json_float, parse_constant=_json_constant)
        except json.JSONDecodeError as e:
            raise YamlSubsetError(f"a flow document that is no JSON: {e}") from None
    block = _Block(text)
    if not block.lines:
        return None
    ind, _ = block._peek()
    out = block.node(ind)
    if block.i != len(block.lines):
        raise YamlSubsetError(f"unexpected line {block.lines[block.i][1]!r}")
    return out
