"""The port's regex -> DFA compiler against the JAX package's.

Same pattern in, identical tables out (exact equality): ``table``,
``byte_class``, ``accept``, ``start``, ``eos_class``, ``pad_class``, packed
and unpacked, plus `literal_of` and the patterns both refuse.
"""

from __future__ import annotations

import numpy as np
import pytest

from fluvio_tpu.ops import regex_dfa as ref
from fluvio_tpu_torch.ops import regex_dfa as port
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

PATTERNS = [
    "fluvio",
    "flu[vV]io",
    "^fluvio$",
    "^(fluvio|kafka|pulsar)-[0-3]$",
    r"\d+-\w*",
    "a.b",
    "[^abc]x",
    "(ab|cd)*e",
    "x{2,4}y{3}",
    r"[\x7e-\xff]+",
    "colou?r$",
    "^$",
    "a|b|c",
    r"\s\S\.",
    "(?:ab)+?c",
]
UNSUPPORTED = ["(?=a)", "a{20}", "a^b", r"\b", "(a"]


def _assert_same(a, b):
    np.testing.assert_array_equal(a.table, b.table)
    assert a.table.dtype == b.table.dtype
    np.testing.assert_array_equal(a.byte_class, b.byte_class)
    np.testing.assert_array_equal(a.accept, b.accept)
    assert (a.start, a.eos_class, a.pad_class) == (b.start, b.eos_class, b.pad_class)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_equal(pattern):
    _assert_same(port.compile_regex(pattern), ref.compile_regex(pattern))
    _assert_same(
        port.compile_regex(pattern, packed=False), ref.compile_regex(pattern, packed=False)
    )
    _assert_same(port.compile_regex_cached(pattern), ref.compile_regex(pattern))
    assert port.literal_of(pattern) == ref.literal_of(pattern)


@pytest.mark.parametrize("pattern", UNSUPPORTED)
def test_same_refusals(pattern):
    with pytest.raises(ref.UnsupportedRegex):
        ref.compile_regex(pattern)
    with pytest.raises(port.UnsupportedRegex):
        port.compile_regex(pattern)
    assert port.literal_of(pattern) == ref.literal_of(pattern)
