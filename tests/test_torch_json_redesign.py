"""Executable spec of the warp-per-record JSON span design of
``csrc/json_span.cu`` (TPU kernel #1's wide-row design and the port-only
striped kernel), on the CPU.

`warp_span` is a numpy model of what one warp does for one record: it
walks the record's bytes a chunk at a time (32 lanes of ``lane_bytes``
bytes each) and carries a small state across chunks and stripe joints:

- the string state ``(in_str, esc)`` as one of three states (out, in,
  in after a backslash); every byte is a map of the three states, each
  lane composes its bytes' maps and a shuffle-style scan over the lanes
  gives every lane its entry state, so every byte's state is exact;
  backslashes act only inside strings;
- the brace depth, a prefix sum of ``{`` minus ``}`` outside strings;
- key candidates: a quote that opens a string at depth 1 whose content
  equals the key byte for byte and is closed by the very next byte (a
  key holding a backslash or a quote never matches; the empty key matches
  ``""``); a candidate still matching at the end of a chunk carries its
  progress into the next chunk;
- after a candidate, ``ws* ':'``: any other byte aborts and is scanned
  again with the general state, which whitespace never changed;
- the value: a string ends at the next closing quote under the same
  string states; a raw value at the first ``]``, ``}`` or ``,`` where its
  own bracket depth (strings ignored) is zero, trimmed back to the last
  non-whitespace byte; unterminated values end as ``json_span_finalize``
  ends them.

No product path runs it. It is held here against the port's plain
versions (``kernels.json_get_span`` / ``kernels.striped_json_span``), the
JAX package's XLA kernel and its Pallas kernel in interpret mode (on
inputs without the Pallas kernel's colon-abort fault, ROADMAP §3), at
chunks of 32 bytes (one byte a lane) and 1,024 bytes (32 bytes a lane,
the kernel's own), with keys, colons and values across chunk boundaries
and stripe joints (``StripeParams(64, 64, 16)``). A simdjson-style escape
rule (a quote after an odd run of backslashes is escaped, in a string or
not) is shown to give other answers, which is why the design carries the
three-state map. Every output is an integer, so every check is exact
(tolerance 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluvio_tpu.smartengine.tpu import kernels as jax_kernels
from fluvio_tpu.smartengine.tpu import pallas_kernels
from fluvio_tpu.smartengine.tpu import stripes as ref_stripes
from fluvio_tpu.smartmodule import dsl as ref_dsl
from fluvio_tpu_torch.smartengine.gpu import kernels, stripes
from tests.test_torch_kernels import (
    VT_CORNER, _TOKENS_ANY, _TOKENS_NO_ABORT, _edge_docs, _garbage, _stage,
)
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_torch_stripes import S, V, _json_corpus, _striped
from tests.test_tpu_kernels import JSON_DOCS

LANES = 32
_A, _B, _C = 0, 1, 2  # outside a string, inside, inside after a backslash
_IDENTITY = _A | _B << 2 | _C << 4
_SCAN, _COLON, _WS, _STR, _RAW, _DONE = range(6)
_WS_BYTES = (0x20, 0x09, 0x0D, 0x0A)
KEYS = ["name", "n", "", "na\\me", 'na"me', "nämé"]
KEY_IDS = ["name", "n", "empty", "backslash", "quote", "utf8"]
ALPHABET = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


def _apply(f, s):
    return (f >> (2 * s)) & 3


def _compose(g, f):
    """g after f, lane by lane (packed 2-bit images of A, B, C)."""
    return sum(_apply(g, _apply(f, s)) << (2 * s) for s in range(3))


def _lane_maps(q, bs, valid):
    """Each lane's composed map over its valid bytes: three simulations
    (entry states A, B, C) held as the sets of simulations in each state."""
    xa = np.full(LANES, 0b001)
    xb = np.full(LANES, 0b010)
    xc = np.full(LANES, 0b100)
    for k in range(q.shape[1]):
        qk, bk, vk = q[:, k], bs[:, k], valid[:, k]
        na = np.where(qk, xb, xa)
        nb = np.where(qk, xa | xc, np.where(bk, xc, xb | xc))
        nc = np.where(bk, xb, 0)
        xa, xb, xc = np.where(vk, na, xa), np.where(vk, nb, xb), np.where(vk, nc, xc)
    f = np.zeros(LANES, dtype=np.int64)
    for s in range(3):
        img = np.where((xa >> s) & 1, _A, np.where((xb >> s) & 1, _B, _C))
        f |= img << (2 * s)
    return f


def _scan_maps(f):
    """Inclusive Hillis-Steele scan of the lanes' maps, as the shuffles
    do it: after step d, lane l holds f_l o ... o f_{l-2d+1}."""
    out = f.copy()
    for d in (1, 2, 4, 8, 16):
        prev = np.concatenate([np.full(d, _IDENTITY), out[:-d]])
        out = _compose(out, prev)
    return out


def _map_states(grid, valid, carry):
    """Exact state before every byte and the chunk's exit state; ``carry``
    is the state before the chunk. Where the chunk holds a backslash, the
    three-state map scan; else quote parity (every quote flips A and B, a
    carried C takes the chunk's first byte as escaped), the kernel's fast
    path, which is the same map there."""
    q, bs = (grid == 0x22) & valid, (grid == 0x5C) & valid
    if not bs.any():
        s0, qp = carry, q.copy()
        if carry == _C:
            s0, qp[0, 0] = _B, False
        lane_odd = qp.sum(1) & 1
        s_in = s0 ^ np.concatenate([[0], np.cumsum(lane_odd)[:-1] & 1])
        below = (np.cumsum(qp, axis=1) - qp) & 1
        st = np.where(s_in[:, None] ^ below, _B, _A)
        if carry == _C:
            st[0, 0] = _C
        return st, int(s0 ^ (qp.sum() & 1))
    scanned = _scan_maps(_lane_maps(q, bs, valid))
    entry = np.concatenate([[carry], _apply(scanned[:-1], carry)])
    s = entry.copy()
    st = np.zeros(grid.shape, dtype=np.int64)
    for k in range(grid.shape[1]):
        st[:, k] = s
        qk, bk = q[:, k], bs[:, k]
        ns = np.where(s == _C, _B, np.where(qk, np.where(s == _A, _B, _A),
                                            np.where(bk & (s == _B), _C, s)))
        s = np.where(valid[:, k], ns, s)
    return st, int(_apply(scanned[-1], carry))


def _odd_run_states(grid, valid, carry):
    """The simdjson rule, for the counter-test: a quote after an odd run of
    backslashes is escaped wherever it stands; other quotes toggle the
    string. ``carry`` is (in_str, odd run open)."""
    in_str, odd = carry
    flat, vflat = grid.reshape(-1), valid.reshape(-1)
    st = np.zeros(flat.shape, dtype=np.int64)
    for j in range(flat.size):
        if not vflat[j]:
            continue
        st[j] = _B if in_str else _A
        c = flat[j]
        if c == 0x5C:
            odd = not odd
            continue
        if c == 0x22 and not odd:
            in_str = not in_str
        odd = False
    return st.reshape(grid.shape), (in_str, odd)


def _first(mask, p):
    hits = np.flatnonzero(mask[p:])
    return int(hits[0]) + p if hits.size else -1


def warp_span(pieces, key: str, start_cap: int, record_len: int, lane_bytes: int = 32,
              escape_rule: str = "map"):
    """(start, vlen) of ``key``'s value in one record given as ``pieces``,
    a list of (bytes as uint8 array, record position of the first byte),
    walked chunk by chunk as one warp walks it."""
    needle = np.frombuffer(b'"' + key.encode("utf-8") + b'"', dtype=np.uint8)
    klen = needle.size
    matchable = not np.isin(needle[1:-1], (0x22, 0x5C)).any()
    chunk_size = LANES * lane_bytes
    mode, depth, kpend, d2, lastnw, start, end = _SCAN, 0, 0, 0, -1, 0, 0
    sst = _A if escape_rule == "map" else (False, False)
    for data, base in pieces:
        for off in range(0, len(data), chunk_size):
            if mode == _DONE:
                break
            chunk = data[off: off + chunk_size]
            cl = len(chunk)
            padded = np.zeros(chunk_size, dtype=np.uint8)
            padded[:cl] = chunk
            grid = padded.reshape(LANES, lane_bytes)
            valid = (np.arange(chunk_size) < cl).reshape(LANES, lane_bytes)
            # the general machine over the whole chunk: string states, depth,
            # candidate opens (a warp skips this while a raw value runs)
            if escape_rule == "map":
                st, sst_out = _map_states(grid, valid, sst)
            else:
                st, sst_out = _odd_run_states(grid, valid, sst)
            q = (grid == 0x22) & valid
            lb_a = (grid == 0x7B) & valid & (st == _A)
            rb_a = (grid == 0x7D) & valid & (st == _A)
            lane_delta = lb_a.sum(1) - rb_a.sum(1)
            depth_in = depth + np.concatenate([[0], np.cumsum(lane_delta)[:-1]])
            rel = np.cumsum(lb_a.astype(np.int64) - rb_a, axis=1) - (lb_a.astype(np.int64) - rb_a)
            cand = (q & (st == _A) & (depth_in[:, None] + rel == 1)).reshape(-1) & matchable
            close_b = (q & (st == _B)).reshape(-1)
            nonws = (~np.isin(grid, _WS_BYTES) & valid).reshape(-1)
            flat = padded
            p = 0
            while mode != _DONE:
                if mode == _SCAN:
                    if kpend:
                        n = min(klen - kpend, cl)
                        if np.array_equal(flat[:n], needle[kpend: kpend + n]):
                            if kpend + n == klen:
                                mode, p, kpend = _COLON, n, 0
                                continue
                            kpend += n
                            break
                        kpend = 0
                    j = _first(cand, p)
                    if j < 0:
                        break
                    n = min(klen - 1, cl - j - 1)
                    if np.array_equal(flat[j + 1: j + 1 + n], needle[1: 1 + n]):
                        if n == klen - 1:
                            mode, p = _COLON, j + klen
                            continue
                        kpend = 1 + n
                        break
                    p = j + 1
                elif mode == _COLON:
                    j = _first(nonws, p)
                    if j < 0:
                        break
                    if flat[j] == 0x3A:
                        mode, p = _WS, j + 1
                    else:
                        mode, p = _SCAN, j  # the byte is scanned again
                elif mode == _WS:
                    j = _first(nonws, p)
                    if j < 0:
                        break
                    c = int(flat[j])
                    if c == 0x22:
                        mode, start, p = _STR, base + off + j + 1, j + 1
                    elif c in (0x5D, 0x7D, 0x2C):
                        mode, start, end = _DONE, base + off + j, base + off + j
                    else:
                        mode, start, lastnw, p = _RAW, base + off + j, base + off + j, j + 1
                        d2 = int(c in (0x5B, 0x7B))
                elif mode == _STR:
                    j = _first(close_b, p)
                    if j < 0:
                        break
                    mode, end = _DONE, base + off + j
                else:  # _RAW: the value's own bracket depth, strings ignored
                    b = flat[:cl].astype(np.int64)
                    delta = np.where(np.isin(b, (0x5B, 0x7B)), 1,
                                     np.where(np.isin(b, (0x5D, 0x7D)), -1, 0))
                    delta[:p] = 0
                    before = d2 + np.cumsum(delta) - delta
                    ends = np.isin(b, (0x5D, 0x7D, 0x2C)) & (before == 0)
                    ends[:p] = False
                    j = _first(ends, 0)
                    stop = cl if j < 0 else j
                    nw = np.flatnonzero(nonws[p:stop])
                    if nw.size:
                        lastnw = base + off + p + int(nw[-1])
                    if j >= 0:
                        mode, end = _DONE, lastnw + 1
                    else:
                        d2 += int(delta.sum())
                    break
            sst = sst_out
            depth += int(lane_delta.sum())
    if mode == _STR:
        end = record_len
    if mode == _RAW:
        end = lastnw + 1
    found = mode in (_DONE, _STR, _RAW)
    vlen = max(end - start, 0) if found else 0
    return min(max(start, 0), start_cap), vlen


def spec_json_get_span(values: np.ndarray, lengths: np.ndarray, key: str, lane_bytes: int = 32,
                       escape_rule: str = "map"):
    """The narrow layout: one piece a record (its first min(len, W) bytes),
    start clipped to the width."""
    n, width = values.shape
    out = [warp_span([(values[i, : max(0, min(int(lengths[i]), width))], 0)], key, width,
                     int(lengths[i]), lane_bytes, escape_rule) for i in range(n)]
    return (np.array([o[0] for o in out], np.int32), np.array([o[1] for o in out], np.int32))


def spec_striped_json_span(sv, owned, first_row, k, lengths, key: str, step: int,
                           lane_bytes: int = 32):
    """The striped layout: a record's owned stripe bytes, row by row, at
    record positions kk * step + j; start clipped to the record length."""
    out = []
    for i in range(len(lengths)):
        rows = [int(first_row[i]) + kk for kk in range(int(k[i]))]
        pieces = [(sv[r, : int(owned[r])], kk * step) for kk, r in enumerate(rows)]
        out.append(warp_span(pieces, key, int(lengths[i]), int(lengths[i]), lane_bytes))
    return (np.array([o[0] for o in out], np.int32), np.array([o[1] for o in out], np.int32))


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------


def _plain(values, lengths, key):
    st, ln = kernels.json_get_span(torch.from_numpy(values), torch.from_numpy(lengths), key)
    return st.numpy(), ln.numpy()


def _xla(values, lengths, key):
    st, ln = jax_kernels.json_get_span(values, lengths, key)
    return np.asarray(st), np.asarray(ln)


def _pallas(values, lengths, key):
    st, ln = pallas_kernels.json_get_span_pallas(values, lengths, key, interpret=True)
    return np.asarray(st), np.asarray(ln)


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"start vs {what}")
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"vlen vs {what}")


def _straddle_docs(boundary: int, key: bytes = b"name"):
    """JSON records whose key, colon and value start a few bytes either
    side of ``boundary``: a pad string shifts them through it, with
    whitespace around the colon, string, raw, nested and escaped values."""
    values = [b'"fluvio-7"', b"12345", b'{"a":[1,"]"]}', b'"e\\"s\\\\c"', b"[1, [2], 3]",
              b'""', b"true"]
    docs = []
    for shift in range(-12, 6):
        lead = b'{"p":"' + b"x" * max(0, boundary + shift - 8) + b'",'
        for m, v in enumerate(values):
            gap = b" " * (m % 3)
            docs.append(lead + b'"' + key + b'"' + gap + b":" + gap + v + b',"z":0}')
    return docs


def _late_key_docs(rng, count, lo, hi):
    docs = []
    for i in range(count):
        pad = b"p" * int(rng.integers(lo, hi))
        kind = i % 4
        if kind == 0:
            docs.append(b'{"pad":"%s","name":"kafka-%d","n":%d}' % (pad, i & 3, i))
        elif kind == 1:
            docs.append(b'{"pad":"%s","n":%d}' % (pad, i))
        elif kind == 2:
            docs.append(b'{"pad":"%s","name":%s' % (pad, b"7" * int(rng.integers(1, 40))))
        else:
            docs.append(b'{"name":"fluvio-%d","pad":"%s"}' % (i & 7, pad))
    return docs


# ---------------------------------------------------------------------------
# narrow layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lane_bytes", [1, 32], ids=["chunk32", "chunk1024"])
@pytest.mark.parametrize("key", KEYS, ids=KEY_IDS)
def test_spec_matches_all_references_on_json_docs(key, lane_bytes):
    """JSON_DOCS, the vt/ff corner, records of length 0, W-1 and W, and the
    key itself at depth 1 and 2: spec = plain = XLA for every key, and =
    Pallas (interpret) for every key without a backslash or a quote (see
    `test_keys_with_a_backslash_or_a_quote_follow_the_xla_kernel`)."""
    docs = list(JSON_DOCS) + VT_CORNER + _edge_docs()
    docs += [b'{"' + key.encode() + b'":"hit"}', b'{"a":{"' + key.encode() + b'":1}}']
    values, lengths = _stage(docs)
    got = spec_json_get_span(values, lengths, key, lane_bytes)
    _assert_same(got, _plain(values, lengths, key), "plain")
    _assert_same(got, _xla(values, lengths, key), "XLA")
    if '"' not in key and "\\" not in key:
        _assert_same(got, _pallas(values, lengths, key), "Pallas")


@pytest.mark.parametrize("key", ["na\\me", 'na"me'], ids=["backslash", "quote"])
def test_keys_with_a_backslash_or_a_quote_follow_the_xla_kernel(key):
    """Reference fault: the Pallas kernel and ``dsl.json_get_bytes`` compare
    the quoted key byte for byte, so they find a key holding a backslash
    or a quote; the XLA kernel's progressive match resets on a backslash
    and closes the string on a quote, so it never does. The port's plain
    version and the spec follow the XLA kernel."""
    doc = b'{"' + key.encode() + b'":"hit"}'
    values, lengths = _stage([doc])
    xla = _xla(values, lengths, key)
    assert int(xla[1][0]) == 0
    _assert_same(_plain(values, lengths, key), xla, "XLA")
    _assert_same(spec_json_get_span(values, lengths, key, 1), xla, "XLA")
    pallas = _pallas(values, lengths, key)
    assert doc[int(pallas[0][0]): int(pallas[0][0]) + int(pallas[1][0])] == b"hit"
    assert ref_dsl.json_get_bytes(doc, key) == b"hit"


@pytest.mark.parametrize("lane_bytes", [1, 32], ids=["chunk32", "chunk1024"])
@pytest.mark.parametrize("source", ["alphabet", "raw", "tokens", "tokens-any"])
def test_spec_matches_on_garbage(source, lane_bytes):
    """Random bytes of the JSON alphabet, raw random bytes (backslashes
    and quotes outside strings) and random JSON tokens: spec = plain =
    XLA for every key; where the tokens never leave a key without its
    colon (and the key is not empty), the Pallas kernel is held to them
    too."""
    rng = np.random.default_rng({"alphabet": 11, "raw": 12, "tokens": 13, "tokens-any": 14}[source])
    width = 64
    if source == "alphabet":
        docs = [ALPHABET[rng.integers(0, ALPHABET.size, size=int(rng.integers(0, width + 1)))]
                .tobytes() for _ in range(384)]
    elif source == "raw":
        docs = [rng.integers(0, 256, size=int(rng.integers(0, width + 1))).astype(np.uint8)
                .tobytes() for _ in range(384)]
    else:
        docs = _garbage(rng, 384, width, _TOKENS_NO_ABORT if source == "tokens" else _TOKENS_ANY)
    values, lengths = _stage(docs, width)
    for key in ("n", "", "ab", "name"):
        got = spec_json_get_span(values, lengths, key, lane_bytes)
        _assert_same(got, _plain(values, lengths, key), f"plain key={key!r}")
        _assert_same(got, _xla(values, lengths, key), f"XLA key={key!r}")
        if source == "tokens" and key:
            _assert_same(got, _pallas(values, lengths, key), f"Pallas key={key!r}")


@pytest.mark.parametrize("key", ["name", "n", "", "nämé"], ids=["name", "n", "empty", "utf8"])
def test_spec_key_colon_value_across_a_32_byte_chunk(key):
    """Key, colon and value at every offset around byte 32 of a 96-byte
    row, one byte a lane: spec = plain = XLA = Pallas."""
    values, lengths = _stage(_straddle_docs(32, key.encode()), 96)
    got = spec_json_get_span(values, lengths, key, lane_bytes=1)
    _assert_same(got, _plain(values, lengths, key), "plain")
    _assert_same(got, _xla(values, lengths, key), "XLA")
    _assert_same(got, _pallas(values, lengths, key), "Pallas")


def test_spec_across_a_1024_byte_chunk_and_late_keys():
    """The kernel's own chunk (32 bytes a lane): key, colon and value
    around byte 1,024, late and missing keys in rows of ~1-2 KB, any
    garbage of the JSON alphabet after a long pad, a key longer than
    a 32-byte chunk: spec = plain = XLA."""
    rng = np.random.default_rng(1024)
    docs = _straddle_docs(1024) + _late_key_docs(rng, 48, 800, 1900)
    long_key = "k" * 40
    docs += [b'{"p":"' + b"x" * m + b'","' + long_key.encode() + b'":"long"}' for m in range(0, 60, 7)]
    docs += [b'{"p":"' + b"x" * 900 + b'",'
             + ALPHABET[rng.integers(0, ALPHABET.size, size=300)].tobytes() for _ in range(16)]
    width = 2048
    values, lengths = _stage(docs, width)
    assert (lengths <= width).all()
    for key, lane_bytes in (("name", 32), ("n", 32), (long_key, 1), (long_key, 32)):
        got = spec_json_get_span(values, lengths, key, lane_bytes)
        _assert_same(got, _plain(values, lengths, key), f"plain key={key!r}")
        _assert_same(got, _xla(values, lengths, key), f"XLA key={key!r}")
    # the long key spans two 32-byte chunks: the carried progress found it
    st, vl = spec_json_get_span(values, lengths, long_key, lane_bytes=1)
    assert sum(int(v) == 4 for v in vl) == 9


# ---------------------------------------------------------------------------
# striped layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lane_bytes", [1, 32], ids=["chunk32", "chunk1024"])
@pytest.mark.parametrize("key", ["name", "pad", "n", ""])
def test_spec_matches_striped_references(key, lane_bytes):
    """Stripes of 64 bytes overlapping by 16 (a 48-byte step): keys, colons
    and values across every joint and every 32-byte chunk edge. Spec over
    the owned stripe bytes = the port's plain striped version = the JAX
    package's XLA striped scan = the narrow spec on the whole records."""
    docs = _json_corpus() + _straddle_docs(48) + _straddle_docs(96)
    lengths, count, (ref_plan, ref_sv), (port_plan, port_sv), kmax = _striped(docs)
    n = len(lengths)
    owned = stripes.owned_lengths(port_plan)
    args = (port_sv.numpy(), owned.numpy(), port_plan["first_row"].numpy(),
            port_plan["k"].numpy(), lengths)
    got = spec_striped_json_span(*args, key, port_plan["step"], lane_bytes)
    plain = kernels.striped_json_span(port_sv, owned, port_plan["first_row"], port_plan["k"],
                                      torch.from_numpy(lengths), key, kmax, port_plan["step"])
    _assert_same(got, (plain[0].numpy(), plain[1].numpy()), "plain striped")
    ref_kmax = int(ref_stripes.stripe_counts(np.asarray([max(lengths)]), S, V)[0])
    ref = jax.jit(lambda sv: ref_stripes.striped_json_span(
        sv, ref_plan, jnp.asarray(lengths), key, ref_kmax, n))(ref_sv)
    _assert_same(got, (np.asarray(ref[0]), np.asarray(ref[1])), "JAX striped")
    values, lens = _stage(docs, int(max(lengths)))
    narrow = spec_json_get_span(values, lens, key, lane_bytes)
    _assert_same((got[0][: len(docs)], got[1][: len(docs)]),
                 (np.minimum(narrow[0], lens), narrow[1]), "narrow spec")


def test_spec_striped_late_keys_and_garbage():
    """Late, missing and unterminated fields and alphabet garbage over
    several stripes, at the kernel's chunk: spec = plain striped."""
    rng = np.random.default_rng(77)
    docs = _late_key_docs(rng, 40, 60, 300) + [
        ALPHABET[rng.integers(0, ALPHABET.size, size=int(rng.integers(40, 400)))].tobytes()
        for _ in range(40)]
    lengths, count, _, (port_plan, port_sv), kmax = _striped(docs)
    owned = stripes.owned_lengths(port_plan)
    for key in ("name", "n"):
        got = spec_striped_json_span(port_sv.numpy(), owned.numpy(),
                                     port_plan["first_row"].numpy(), port_plan["k"].numpy(),
                                     lengths, key, port_plan["step"])
        plain = kernels.striped_json_span(port_sv, owned, port_plan["first_row"], port_plan["k"],
                                          torch.from_numpy(lengths), key, kmax, port_plan["step"])
        _assert_same(got, (plain[0].numpy(), plain[1].numpy()), f"plain striped key={key!r}")


# ---------------------------------------------------------------------------
# why the three-state map
# ---------------------------------------------------------------------------


def test_simdjson_escape_rule_fails():
    """The odd-backslash-run rule escapes a quote outside a string, which
    this machine does not: on such records it gives other spans, while
    the three-state map gives the plain version's."""
    docs = [b'{\\"name":"v"}', b'{"a":1,\\"name":2}', b'\\"{"name":"x"}',
            b'{"name":"a\\\\"}', b'{"q":"\\\\\\"","name":3}']
    rng = np.random.default_rng(3)
    docs += [ALPHABET[rng.integers(0, ALPHABET.size, size=int(rng.integers(0, 65)))].tobytes()
             for _ in range(256)]
    values, lengths = _stage(docs, 64)
    for key in ("name", "n"):
        want = _plain(values, lengths, key)
        _assert_same(spec_json_get_span(values, lengths, key, 1), want, f"map key={key!r}")
    want = _plain(values, lengths, "name")
    wrong = spec_json_get_span(values, lengths, "name", 1, escape_rule="odd-run")
    differs = (wrong[0] != want[0]) | (wrong[1] != want[1])
    # {\"name":"v"}: the machine opens a string at the quote after the
    # backslash and finds "v"; the odd-run rule takes that quote as escaped
    assert differs[0] and (int(want[0][0]), int(want[1][0])) == (10, 1)
    assert differs.sum() >= 2
