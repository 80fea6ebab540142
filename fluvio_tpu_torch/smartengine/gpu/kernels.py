"""Plain torch kernels over the RecordBuffer columns.

The port's counterparts of the XLA kernels in
``fluvio_tpu/smartengine/tpu/kernels.py``: pure functions over padded
tensors, vectorized across the record axis, with any per-byte iteration a
Python loop over the columns. Seven of them — `json_get_span`,
`striped_json_span`, `extract_span`, `dfa_match`, `dfa_compose_columns`,
`glz_resolve` and `glz_encode_match` — are the plain versions of the
CUDA kernels in ``cuda_kernels.py`` (the fused glz decode's is
``glz.decode_plain``, a byte plan plus `glz_resolve`): the
wrappers there run them for CPU tensors (the tests), and ``chip_smoke.py``
holds each kernel against them on the card. Nothing on the CUDA path calls
them. The rest are the chain's torch code
on every device: among them the aggregate stage's integer kernels
(`parse_int`, `int_to_ascii`, `count_words`, `segmented_scan`,
`propagate_last_valid`, `last_true_value`) and the array_map stage's
fan-out kernels (`split_bounds`, `json_array_bounds`, `fanout_scatter`),
which are XLA code, not Pallas, in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1

# ---------------------------------------------------------------------------
# Regex DFA scan (plain version of csrc/dfa_scan.cu)
# ---------------------------------------------------------------------------


def dfa_match(values: torch.Tensor, lengths: torch.Tensor, dfa: CompiledDfa) -> torch.Tensor:
    """Run a compiled DFA over each record; True where the regex matches.

    Column j feeds the byte's class while ``j < length``, the EOS class at
    ``j == length`` and the PAD class after it; one trailing symbol
    follows the last column (EOS for records exactly ``width`` long, PAD
    otherwise). A length of -1 reads PAD everywhere."""
    dev = values.device
    n, width = values.shape
    n_classes = dfa.n_classes
    table = torch.from_numpy(dfa.table.reshape(-1).astype(np.int64)).to(dev)
    byte_class = torch.from_numpy(dfa.byte_class.astype(np.int64)).to(dev)
    accept = torch.from_numpy(dfa.accept).to(dev)
    lengths = lengths.to(torch.int64)
    state = torch.full((n,), dfa.start, dtype=torch.int64, device=dev)
    for t in range(width):
        cls = byte_class[values[:, t].to(torch.int64)]
        cls = torch.where(
            t < lengths,
            cls,
            torch.where(t == lengths, dfa.eos_class, dfa.pad_class),
        )
        state = table[state * n_classes + cls]
    tail = torch.where(lengths == width, dfa.eos_class, dfa.pad_class)
    state = table[state * n_classes + tail]
    return accept[state]


# ---------------------------------------------------------------------------
# DFA transition composition (plain version of csrc/dfa_compose.cu)
# ---------------------------------------------------------------------------


def dfa_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose transition vectors along the trailing state axis:
    ``(b . a)[s] = b[a[s]]``, ``a`` applied first. Associative."""
    return torch.gather(b, -1, a.to(torch.int64))


def dfa_compose_columns(cls: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """Total transition function of each row's class stream.

    ``cls`` int32[rows, T] (class per column; -1 = identity, for padding
    and un-owned stripe bytes), ``table_t`` int32[C, S] (the transposed
    transition table). Returns int32[rows, S]: ``out[i, s]`` is the state
    after row i's columns starting from state s.

    The algorithm of the Pallas kernel ``_dfa_compose_kernel``: start
    from ``f = arange(S)`` and fold each column in with one table gather,
    ``f = where(c >= 0, table_t[c, f], f)``; bit-equal to the JAX
    package's blocked associative scan by associativity. Classes at or
    past C read row C-1, as the XLA path clips them (no caller produces
    them)."""
    rows, t_len = cls.shape
    n_classes, n_states = table_t.shape
    flat = table_t.reshape(-1).to(torch.int64)
    f = torch.arange(n_states, dtype=torch.int64, device=cls.device).expand(rows, n_states)
    for t in range(t_len):
        c = cls[:, t : t + 1].to(torch.int64)
        nxt = flat[c.clamp(0, n_classes - 1) * n_states + f]
        f = torch.where(c >= 0, nxt, f)
    return f.to(torch.int32).contiguous()


def dfa_compose_columns_split(cls: torch.Tensor, table_t: torch.Tensor,
                              seg_len: int) -> torch.Tensor:
    """Torch mirror of the CUDA kernel's column split, for the tests: each
    row's columns cut into segments of ``seg_len`` (the last one short,
    padded with identity), each segment's total function composed from
    the identity, then the segment functions folded in column order,
    ``out[s] = g_{P-1}[... g_0[s] ...]``. Equal to `dfa_compose_columns`
    by associativity."""
    rows, t_len = cls.shape
    n_states = table_t.shape[1]
    n_segs = max(1, -(-t_len // seg_len))
    padded = torch.full((rows, n_segs * seg_len), -1, dtype=torch.int32, device=cls.device)
    padded[:, :t_len] = cls
    seg = dfa_compose_columns(padded.view(rows * n_segs, seg_len), table_t)
    seg = seg.view(rows, n_segs, n_states)
    f = torch.arange(n_states, dtype=torch.int32, device=cls.device).expand(rows, n_states)
    for p in range(n_segs):
        f = dfa_compose(f, seg[:, p])
    return f.contiguous()


# ---------------------------------------------------------------------------
# JSON top-level field span (plain version of csrc/json_span.cu)
# ---------------------------------------------------------------------------

_P_SCAN, _P_COLON, _P_WS, _P_STR, _P_RAW, _P_DONE = range(6)


def json_needle(key: str, device) -> Tuple[torch.Tensor, int]:
    """The quoted key byte needle the structural machine matches."""
    needle = b'"' + key.encode("utf-8") + b'"'
    return torch.tensor(list(needle), dtype=torch.int32, device=device), len(needle)


def json_span_carry0(n: int, device):
    """Initial machine state, one lane per record (see `json_step`)."""
    zi = torch.zeros((n,), dtype=torch.int32, device=device)
    zb = torch.zeros((n,), dtype=torch.bool, device=device)
    return (
        torch.full((n,), _P_SCAN, dtype=torch.int32, device=device),  # phase
        zi,  # kmatch
        zb,  # in_str
        zb,  # esc
        zi,  # depth
        zi,  # d2
        zb,  # vesc
        zi,  # start
        zi,  # end
        torch.full((n,), -1, dtype=torch.int32, device=device),  # lastnw
    )


def json_step(carry, c: torch.Tensor, t, active: torch.Tensor, needle: torch.Tensor, klen: int):
    """One byte column through the structural machine (the JAX package's
    ``kernels.json_step``): (phase, progressive needle match, in-string,
    escape, brace depth, value depth, value escape, start, end, last
    non-whitespace) per lane.

    ``c`` int32 byte values, ``t`` the column's position within the
    record (the striped runner feeds absolute positions), ``active``
    which lanes this column belongs to. Returns the updated carry."""
    phase, kmatch, in_str, esc, depth, d2, vesc, start, end, lastnw = carry
    is_ws = (c == 32) | (c == 9) | (c == 13) | (c == 10)
    is_quote = c == 0x22
    is_bslash = c == 0x5C

    # phase COLON: ws -> stay; ':' -> WS phase; else abort + reprocess
    colon_here = (phase == _P_COLON) & (c == 0x3A)
    colon_abort = (phase == _P_COLON) & ~is_ws & (c != 0x3A)
    g = (phase == _P_SCAN) | colon_abort

    # general scan, inside a string
    gs = g & in_str
    s_esc_consume = gs & esc
    s_set_esc = gs & ~esc & is_bslash
    s_close = gs & ~esc & is_quote
    s_key_done = s_close & (kmatch == klen - 1)
    s_ordinary = gs & ~esc & ~is_bslash & ~is_quote
    expected = needle[kmatch.clamp(0, klen - 1).to(torch.int64)]
    k_next = torch.where((kmatch > 0) & (kmatch < klen - 1) & (c == expected), kmatch + 1, 0)
    # general scan, outside a string
    go = g & ~in_str
    o_open = go & is_quote
    o_depth_up = go & (c == 0x7B)
    o_depth_dn = go & (c == 0x7D)

    new_in_str = torch.where(active & s_close, False, torch.where(active & o_open, True, in_str))
    new_esc = torch.where(active & gs, s_set_esc, esc)
    new_depth = (
        depth + (active & o_depth_up).to(torch.int32) - (active & o_depth_dn).to(torch.int32)
    )
    new_kmatch = torch.where(active & s_ordinary, k_next, kmatch)
    new_kmatch = torch.where(active & (s_set_esc | s_esc_consume | s_close), 0, new_kmatch)
    new_kmatch = torch.where(active & o_open, (depth == 1).to(torch.int32), new_kmatch)

    # phase WS (after the colon): skip ws, classify the value start
    w = (phase == _P_WS) & active
    w_go = w & ~is_ws
    w_str = w_go & is_quote
    is_closer = (c == 0x5D) | (c == 0x7D) | (c == 0x2C)
    w_empty = w_go & ~is_quote & is_closer
    w_raw = w_go & ~is_quote & ~is_closer
    w_raw_open = w_raw & ((c == 0x5B) | (c == 0x7B))

    # phase STR (string value)
    s3 = (phase == _P_STR) & active
    s3_set_esc = s3 & ~vesc & is_bslash
    s3_close = s3 & ~vesc & is_quote

    # phase RAW (scalar / nested value)
    s4 = (phase == _P_RAW) & active
    r_open = s4 & ((c == 0x5B) | (c == 0x7B))
    r_close = s4 & ((c == 0x5D) | (c == 0x7D))
    r_comma = s4 & (c == 0x2C)
    r_end = (r_close | r_comma) & (d2 == 0)
    r_dec = r_close & (d2 > 0)

    new_phase = torch.where(active & s_key_done, _P_COLON, phase)
    new_phase = torch.where(active & colon_here, _P_WS, new_phase)
    new_phase = torch.where(active & colon_abort, _P_SCAN, new_phase)
    new_phase = torch.where(w_str, _P_STR, new_phase)
    new_phase = torch.where(w_empty, _P_DONE, new_phase)
    new_phase = torch.where(w_raw, _P_RAW, new_phase)
    new_phase = torch.where(s3_close, _P_DONE, new_phase)
    new_phase = torch.where(r_end, _P_DONE, new_phase)

    new_vesc = torch.where(s3, s3_set_esc, vesc)
    new_d2 = d2 + w_raw_open.to(torch.int32) + r_open.to(torch.int32) - r_dec.to(torch.int32)
    new_start = torch.where(w_str, t + 1, torch.where(w_raw | w_empty, t, start))
    new_end = torch.where(
        s3_close, t, torch.where(r_end, lastnw + 1, torch.where(w_empty, t, end))
    )
    new_lastnw = torch.where((w_raw & ~is_ws) | (s4 & ~r_end & ~is_ws), t, lastnw)
    return (new_phase, new_kmatch, new_in_str, new_esc, new_depth, new_d2, new_vesc,
            new_start, new_end, new_lastnw)


def json_span_finalize(final, lengths: torch.Tensor, start_cap):
    """End-of-record fixups (unterminated values run to the end) and the
    (start, length) of the machine's final state; ``start`` clips to
    ``[0, start_cap]`` (the width on the narrow path, each record's length
    on the striped one)."""
    phase, _, _, _, _, _, _, start, end, lastnw = final
    end = torch.where(phase == _P_STR, lengths, end)
    end = torch.where(phase == _P_RAW, lastnw + 1, end)
    found = (phase == _P_DONE) | (phase == _P_STR) | (phase == _P_RAW)
    vlen = torch.where(found, (end - start).clamp(min=0), 0).to(torch.int32)
    start = torch.minimum(start.clamp(min=0), torch.as_tensor(start_cap, device=start.device))
    return start.to(torch.int32), vlen


def json_get_span(
    values: torch.Tensor, lengths: torch.Tensor, key: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Field span (start, length) within each record's value bytes: the
    machine of `json_step` over the byte columns in turn. Missing or
    malformed fields give length 0. Raw values are trimmed of space, tab,
    CR and LF only (see `dsl.json_get_bytes` for the one corner where
    that differs from the host reference)."""
    dev = values.device
    needle, klen = json_needle(key, dev)
    n, width = values.shape
    lengths = lengths.to(torch.int32)
    carry = json_span_carry0(n, dev)
    for t in range(width):
        carry = json_step(carry, values[:, t].to(torch.int32), t, t < lengths, needle, klen)
    return json_span_finalize(carry, lengths, width)


def striped_json_span(
    sv: torch.Tensor, owned: torch.Tensor, first_row: torch.Tensor, k: torch.Tensor,
    lengths: torch.Tensor, key: str, kmax: int, step: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment field span over striped record bytes (plain version of
    ``fluvio_json_span_striped`` in csrc/json_span.cu; the JAX package's
    ``stripes.striped_json_span``).

    ``sv`` u8[r, s] stripe rows, ``owned`` i32[r] bytes each row owns,
    ``first_row``/``k`` i32[n] each segment's first row and stripe count,
    ``lengths`` i32[n] record lengths, ``kmax`` >= every ``k``. Stripe
    position ``kk`` feeds every segment's kk-th row through the machine,
    owned columns only, at absolute positions ``kk * step + j``, so the
    carry flows across stripe joints. Returns record-absolute (start,
    length), start clipped to the record length."""
    dev = sv.device
    r, s = sv.shape
    needle, klen = json_needle(key, dev)
    lengths = lengths.to(torch.int32)
    carry = json_span_carry0(lengths.shape[0], dev)
    for kk in range(max(kmax, 1)):
        rows = (first_row.to(torch.int64) + kk).clamp(0, r - 1)
        sm = sv[rows]
        ol = owned[rows]
        seg_active = kk < k
        for j in range(s):
            carry = json_step(carry, sm[:, j].to(torch.int32), kk * step + j,
                              seg_active & (j < ol), needle, klen)
    return json_span_finalize(carry, lengths, lengths)


# ---------------------------------------------------------------------------
# Span extraction (plain version of csrc/extract.cu)
# ---------------------------------------------------------------------------


def extract_span(
    values: torch.Tensor, start: torch.Tensor, out_lengths: torch.Tensor
) -> torch.Tensor:
    """Materialize per-record substrings: ``out[i, j] = values[i,
    clip(start[i] + j, 0, width - 1)]`` for ``j < out_lengths[i]``, 0
    beyond."""
    n, width = values.shape
    j = torch.arange(width, dtype=torch.int64, device=values.device)[None, :]
    idx = (start.to(torch.int64)[:, None] + j).clamp(0, width - 1)
    gathered = torch.gather(values, 1, idx)
    keep = j < out_lengths.to(torch.int64)[:, None]
    return torch.where(keep, gathered, torch.zeros_like(gathered))


# ---------------------------------------------------------------------------
# glz decode resolve (plain version of csrc/glz_decode.cu)
# ---------------------------------------------------------------------------

# pointer-squaring rounds: 2**3 = 8 applications of midx >= MAX_DEPTH = 6,
# so every match chain reaches its literal root
GLZ_SQUARE_ROUNDS = 3
# candidate distances (in 8-byte groups) of the encode window match
GLZ_ENC_DISTANCES = tuple(range(1, 33)) + (40, 48, 56, 64, 80, 96, 128)


def glz_resolve(base: torch.Tensor, midx: torch.Tensor, chunk: int) -> torch.Tensor:
    """Inflate a chunk-local glz byte plan (``glz.byte_plan_device``):
    base u8[n], midx i32[n] -> u8[n].

    The Pallas kernel's algorithm, chunk by chunk: sources rebased into
    their chunk (clipped into it: `compress_link` streams never leave
    it), the ragged last chunk padded with self-referencing bytes,
    `GLZ_SQUARE_ROUNDS` squarings ``idx = idx[idx]``, then one gather of
    ``base``."""
    if chunk <= 0 or chunk % 128:
        raise ValueError(f"glz chunk {chunk} is not a positive multiple of 128")
    dev = base.device
    n = base.shape[0]
    n_chunks = max(1, (n + chunk - 1) // chunk)
    padded = n_chunks * chunk
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    local = (midx.to(torch.int64) - (idx // chunk) * chunk).clamp(0, chunk - 1)
    base_p = torch.zeros((padded,), dtype=torch.uint8, device=dev)
    base_p[:n] = base
    tail = torch.arange(n - (n_chunks - 1) * chunk, chunk, dtype=torch.int64, device=dev)
    local = torch.cat([local, tail]).view(n_chunks, chunk)
    for _ in range(GLZ_SQUARE_ROUNDS):
        local = torch.gather(local, 1, local)
    return torch.gather(base_p.view(n_chunks, chunk), 1, local).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# glz encode window match (plain version of csrc/glz_encode.cu)
# ---------------------------------------------------------------------------


def glz_square_rounds(chunk_groups: int) -> int:
    """ceil(log2(chunk_groups)), at least 1: enough pointer jumps to carry
    a chain across a whole chunk."""
    return max(1, (max(chunk_groups, 2) - 1).bit_length())


def glz_encode_match(w0: torch.Tensor, w1: torch.Tensor, const_m: torch.Tensor,
                     chunk_groups: int) -> torch.Tensor:
    """Literal-root source of every 8-byte group: w0, w1 i32[G], const_m
    bool[G] -> global roots i32[G] (root == g: a literal).

    The Pallas kernel's algorithm, chunk by chunk: a group's candidate is
    the group at the smallest of `GLZ_ENC_DISTANCES` (below the chunk
    size, within the chunk) with equal words, both groups outside
    constant runs; then `glz_square_rounds` squarings ``cand =
    cand[cand]`` carry every chain to its root. Pad groups of the last
    chunk are ineligible roots of their own."""
    if chunk_groups <= 0 or chunk_groups % 128:
        raise ValueError(f"glz chunk groups {chunk_groups} is not a positive multiple of 128")
    dev = w0.device
    g_count = w0.shape[0]
    n_chunks = max(1, (g_count + chunk_groups - 1) // chunk_groups)
    padded = n_chunks * chunk_groups

    def blocks(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((padded,), dtype=torch.int32, device=dev)
        out[:g_count] = x
        return out.view(n_chunks, chunk_groups)

    a, b, nc = blocks(w0), blocks(w1), blocks((~const_m).to(torch.int32))
    idx = torch.arange(chunk_groups, dtype=torch.int64, device=dev)
    cand = idx.expand(n_chunks, chunk_groups).clone()
    for d in reversed(GLZ_ENC_DISTANCES):  # the last write, the smallest d, wins
        if d >= chunk_groups:
            continue
        eq = (a[:, d:] == a[:, :-d]) & (b[:, d:] == b[:, :-d]) & (nc[:, d:] != 0) & (nc[:, :-d] != 0)
        cand[:, d:] = torch.where(eq, idx[None, d:] - d, cand[:, d:])
    for _ in range(glz_square_rounds(chunk_groups)):
        cand = torch.gather(cand, 1, cand)
    base = torch.arange(n_chunks, dtype=torch.int64, device=dev)[:, None] * chunk_groups
    return (cand + base).reshape(-1)[:g_count].to(torch.int32)


# ---------------------------------------------------------------------------
# Result compaction
# ---------------------------------------------------------------------------


def pack_mask(valid: torch.Tensor) -> torch.Tensor:
    """bool[N] -> little-endian bitmask u8[ceil(N/8)]; the host rebuilds
    survivor indices with ``np.unpackbits(bitorder="little")``."""
    n = valid.shape[0]
    v = valid.to(torch.uint8)
    pad = (-n) % 8
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=valid.device)
    return (v.view(-1, 8).to(torch.int32) * weights).sum(dim=1).to(torch.uint8)


def compact_rows(mask: torch.Tensor, *arrays: torch.Tensor):
    """Scatter surviving rows to the front; returns (count, packed arrays).

    Rows past the survivor count hold zeros. Each array scatters into
    ``n + 1`` rows with every dropped row aimed at row ``n``, which is cut
    off: no host synchronisation (``torch.nonzero`` would need one)."""
    n = mask.shape[0]
    dest = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    dest = torch.where(mask, dest, n)
    out = []
    for arr in arrays:
        full = arr.new_zeros((n + 1,) + tuple(arr.shape[1:]))
        index = dest.view((n,) + (1,) * (arr.dim() - 1)).expand_as(arr)
        full.scatter_(0, index, arr)
        out.append(full[:n])
    return mask.to(torch.int32).sum(), tuple(out)


# ---------------------------------------------------------------------------
# Literal search, case folding
# ---------------------------------------------------------------------------


def literal_search(values: torch.Tensor, lengths: torch.Tensor, literal: bytes) -> torch.Tensor:
    """Substring search via windowed equality: K shifted compares over the
    byte matrix, no sequential scan."""
    n, width = values.shape
    k = len(literal)
    if k == 0:
        return torch.ones((n,), dtype=torch.bool, device=values.device)
    if k > width:
        return torch.zeros((n,), dtype=torch.bool, device=values.device)
    span = width - k + 1
    acc = values[:, 0:span] == literal[0]
    for i in range(1, k):
        acc &= values[:, i : i + span] == literal[i]
    pos_ok = (
        torch.arange(span, dtype=torch.int32, device=values.device)[None, :] + k
        <= lengths.to(torch.int32)[:, None]
    )
    return (acc & pos_ok).any(dim=1)


def literal_startswith(values: torch.Tensor, lengths: torch.Tensor, literal: bytes) -> torch.Tensor:
    n, width = values.shape
    k = len(literal)
    if k == 0:
        return torch.ones((n,), dtype=torch.bool, device=values.device)
    if k > width:
        return torch.zeros((n,), dtype=torch.bool, device=values.device)
    lit = torch.tensor(list(literal), dtype=torch.uint8, device=values.device)
    ok = (values[:, :k] == lit[None, :]).all(dim=1)
    return ok & (lengths >= k)


def literal_endswith(values: torch.Tensor, lengths: torch.Tensor, literal: bytes) -> torch.Tensor:
    n, width = values.shape
    k = len(literal)
    if k == 0:
        return torch.ones((n,), dtype=torch.bool, device=values.device)
    if k > width:
        return torch.zeros((n,), dtype=torch.bool, device=values.device)
    start = lengths.to(torch.int64) - k
    idx = start[:, None] + torch.arange(k, dtype=torch.int64, device=values.device)[None, :]
    tail = torch.gather(values, 1, idx.clamp(0, width - 1))
    lit = torch.tensor(list(literal), dtype=torch.uint8, device=values.device)
    return (tail == lit[None, :]).all(dim=1) & (lengths >= k)


def ascii_upper(values: torch.Tensor) -> torch.Tensor:
    lower = (values >= 0x61) & (values <= 0x7A)
    return torch.where(lower, values - 32, values)


def ascii_lower(values: torch.Tensor) -> torch.Tensor:
    upper = (values >= 0x41) & (values <= 0x5A)
    return torch.where(upper, values + 32, values)


# ---------------------------------------------------------------------------
# Integer parse / render, word count (aggregate contributions and outputs)
# ---------------------------------------------------------------------------

# a digit 64 or more places from the end of its run weighs 10**k = 2**k *
# 5**k, a multiple of 2**64: it vanishes from the wrapped int64 value
_PARSE_WINDOW = 64


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1, ``mask.shape[1]`` where none."""
    first = mask.to(torch.uint8).argmax(dim=1)  # argmax returns the first maximum
    return torch.where(mask.any(dim=1), first, mask.shape[1])


def _pow10_wrapped(count: int, device) -> torch.Tensor:
    """10**k mod 2**64 as int64, k = 0..count-1 (numpy's uint64 products wrap)."""
    p = np.full(count, 10, dtype=np.uint64)
    p[0] = 1
    return torch.from_numpy(np.cumprod(p).view(np.int64)).to(device)


def parse_int(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Leading ASCII integer per record, i64[N] (parity: `dsl.parse_int_prefix`
    and the JAX package's ``kernels.parse_int``): skip space, tab, CR and
    LF, take an optional sign, then the digit run; 0 where there is none.

    The reference steps ``num = num * 10 + d`` through every column in
    wrapping int64. Products and sums mod 2**64 form a ring, so the same
    value is ``sum(d_j * 10**(end - 1 - j))`` mod 2**64 over the run, and
    only its last `_PARSE_WINDOW` digits can contribute: one gather of
    that window replaces the column loop."""
    n, width = values.shape
    dev = values.device
    j = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    lengths = lengths.to(torch.int32)
    inrec = j < lengths[:, None]
    is_ws = (values == 32) | (values == 9) | (values == 13) | (values == 10)
    first = _first_true(inrec & ~is_ws)
    c0 = torch.gather(values, 1, first.clamp(max=width - 1)[:, None])[:, 0]
    sign = (first < width) & ((c0 == 0x2B) | (c0 == 0x2D))
    neg = sign & (c0 == 0x2D)
    ds = first + sign.to(first.dtype)
    is_digit = (values >= 0x30) & (values <= 0x39) & inrec
    end = _first_true(~is_digit & (j >= ds[:, None]))
    k = torch.arange(_PARSE_WINDOW, dtype=torch.int64, device=dev)[None, :]
    pos = end[:, None] - _PARSE_WINDOW + k  # the window's last column is end - 1
    run = (pos >= ds[:, None]) & (pos >= 0)
    digits = torch.gather(values, 1, pos.clamp(0, width - 1)).to(torch.int64) - 0x30
    weights = _pow10_wrapped(_PARSE_WINDOW, dev).flip(0)[None, :]
    num = torch.where(run, digits * weights, 0).sum(dim=1)
    return torch.where(neg, -num, num)


INT_ASCII_WIDTH = 20  # sign + 19 digits covers all of int64
_POW10 = [10**k for k in range(19)]  # 10**18 is the largest that fits int64


def int_to_ascii(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render int64 as ASCII decimal: (u8[N, 20], lengths i32[N]).

    torch has no uint64 for ``|x|``: the digits come from ``-|x|``, which
    int64 holds for every value, INT64_MIN included (truncating division
    and remainder keep every quotient <= 0 and every remainder in -9..0)."""
    dev = x.device
    x = x.to(torch.int64)
    neg = x < 0
    m = torch.where(neg, x, -x)  # -|x|
    pow10 = torch.tensor(_POW10, dtype=torch.int64, device=dev)
    ndigits = 1 + (m[:, None] <= -pow10[None, 1:]).sum(dim=1).to(torch.int32)
    length = ndigits + neg.to(torch.int32)
    j = torch.arange(INT_ASCII_WIDTH, dtype=torch.int32, device=dev)[None, :]
    digit_idx = j - neg[:, None].to(torch.int32)
    pos = (ndigits[:, None] - 1 - digit_idx).clamp(0, len(_POW10) - 1)
    q = torch.div(m[:, None], pow10[pos.to(torch.int64)], rounding_mode="trunc")
    ch = (0x30 - torch.fmod(q, 10)).to(torch.uint8)
    sign_pos = (j == 0) & neg[:, None]
    out = torch.where(sign_pos, 0x2D, ch)
    in_range = (digit_idx >= 0) & (digit_idx < ndigits[:, None])
    return torch.where(in_range | sign_pos, out, 0).to(torch.uint8), length


def _is_ws(c: torch.Tensor) -> torch.Tensor:
    """``bytes.strip()``'s whitespace: tab, LF, VT, FF, CR, space."""
    return ((c >= 9) & (c <= 13)) | (c == 32)


def count_words(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Whitespace-separated token count per record, i64[N] (parity:
    ``len(bytes.split())``)."""
    n, width = values.shape
    inrec = (torch.arange(width, dtype=torch.int32, device=values.device)[None, :]
             < lengths.to(torch.int32)[:, None])
    nonws = ~_is_ws(values) & inrec
    prev_ws = torch.ones_like(nonws)
    prev_ws[:, 1:] = ~nonws[:, :-1]
    return (nonws & prev_ws).sum(dim=1)


# ---------------------------------------------------------------------------
# array_map element bounds (fan-out)
# ---------------------------------------------------------------------------
#
# The bounds kernels emit per-position grids: flag[N, W] marks the position
# where an element is emitted (ascending position = element order in the
# record), with the element's (start, length) within the record's value
# bytes; a per-record final slot holds the one element a scan can finish
# only at the record's end. `fanout_scatter` places them in output rows.


def _next_index_ge(cond: torch.Tensor) -> torch.Tensor:
    """``out[:, j]`` = the smallest j' >= j with ``cond[:, j']``, else the
    width: a reverse running minimum along the byte axis."""
    width = cond.shape[1]
    j = torch.arange(width, dtype=torch.int32, device=cond.device)[None, :]
    cand = torch.where(cond, j, width)
    return torch.cummin(cand.flip(1), dim=1).values.flip(1)


def split_bounds(values: torch.Tensor, lengths: torch.Tensor, sep: bytes):
    """Element bounds of ``value.split(sep)`` with empty elements dropped
    (non-overlapping separator matches, left to right).

    Returns (flag bool[N, W], start i32[N, W], elen i32[N, W], fflag
    bool[N], fstart i32[N], felen i32[N], err bool[N]); split mode never
    errs. A one-byte separator is vectorized; a longer one needs the
    reference's scan over the columns (a match hides the next L-1)."""
    n, width = values.shape
    dev = values.device
    lengths = lengths.to(torch.int32)
    j = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    inrec = j < lengths[:, None]
    no_final = torch.zeros((n,), dtype=torch.bool, device=dev)
    zeros_n = torch.zeros((n,), dtype=torch.int32, device=dev)
    if len(sep) == 1:
        m = (values == sep[0]) & inrec
        prev_boundary = torch.ones_like(m)
        prev_boundary[:, 1:] = m[:, :-1]
        starts = inrec & ~m & prev_boundary
        elen = _next_index_ge(m | ~inrec) - j
        return (starts, j.expand(n, width).contiguous(), torch.where(starts, elen, 0),
                no_final, zeros_n, zeros_n, no_final)

    sep_len = len(sep)
    match = torch.ones((n, width), dtype=torch.bool, device=dev)
    for i, b in enumerate(sep):
        shifted = torch.zeros_like(match)
        shifted[:, : width - i] = values[:, i:] == b
        match &= shifted
    match &= j + sep_len <= lengths[:, None]
    skip = torch.zeros((n,), dtype=torch.int32, device=dev)
    seg_start = torch.zeros((n,), dtype=torch.int32, device=dev)
    flags, starts, lens = [], [], []
    for t in range(width):
        is_sep = match[:, t] & (t >= skip)
        ln = t - seg_start
        emit = is_sep & (ln > 0)
        flags.append(emit)
        starts.append(torch.where(emit, seg_start, 0))
        lens.append(torch.where(emit, ln, 0))
        skip = torch.where(is_sep, t + sep_len, skip)
        seg_start = torch.where(is_sep, t + sep_len, seg_start)
    flen = lengths - seg_start
    fflag = flen > 0
    return (torch.stack(flags, 1), torch.stack(starts, 1), torch.stack(lens, 1),
            fflag, seg_start, torch.where(fflag, flen, 0), no_final)


def json_array_bounds(values: torch.Tensor, lengths: torch.Tensor):
    """Element bounds of a top-level JSON array explode, bit-equal to
    `dsl.json_array_elements`: outer whitespace stripped, ``[`` / ``]``
    required (``err`` where absent), a comma at depth 0 outside strings
    ends an element (a backslash in a string skips the next byte), each
    element trimmed of whitespace and of its quotes when fully quoted,
    empty elements dropped. The same 7-tuple as `split_bounds`; the final
    slot stays empty (every element ends at a comma or the closing
    bracket, both inside the grid).

    The reference's scan over the columns, step for step: the string,
    escape and depth state cannot be found without walking."""
    n, width = values.shape
    dev = values.device
    lengths = lengths.to(torch.int32)
    j = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    inrec = j < lengths[:, None]
    ws = _is_ws(values)
    nonws = ~ws & inrec
    fa = _first_true(nonws)
    fb = torch.where(nonws.any(dim=1), width - 1 - _first_true(nonws.flip(1)), -1)
    open_b = torch.gather(values, 1, fa.clamp(0, width - 1)[:, None])[:, 0]
    close_b = torch.gather(values, 1, fb.clamp(0, width - 1)[:, None])[:, 0]
    err = (fa >= width) | (open_b != 0x5B) | (close_b != 0x5D) | (fb <= fa)
    ok = ~err

    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    neg1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    in_str, esc, depth = zb, zb, zi
    seg_fnw, seg_lnw, first_b, last_b = neg1, neg1, zi, zi
    flags, starts, lens = [], [], []
    for t in range(width):
        col = values[:, t].to(torch.int32)
        ws_col = ws[:, t]
        body = (t > fa) & (t < fb) & ok
        closer = (t == fb) & ok
        b_str = body & in_str
        b_out = body & ~in_str
        set_esc = b_str & ~esc & (col == 0x5C)
        s_close = b_str & ~esc & (col == 0x22)
        o_open = b_out & (col == 0x22)
        o_up = b_out & ((col == 0x5B) | (col == 0x7B))
        o_dn = b_out & ((col == 0x5D) | (col == 0x7D))
        comma = b_out & (col == 0x2C) & (depth == 0)
        boundary = comma | closer

        # the segment's trim trackers skip the delimiter itself
        upd = body & ~ws_col & ~comma
        fresh = upd & (seg_fnw < 0)
        n_fnw = torch.where(fresh, t, seg_fnw)
        n_first = torch.where(fresh, col, first_b)
        n_lnw = torch.where(upd, t, seg_lnw)
        n_last = torch.where(upd, col, last_b)
        quoted = (n_fnw >= 0) & (n_first == 0x22) & (n_last == 0x22) & (n_lnw > n_fnw)
        st = n_fnw + quoted.to(torch.int32)
        ln = n_lnw - quoted.to(torch.int32) - st + 1
        emit = boundary & (n_fnw >= 0) & (ln > 0)
        flags.append(emit)
        starts.append(torch.where(emit, st, 0))
        lens.append(torch.where(emit, ln, 0))

        in_str = torch.where(s_close, False, torch.where(o_open, True, in_str))
        esc = torch.where(b_str, set_esc, esc)
        depth = depth + o_up.to(torch.int32) - o_dn.to(torch.int32)
        seg_fnw = torch.where(boundary, -1, n_fnw)
        seg_lnw = torch.where(boundary, -1, n_lnw)
        first_b = torch.where(boundary, 0, n_first)
        last_b = torch.where(boundary, 0, n_last)
    return (torch.stack(flags, 1), torch.stack(starts, 1), torch.stack(lens, 1),
            zb, zi, zi, err)


def fanout_scatter(flag, start_g, len_g, fflag, fstart, flen, contributing, cap: int):
    """Place element descriptors in ``cap`` output rows.

    Each record's elements follow its grid positions in order, then its
    final slot; records follow one another. The placement is a gather, as
    in the reference: the running count of flags over the flattened
    ``[N, W + 1]`` grid is non-decreasing, so output row r takes the first
    position where it reaches r + 1 (``searchsorted``, left side). Returns
    (total i32 — exact, before the cap, so the caller detects an overflow
    —, local_row i32[cap], rel_start i32[cap], elen i32[cap])."""
    n, width = flag.shape
    dev = flag.device
    flag = flag & contributing[:, None]
    fflag = fflag & contributing
    allflag = torch.cat([flag, fflag[:, None]], dim=1).reshape(-1)
    cum = torch.cumsum(allflag, 0, dtype=torch.int32)
    del allflag
    total = cum[-1]
    pos = torch.searchsorted(cum, torch.arange(1, cap + 1, dtype=torch.int32, device=dev))
    del cum
    pos = pos.clamp(0, n * (width + 1) - 1)
    live = torch.arange(cap, dtype=torch.int32, device=dev) < total.clamp(max=cap)
    allstart = torch.cat([start_g.to(torch.int32), fstart.to(torch.int32)[:, None]], dim=1)
    alllen = torch.cat([len_g.to(torch.int32), flen.to(torch.int32)[:, None]], dim=1)
    out_row = torch.where(live, pos // (width + 1), 0).to(torch.int32)
    out_start = torch.where(live, allstart.reshape(-1)[pos], 0)
    out_len = torch.where(live, alllen.reshape(-1)[pos], 0)
    return total, out_row, out_start, out_len


# ---------------------------------------------------------------------------
# Segmented prefix scans (aggregate)
# ---------------------------------------------------------------------------

# combine monoids: (neutral, op)
_AGG_OPS = {
    "add": (0, torch.add),
    "max": (INT64_MIN, torch.maximum),
    "min": (INT64_MAX, torch.minimum),
}


def segmented_scan(x: torch.Tensor, reset: torch.Tensor, op_name: str) -> torch.Tensor:
    """Inclusive segmented scan of int64 ``x``: a True in ``reset`` starts
    a new running value.

    ``add``, as in the reference: ``cumsum[i] - cumsum[last_reset(i) - 1]``
    with the last reset found by a running maximum over flagged indices
    (int64 addition wraps and is associative in any order). ``max`` and
    ``min``: a log-step (Hillis-Steele) scan of the reference's
    associative combine over (flag, value) pairs, ``(fa | fb, vb if fb
    else op(va, vb))``: exact for integers, ceil(log2 N) steps."""
    n = x.shape[0]
    if op_name == "add":
        idx = torch.arange(n, dtype=torch.int64, device=x.device)
        c = torch.cumsum(x, 0)
        last_reset = torch.cummax(torch.where(reset, idx, -1), 0).values
        base = torch.where(last_reset >= 1, c[(last_reset - 1).clamp(0, n - 1)], 0)
        return c - base
    op = _AGG_OPS[op_name][1]
    f, v = reset, x
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], op(v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d <<= 1
    return v


def last_true_value(flags: torch.Tensor, values: torch.Tensor,
                    fallback: torch.Tensor) -> torch.Tensor:
    """The value at the last True flag, else ``fallback`` (a 0-d tensor);
    no host synchronisation."""
    n = flags.shape[0]
    li = torch.where(flags, torch.arange(n, dtype=torch.int64, device=flags.device), -1).max()
    at = values.index_select(0, li.clamp(0, n - 1).view(1))[0]
    return torch.where(li >= 0, at, fallback)


def propagate_last_valid(values: torch.Tensor, valid: torch.Tensor):
    """Inclusive forward fill of the last valid value: (filled, has_any).
    Rows before any valid one take row 0's value, as the reference's
    gather does; ``has_any`` gates every consumer."""
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    li = torch.cummax(torch.where(valid, idx, -1), 0).values
    return values[li.clamp(0, n - 1)], li >= 0
