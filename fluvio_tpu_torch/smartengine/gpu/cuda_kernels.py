"""Wrappers of the hand-written CUDA kernels on the chain's path.

The port's counterpart of ``fluvio_tpu/smartengine/tpu/pallas_kernels.py``
for the Pallas kernels the port runs, and one kernel of its own:

- `json_get_span` replaces `_json_scan_kernel` / `json_get_span_pallas`
  (``csrc/json_span.cu``);
- `extract_span` replaces `_extract_kernel` / `extract_pallas`
  (``csrc/extract.cu``);
- `dfa_match` replaces `_dfa_scan_kernel` / `dfa_match_pallas`
  (``csrc/dfa_scan.cu``);
- `dfa_compose_columns` replaces `_dfa_compose_kernel` /
  `dfa_compose_columns_pallas` (``csrc/dfa_compose.cu``);
- `glz_decode` (the up link's decode, tokens straight to bytes) and
  `glz_resolve` (the Pallas kernel's own ``(base, midx)`` contract) replace
  `_glz_resolve_kernel` / `glz_decode_pallas` (``csrc/glz_decode.cu``);
- `glz_encode_match` replaces `_glz_enc_match_kernel` /
  `glz_encode_match` (``csrc/glz_encode.cu``);
- `striped_json_span` replaces the XLA scan of the JAX package's
  ``stripes.striped_json_span``, which has no Pallas kernel
  (``csrc/json_span.cu``, second entry point).

Each wrapper runs the plain torch version (``kernels.py``) for a tensor on
the CPU — that is what the tests exercise — and for a CUDA tensor launches
its kernel on the current stream or raises; there is no fallback. It checks
device, dtype, shape and contiguity, allocates the outputs, and adds one to
its entry in `LAUNCHES` where it launches. What bounds each kernel on the
card and what its design does about it is in the note at the top of its
source file.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa
from fluvio_tpu_torch.smartengine.gpu import glz, kernels
from fluvio_tpu_torch.smartengine.gpu.native import KERNELS, check

# kernel launches since the last `reset_launches()`
LAUNCHES: Dict[str, int] = {
    "json_span": 0, "extract": 0, "dfa_scan": 0, "dfa_compose": 0, "json_span_striped": 0,
    "glz_resolve": 0, "glz_enc_match": 0, "glz_decode": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); anything else — mixed devices, another
    backend — raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=64)
def _needle(key: str, device: torch.device) -> Tuple[torch.Tensor, int]:
    """The key in quotes on ``device``, and 1 unless the key holds a
    backslash or a quote (which the machine never matches). The launcher
    puts the needle in shared memory where it fits, else reads it from
    global memory: any key length runs."""
    raw = key.encode("utf-8")
    data = np.frombuffer(b'"' + raw + b'"', dtype=np.uint8).copy()
    return torch.from_numpy(data).to(device), int(b'"' not in raw and b"\\" not in raw)


def json_get_span(
    values: torch.Tensor, lengths: torch.Tensor, key: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JSON field span (start, length) per record: values u8[N, W],
    lengths i32[N] -> start i32[N], vlen i32[N]."""
    if not _on_cuda("json_get_span", values, lengths):
        return kernels.json_get_span(values, lengths, key)
    n, width = values.shape
    _expect("json_get_span values", values, torch.uint8, (n, width))
    _expect("json_get_span lengths", lengths, torch.int32, (n,))
    needle, matchable = _needle(key, values.device)
    start = torch.empty((n,), dtype=torch.int32, device=values.device)
    vlen = torch.empty((n,), dtype=torch.int32, device=values.device)
    fn = KERNELS.function("fluvio_json_span")
    with torch.cuda.device(values.device):
        rc = fn(
            values.data_ptr(), lengths.data_ptr(), needle.data_ptr(), needle.numel(),
            matchable, n, width, start.data_ptr(), vlen.data_ptr(), _stream(values.device),
        )
    check(rc, "json_span")
    LAUNCHES["json_span"] += 1
    return start, vlen


def extract_span(
    values: torch.Tensor, start: torch.Tensor, vlen: torch.Tensor
) -> torch.Tensor:
    """Per-record substrings: values u8[N, W], start i32[N], vlen i32[N]
    -> u8[N, W], each row shifted left by ``start`` and zeroed from
    ``vlen`` on."""
    if not _on_cuda("extract_span", values, start, vlen):
        return kernels.extract_span(values, start, vlen)
    n, width = values.shape
    _expect("extract_span values", values, torch.uint8, (n, width))
    _expect("extract_span start", start, torch.int32, (n,))
    _expect("extract_span vlen", vlen, torch.int32, (n,))
    out = torch.empty((n, width), dtype=torch.uint8, device=values.device)
    fn = KERNELS.function("fluvio_extract")
    with torch.cuda.device(values.device):
        rc = fn(
            values.data_ptr(), start.data_ptr(), vlen.data_ptr(), n, width,
            out.data_ptr(), _stream(values.device),
        )
    check(rc, "extract")
    LAUNCHES["extract"] += 1
    return out


def _dfa_tables(dfa: CompiledDfa, device: torch.device):
    """The DFA's tables on ``device``, uploaded once per device: the
    transition table as one byte per entry when state ids fit a byte, else
    two; the byte-class map as two bytes; acceptance as one. Two-byte
    entries travel as int16 (ids <= 257 keep their bits) and the kernel
    reads them as uint16."""
    key = str(device)
    tables = dfa.device_tables.get(key)
    if tables is None:
        dtype = np.uint8 if dfa.n_states <= 256 else np.int16
        tables = (
            torch.from_numpy(np.ascontiguousarray(dfa.table, dtype=dtype)).to(device),
            torch.from_numpy(np.ascontiguousarray(dfa.byte_class, dtype=np.int16)).to(device),
            torch.from_numpy(np.ascontiguousarray(dfa.accept, dtype=np.uint8)).to(device),
        )
        dfa.device_tables[key] = tables
    return tables


def dfa_match(values: torch.Tensor, lengths: torch.Tensor, dfa: CompiledDfa) -> torch.Tensor:
    """Per-record DFA verdict: values u8[N, W], lengths i32[N] -> bool[N]
    (True where the regex matches)."""
    if not _on_cuda("dfa_match", values, lengths):
        return kernels.dfa_match(values, lengths, dfa)
    n, width = values.shape
    _expect("dfa_match values", values, torch.uint8, (n, width))
    _expect("dfa_match lengths", lengths, torch.int32, (n,))
    if dfa.n_states > 257 or dfa.n_classes > 258:
        raise ValueError(
            f"dfa_match: table {dfa.n_states}x{dfa.n_classes} exceeds what the compiler emits"
        )
    table, byte_class, accept = _dfa_tables(dfa, values.device)
    out = torch.empty((n,), dtype=torch.bool, device=values.device)
    fn = KERNELS.function("fluvio_dfa_scan")
    with torch.cuda.device(values.device):
        rc = fn(
            values.data_ptr(), lengths.data_ptr(), table.data_ptr(), table.element_size(),
            byte_class.data_ptr(), accept.data_ptr(), dfa.n_states, dfa.n_classes,
            dfa.eos_class, dfa.pad_class, dfa.start, n, width, out.data_ptr(),
            _stream(values.device),
        )
    check(rc, "dfa_scan")
    LAUNCHES["dfa_scan"] += 1
    return out


def dfa_compose_columns(cls: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """Per-row total transition function: cls i32[rows, T] (-1 =
    identity), table_t i32[C, S] -> i32[rows, S]. The kernel composes
    column segments of a length it picks from S and T and folds them in
    column order."""
    if not _on_cuda("dfa_compose_columns", cls, table_t):
        return kernels.dfa_compose_columns(cls, table_t)
    rows, t_len = cls.shape
    n_classes, n_states = table_t.shape
    _expect("dfa_compose_columns cls", cls, torch.int32, (rows, t_len))
    _expect("dfa_compose_columns table_t", table_t, torch.int32, (n_classes, n_states))
    if n_states > 257 or n_classes > 258 or n_states < 1 or n_classes < 1:
        raise ValueError(
            f"dfa_compose_columns: table {n_classes}x{n_states} is not one the compiler emits"
        )
    out = torch.empty((rows, n_states), dtype=torch.int32, device=cls.device)
    fn = KERNELS.function("fluvio_dfa_compose")
    with torch.cuda.device(cls.device):
        rc = fn(cls.data_ptr(), table_t.data_ptr(), n_states, n_classes, rows, t_len,
                out.data_ptr(), _stream(cls.device))
    check(rc, "dfa_compose")
    LAUNCHES["dfa_compose"] += 1
    return out


def striped_json_span(
    sv: torch.Tensor, owned: torch.Tensor, first_row: torch.Tensor, k: torch.Tensor,
    lengths: torch.Tensor, key: str, kmax: int, step: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment JSON field span over stripe rows: sv u8[r, s], owned
    i32[r], first_row / k / lengths i32[n] -> record-absolute start
    i32[n], vlen i32[n]. ``kmax`` (>= every k) bounds only the plain
    version's loop; the kernel walks each segment's own k rows."""
    if not _on_cuda("striped_json_span", sv, owned, first_row, k, lengths):
        return kernels.striped_json_span(sv, owned, first_row, k, lengths, key, kmax, step)
    r, s = sv.shape
    n = lengths.shape[0]
    _expect("striped_json_span sv", sv, torch.uint8, (r, s))
    _expect("striped_json_span owned", owned, torch.int32, (r,))
    for name, t in (("first_row", first_row), ("k", k), ("lengths", lengths)):
        _expect(f"striped_json_span {name}", t, torch.int32, (n,))
    needle, matchable = _needle(key, sv.device)
    start = torch.empty((n,), dtype=torch.int32, device=sv.device)
    vlen = torch.empty((n,), dtype=torch.int32, device=sv.device)
    fn = KERNELS.function("fluvio_json_span_striped")
    with torch.cuda.device(sv.device):
        rc = fn(
            sv.data_ptr(), owned.data_ptr(), first_row.data_ptr(), k.data_ptr(),
            lengths.data_ptr(), needle.data_ptr(), needle.numel(), matchable, n, s, step,
            start.data_ptr(), vlen.data_ptr(), _stream(sv.device),
        )
    check(rc, "json_span_striped")
    LAUNCHES["json_span_striped"] += 1
    return start, vlen


def glz_resolve(base: torch.Tensor, midx: torch.Tensor, chunk: int) -> torch.Tensor:
    """Inflate a chunk-local glz byte plan: base u8[n], midx i32[n] (from
    ``glz.byte_plan_device``), the stream's chunk (a multiple of 128) ->
    u8[n]."""
    if not _on_cuda("glz_resolve", base, midx):
        return kernels.glz_resolve(base, midx, chunk)
    n = base.shape[0]
    _expect("glz_resolve base", base, torch.uint8, (n,))
    _expect("glz_resolve midx", midx, torch.int32, (n,))
    if chunk <= 0 or chunk % 128:
        raise ValueError(f"glz_resolve: chunk {chunk} is not a positive multiple of 128")
    out = torch.empty((n,), dtype=torch.uint8, device=base.device)
    fn = KERNELS.function("fluvio_glz_resolve")
    with torch.cuda.device(base.device):
        rc = fn(base.data_ptr(), midx.data_ptr(), n, chunk, out.data_ptr(), _stream(base.device))
    check(rc, "glz_resolve")
    LAUNCHES["glz_resolve"] += 1
    return out


_GLZ_TILE = 2048  # sequences a scan tile of the fused decode (csrc/glz_decode.cu)


def glz_decode(lit_lens: torch.Tensor, match_lens: torch.Tensor, srcs: torch.Tensor,
               lits: torch.Tensor, out_len: int, chunk: int, depth: int) -> torch.Tensor:
    """Decode a `compress_link` stream's token arrays straight to bytes:
    lit_lens u8[ns], match_lens u8[ns], srcs i32[ns] (zero-padded past the
    real sequences, as ``pad_glz_tokens`` stages them), lits u8[nl], the
    decoded size, the link chunk (a multiple of 128) and the stream's
    depth (1..8) -> u8[out_len]. The plain version is the byte plan plus
    the resolve (`glz.decode_plain`); what the kernel assumes of the
    stream is in the note atop its source."""
    if chunk <= 0 or chunk % 128:
        raise ValueError(f"glz_decode: chunk {chunk} is not a positive multiple of 128")
    if not 1 <= depth <= 1 << kernels.GLZ_SQUARE_ROUNDS:
        raise ValueError(f"glz_decode: depth {depth} outside 1..{1 << kernels.GLZ_SQUARE_ROUNDS}")
    if not _on_cuda("glz_decode", lit_lens, match_lens, srcs, lits):
        return glz.decode_plain(lit_lens, match_lens, srcs, lits, out_len, chunk)
    ns = lit_lens.shape[0]
    nl = lits.shape[0]
    _expect("glz_decode lit_lens", lit_lens, torch.uint8, (ns,))
    _expect("glz_decode match_lens", match_lens, torch.uint8, (ns,))
    _expect("glz_decode srcs", srcs, torch.int32, (ns,))
    _expect("glz_decode lits", lits, torch.uint8, (nl,))
    if not 0 <= out_len < 1 << 31 or (out_len and (ns == 0 or nl == 0)):
        raise ValueError(f"glz_decode: {ns} sequences and {nl} literals cannot make {out_len} B")
    dev = lit_lens.device
    out = torch.empty((out_len,), dtype=torch.uint8, device=dev)
    tile_sums = torch.empty((2 * max(1, -(-ns // _GLZ_TILE)),), dtype=torch.int32, device=dev)
    mdst = torch.empty((max(ns, 1),), dtype=torch.int32, device=dev)
    fn = KERNELS.function("fluvio_glz_decode")
    with torch.cuda.device(dev):
        rc = fn(lit_lens.data_ptr(), match_lens.data_ptr(), srcs.data_ptr(), lits.data_ptr(),
                ns, nl, out_len, chunk, depth, tile_sums.data_ptr(), mdst.data_ptr(),
                out.data_ptr(), _stream(dev))
    check(rc, "glz_decode")
    LAUNCHES["glz_decode"] += 1
    return out


def glz_encode_match(w0: torch.Tensor, w1: torch.Tensor, const_m: torch.Tensor,
                     chunk_groups: int) -> torch.Tensor:
    """Literal-root source of every 8-byte group: w0, w1 i32[G], const_m
    bool[G], groups per chunk (a multiple of 128) -> global roots i32[G]
    (root == g: a literal). Two launches a call at most, whatever the
    chunk size (the tiled resolve and its join, ``csrc/glz_encode.cu``)."""
    if not _on_cuda("glz_encode_match", w0, w1, const_m):
        return kernels.glz_encode_match(w0, w1, const_m, chunk_groups)
    g_count = w0.shape[0]
    _expect("glz_encode_match w0", w0, torch.int32, (g_count,))
    _expect("glz_encode_match w1", w1, torch.int32, (g_count,))
    _expect("glz_encode_match const_m", const_m, torch.bool, (g_count,))
    if chunk_groups <= 0 or chunk_groups % 128:
        raise ValueError(
            f"glz_encode_match: chunk groups {chunk_groups} is not a positive multiple of 128"
        )
    out = torch.empty((g_count,), dtype=torch.int32, device=w0.device)
    fn = KERNELS.function("fluvio_glz_enc_match")
    with torch.cuda.device(w0.device):
        rc = fn(w0.data_ptr(), w1.data_ptr(), const_m.data_ptr(), g_count, chunk_groups,
                out.data_ptr(), _stream(w0.device))
    check(rc, "glz_enc_match")
    LAUNCHES["glz_enc_match"] += 1
    return out
