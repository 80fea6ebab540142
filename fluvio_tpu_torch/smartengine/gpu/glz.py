"""glz link compression: the host compressor and the card's two halves.

The port's counterpart of the JAX package's ``smartengine/tpu/glz.py``.
glz is a list of LZ4-shaped sequences (literal run + match) whose matches
never overlap their own output and whose match-chain depth is capped at
`MAX_DEPTH`, so decoding is a fixed number of gathers instead of a serial
walk (the format is described at the top of ``native/glz.cpp``).

- **Up link.** The host compresses the staged ragged flat in independent
  chunks (`compress_link`, over the port's own copy of ``glz.cpp``); on
  the card `byte_plan_device` turns the tokens into a per-byte plan and
  `decode_link_flat` resolves it with the ``glz_resolve`` CUDA kernel.
- **Down link.** The card encodes a result byte stream into the same
  wire format (`encode_result`: group words, constant runs, the
  ``glz_enc_match`` CUDA kernel, sequence formation); the host decodes it
  with the native decoder (`decode_result_host`).

Both halves are off unless a `LinkParams` asks for them; nothing here
reads an environment variable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.smartengine.gpu import kernels
from fluvio_tpu_torch.telemetry.compiles import note_build

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "glz.cpp"
_BUILD_DIR = _SOURCE.parent / "_build"
_lock = threading.Lock()
_lib = None

MAX_DEPTH = 6       # gather rounds the device decode needs at most
MIN_MATCH = 8       # sequences are 6 B; shorter matches don't pay
MIN_INPUT = 4096    # below this the link time is noise: ship raw
# the compressed stream (seqs * 6 + lits) must come in under this
# fraction of the raw bytes, or the batch ships raw
MAX_RATIO = 0.75
# link streams compress in independent chunks of this many output bytes;
# every match source stays inside its own chunk
GLZ_CHUNK = 256 * 1024

# decline reasons (the JAX package's telemetry vocabulary)
DECLINE_BELOW_MIN = "glz-below-min"
DECLINE_RATIO = "glz-ratio"
DECLINE_ENC_RATIO = "glz-enc-ratio"

ENC_GROUP = 8        # bytes per match group (== MIN_MATCH)
ENC_MAX_RUN = 31     # groups per sequence half: 248 bytes <= the u8 field


class GlzUnavailable(RuntimeError):
    """The host compressor library could not be built or loaded."""


def check_chunk(chunk: int) -> None:
    """A link chunk must be a multiple of 1024 of at least 4096 bytes
    (chunk starts stay word-aligned and every kernel block whole)."""
    if chunk < 4096 or chunk % 1024:
        raise ValueError(f"glz chunk {chunk}: need a multiple of 1024 >= 4096")


@dataclass(frozen=True)
class LinkParams:
    """glz link compression of a chain (both halves off by default).

    ``compress`` ships each batch's record bytes to the card as glz tokens
    and decodes them there; ``result_compress`` encodes view descriptors
    on the card and downloads the tokens when they are smaller than the
    raw columns; ``chunk`` is the link chunk in bytes."""

    compress: bool = False
    result_compress: bool = False
    chunk: int = GLZ_CHUNK

    def __post_init__(self) -> None:
        check_chunk(self.chunk)

    @property
    def any(self) -> bool:
        return self.compress or self.result_compress


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


class _GlzResult(ctypes.Structure):
    _fields_ = [
        ("n_seqs", ctypes.c_int64),
        ("n_lits", ctypes.c_int64),
        ("depth", ctypes.c_int32),
        ("status", ctypes.c_int32),
    ]


def load():
    """Build ``native/glz.cpp`` with g++ at first use (keyed by the
    source's hash) and bind it; raises :class:`GlzUnavailable`. A failure
    is not cached: the engine refuses to build a chain that needs the
    library, so nothing retries per batch."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            t0 = time.perf_counter()
            digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
            out = _BUILD_DIR / f"glz-{digest}.so"
            cached = out.exists()
            if not cached:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SOURCE), "-o", str(tmp)],
                    check=True, capture_output=True,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            note_build("g++", "glz.cpp", time.perf_counter() - t0, cached=cached)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise GlzUnavailable(
                f"glz compressor library did not build: {e} "
                f"{detail.decode(errors='replace')[-400:]}"
            ) from e
        lib.glz_compress.restype = _GlzResult
        lib.glz_compress.argtypes = [
            _U8P, ctypes.c_int64, _U8P, _U8P, _I32P, ctypes.c_int64, _U8P, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.glz_decompress.restype = ctypes.c_int32
        lib.glz_decompress.argtypes = [
            _U8P, _U8P, _I32P, ctypes.c_int64, _U8P, ctypes.c_int64, _U8P, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


class Compressed(NamedTuple):
    lit_lens: np.ndarray    # uint8[n_seqs]
    match_lens: np.ndarray  # uint8[n_seqs]
    srcs: np.ndarray        # int32[n_seqs], absolute output positions
    lits: np.ndarray        # uint8[n_lits]
    depth: int              # gather rounds needed (<= MAX_DEPTH)
    out_len: int            # decompressed size == len(raw)
    # chunked streams (`compress_link`): the chunk size and the first
    # sequence of each chunk (host bookkeeping; 0 / None otherwise)
    chunk_bytes: int = 0
    chunk_seqs: Optional[np.ndarray] = None  # int32[n_chunks + 1]

    @property
    def nbytes(self) -> int:
        return self.lit_lens.nbytes + self.match_lens.nbytes + self.srcs.nbytes + self.lits.nbytes


def compress(raw: np.ndarray, max_ratio: float = MAX_RATIO) -> Optional[Compressed]:
    """Compress a uint8 array as one whole-buffer stream; None when raw
    is the better ship (tiny, incompressible, or over ``max_ratio``)."""
    lib = load()
    n = int(raw.size)
    if n < MIN_INPUT:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    seq_cap = n // 4 + 64
    lit_lens = np.empty(seq_cap, dtype=np.uint8)
    match_lens = np.empty(seq_cap, dtype=np.uint8)
    srcs = np.empty(seq_cap, dtype=np.int32)
    lits = np.empty(n + 64, dtype=np.uint8)
    res = lib.glz_compress(
        raw.ctypes.data_as(_U8P), n, lit_lens.ctypes.data_as(_U8P),
        match_lens.ctypes.data_as(_U8P), srcs.ctypes.data_as(_I32P), seq_cap,
        lits.ctypes.data_as(_U8P), lits.size, MAX_DEPTH, MIN_MATCH,
    )
    if res.status != 0:
        return None
    ns, nl = int(res.n_seqs), int(res.n_lits)
    if ns * 6 + nl > n * max_ratio:
        return None
    return Compressed(
        lit_lens=lit_lens[:ns].copy(), match_lens=match_lens[:ns].copy(),
        srcs=srcs[:ns].copy(), lits=lits[:nl].copy(),
        depth=max(int(res.depth), 1), out_len=n,
    )


def compress_link(
    raw: np.ndarray, max_ratio: float = MAX_RATIO, chunk: int = GLZ_CHUNK,
) -> Tuple[Optional[Compressed], Optional[str]]:
    """Chunked link compression: (stream, None) or (None, decline reason).

    The input compresses in independent ``chunk``-byte windows, so every
    match source lies inside its own chunk; sources are emitted absolute,
    so the merged stream is also a valid whole-buffer stream. One
    incompressible window sinks the whole stream (`DECLINE_RATIO`)."""
    check_chunk(chunk)
    lib = load()
    n = int(raw.size)
    if n < MIN_INPUT:
        return None, DECLINE_BELOW_MIN
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n_chunks = (n + chunk - 1) // chunk
    seq_cap = n // 4 + 64 * n_chunks
    lit_cap = n + 64 * n_chunks
    lit_lens = np.empty(seq_cap, dtype=np.uint8)
    match_lens = np.empty(seq_cap, dtype=np.uint8)
    srcs = np.empty(seq_cap, dtype=np.int32)
    lits = np.empty(lit_cap, dtype=np.uint8)
    bounds = np.zeros(n_chunks + 1, dtype=np.int32)
    n_seq = n_lit = 0
    depth = 1
    for c in range(n_chunks):
        base = c * chunk
        res = lib.glz_compress(
            raw[base:].ctypes.data_as(_U8P), min(chunk, n - base),
            lit_lens[n_seq:].ctypes.data_as(_U8P), match_lens[n_seq:].ctypes.data_as(_U8P),
            srcs[n_seq:].ctypes.data_as(_I32P), seq_cap - n_seq,
            lits[n_lit:].ctypes.data_as(_U8P), lit_cap - n_lit, MAX_DEPTH, MIN_MATCH,
        )
        if res.status != 0:
            return None, DECLINE_RATIO
        ns = int(res.n_seqs)
        srcs[n_seq : n_seq + ns] += base  # chunk-local -> absolute
        n_seq += ns
        n_lit += int(res.n_lits)
        depth = max(depth, int(res.depth), 1)
        bounds[c + 1] = n_seq
    if n_seq * 6 + n_lit > n * max_ratio:
        return None, DECLINE_RATIO
    return (
        Compressed(
            lit_lens=lit_lens[:n_seq].copy(), match_lens=match_lens[:n_seq].copy(),
            srcs=srcs[:n_seq].copy(), lits=lits[:n_lit].copy(), depth=depth, out_len=n,
            chunk_bytes=chunk, chunk_seqs=bounds,
        ),
        None,
    )


def decompress_host(comp: Compressed) -> np.ndarray:
    """The native sequential decoder (the host half of the down link and
    the tests' oracle); raises ``ValueError`` on a corrupt stream."""
    lib = load()
    out = np.empty(comp.out_len, dtype=np.uint8)
    ll = np.ascontiguousarray(comp.lit_lens, dtype=np.uint8)
    ml = np.ascontiguousarray(comp.match_lens, dtype=np.uint8)
    srcs = np.ascontiguousarray(comp.srcs, dtype=np.int32)
    lits = np.ascontiguousarray(comp.lits, dtype=np.uint8)
    rc = lib.glz_decompress(
        ll.ctypes.data_as(_U8P), ml.ctypes.data_as(_U8P), srcs.ctypes.data_as(_I32P), ll.size,
        lits.ctypes.data_as(_U8P), lits.size, out.ctypes.data_as(_U8P), out.size,
    )
    if rc != 0:
        raise ValueError(f"corrupt glz stream (rc={rc})")
    return out


def decompress_numpy(comp: Compressed) -> np.ndarray:
    """numpy mirror of the card's gather rounds (`byte_plan_device` +
    `decompress_device`), an executable spec for the tests."""
    out_len = comp.out_len
    ll = comp.lit_lens.astype(np.int64)
    ml = comp.match_lens.astype(np.int64)
    total = ll + ml
    dst_start = np.cumsum(total) - total
    lit_start = np.cumsum(ll) - ll
    marks = np.zeros(out_len, dtype=np.int64)
    valid = (dst_start < out_len) & (total > 0)
    np.add.at(marks, dst_start[valid], 1)
    seq_id = np.cumsum(marks) - 1
    idx = np.arange(out_len, dtype=np.int64)
    within = idx - dst_start[seq_id]
    in_lit = within < ll[seq_id]
    nlit = max(comp.lits.size, 1)
    lit_idx = np.clip(lit_start[seq_id] + within, 0, nlit - 1)
    lits = comp.lits if comp.lits.size else np.zeros(1, np.uint8)
    out = np.where(in_lit, lits[lit_idx], 0).astype(np.uint8)
    midx = np.where(
        in_lit, idx,
        np.clip(comp.srcs.astype(np.int64)[seq_id] + (within - ll[seq_id]), 0, out_len - 1),
    )
    for _ in range(comp.depth):
        out = out[midx]
    return out


def decode_result_host(ll, ml, srcs, lits, n_seq: int, n_lit: int, out_len: int,
                       depth: int = MAX_DEPTH) -> np.ndarray:
    """Host half of the down link: downloaded token slices (bucketed, so
    possibly zero-padded past the real counts) -> ``out_len`` raw bytes."""
    return decompress_host(Compressed(
        lit_lens=np.ascontiguousarray(ll[:n_seq], dtype=np.uint8),
        match_lens=np.ascontiguousarray(ml[:n_seq], dtype=np.uint8),
        srcs=np.ascontiguousarray(srcs[:n_seq], dtype=np.int32),
        lits=np.ascontiguousarray(lits[:n_lit], dtype=np.uint8),
        depth=max(int(depth), 1), out_len=out_len,
    ))


# ---------------------------------------------------------------------------
# Decode, on the card
# ---------------------------------------------------------------------------


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with the index clipped into range (torch would wrap a
    negative index and fault on a large one)."""
    return x[idx.clamp(0, x.shape[0] - 1).to(torch.int64)]


def byte_plan_device(lit_lens, match_lens, srcs, lits, out_len: int):
    """Per-byte decode plan: (base u8[out_len], midx i32[out_len]).

    ``base`` holds the literal bytes in place (match bytes zero), ``midx``
    each byte's gather source, with literal and pad bytes pointing at
    themselves, so ``out = out[midx]`` iterates to the decoded buffer as
    its fixpoint. Sequence arrays may be zero-padded past the real count:
    pad sequences have length 0 and are kept out of the marks."""
    dev = lit_lens.device
    ll = lit_lens.to(torch.int32)
    ml = match_lens.to(torch.int32)
    total = ll + ml
    dst_start = torch.cumsum(total, 0, dtype=torch.int32) - total
    lit_start = torch.cumsum(ll, 0, dtype=torch.int32) - ll
    # marks scatter into out_len + 1 slots; slot out_len takes the pads
    # (and anything out of range) and is cut off
    marks_at = torch.where(
        (total > 0) & (dst_start >= 0) & (dst_start < out_len), dst_start, out_len
    ).to(torch.int64)
    marks = torch.zeros((out_len + 1,), dtype=torch.int32, device=dev)
    marks.index_add_(0, marks_at, torch.ones_like(ll))
    seq_id = torch.cumsum(marks[:out_len], 0, dtype=torch.int32) - 1
    idx = torch.arange(out_len, dtype=torch.int32, device=dev)
    within = idx - _take(dst_start, seq_id)
    seq_ll = _take(ll, seq_id)
    in_lit = within < seq_ll
    lit_idx = _take(lit_start, seq_id) + within
    base = torch.where(in_lit, _take(lits, lit_idx), 0).to(torch.uint8)
    midx = torch.where(
        in_lit, idx, (_take(srcs.to(torch.int32), seq_id) + (within - seq_ll)).clamp(0, out_len - 1)
    ).to(torch.int32)
    return base, midx


def decompress_device(lit_lens, match_lens, srcs, lits, depth: int, out_len: int):
    """Whole-buffer gather-round decode, u8[out_len]: ``depth`` rounds of
    ``out = out[midx]``. The second plain decoder the tests hold the
    kernel's path against; the chain decodes with `decode_link_flat`."""
    base, midx = byte_plan_device(lit_lens, match_lens, srcs, lits, out_len)
    gather = midx.to(torch.int64)
    out = base
    for _ in range(int(depth)):
        out = out[gather]
    return out


def decode_plain(lit_lens, match_lens, srcs, lits, out_len: int, chunk: int) -> torch.Tensor:
    """Plain version of the fused token-to-byte decode
    (``csrc/glz_decode.cu``'s ``fluvio_glz_decode``): the per-byte plan
    (`byte_plan_device`), then ``kernels.glz_resolve``. Needs no depth:
    the resolve's 8 steps cover every chain a stream may hold."""
    base, midx = byte_plan_device(lit_lens, match_lens, srcs, lits, out_len)
    return kernels.glz_resolve(base, midx, chunk)


def decode_link_flat(glz_seqs, glz_lits, out_len: int, chunk: int,
                     depth: int = MAX_DEPTH) -> torch.Tensor:
    """The up link's card half: token arrays (``glz_seqs`` = lit_lens u8,
    match_lens u8, srcs i32) of a `compress_link` stream and its depth ->
    u8[out_len], through the fused ``glz_decode`` kernel."""
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    lit_lens, match_lens, srcs = glz_seqs
    return cuda_kernels.glz_decode(lit_lens, match_lens, srcs, glz_lits, out_len, chunk, depth)


def decompress_rounds_numpy(comp: Compressed, order_seed: int) -> np.ndarray:
    """numpy mirror of the ``glz_decode`` kernel, an executable spec for
    the tests: sequence offsets by exclusive cumsums, the literal pass,
    then ``comp.depth`` in-place rounds in which every sequence copies its
    match bytes in order (sources clipped into [0, out_len - 1], then
    into the byte's chunk; a byte sourcing itself reads 0), the sequences
    taken in an order shuffled anew each round from ``order_seed``: the
    card's threads run in no order, and on a `compress_link` stream every
    order gives the same bytes. ``comp.chunk_bytes`` 0 means one chunk."""
    out_len = comp.out_len
    chunk = comp.chunk_bytes or max(out_len, 1)
    ll = comp.lit_lens.astype(np.int64)
    ml = comp.match_lens.astype(np.int64)
    srcs = comp.srcs.astype(np.int64)
    lits = comp.lits
    dst = np.cumsum(ll + ml) - (ll + ml)
    lit0 = np.cumsum(ll) - ll
    out = np.zeros(out_len, np.uint8)  # the kernel's match bytes start unset
    for k in range(len(ll)):
        n = int(min(ll[k], max(out_len - dst[k], 0)))
        idx = np.clip(lit0[k] + np.arange(n), 0, max(lits.size - 1, 0))
        out[dst[k]: dst[k] + n] = lits[idx] if lits.size else 0
    rng = np.random.default_rng(order_seed)
    for _ in range(comp.depth):
        for k in rng.permutation(len(ll)):
            i = dst[k] + ll[k] + np.arange(ml[k])
            i = i[i < out_len]
            lo = i // chunk * chunk
            q = np.clip(np.clip(srcs[k] + np.arange(i.size), 0, out_len - 1), lo, lo + chunk - 1)
            if not i.size:
                continue
            if not ((q >= i[0]) & (q <= i[-1])).any():
                out[i] = out[q]  # no source inside the run: one copy is the byte loop
                continue
            for a, b in zip(i.tolist(), q.tolist()):
                out[a] = 0 if a == b else out[b]
    return out


# ---------------------------------------------------------------------------
# Encode, on the card
# ---------------------------------------------------------------------------


def _roll1(x: torch.Tensor, fill=0) -> torch.Tensor:
    """``x`` shifted one place later, ``fill`` in front."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def enc_group_words(raw: torch.Tensor):
    """(w0, w1) int32 words of each aligned 8-byte group of ``raw`` (u8,
    contiguous, length % 8 == 0; little-endian like the JAX bitcast).
    Group equality == both words equal."""
    w = raw.contiguous().view(torch.int32).reshape(-1, 2)
    return w[:, 0].contiguous(), w[:, 1].contiguous()


def enc_const_runs(w0, w1, chunk_groups: int):
    """Constant runs (a group equal to the one before it, broken at chunk
    starts) and their closed-form sources: (const_m bool[G], csrc i32[G]).
    Doubling pieces up to 32 groups, then 31-group pieces replaying the
    run head keep every chain at depth <= 5 from the head."""
    gidx = torch.arange(w0.shape[0], dtype=torch.int32, device=w0.device)
    eq_prev = (w0 == _roll1(w0)) & (w1 == _roll1(w1)) & (gidx % chunk_groups != 0)
    run_start = _cummax(torch.where(~eq_prev, gidx, -1))
    k = gidx - run_start
    hp = torch.ones_like(k)
    for b in (2, 4, 8, 16):
        hp = torch.where(k >= b, b, hp)
    csrc = torch.where(k < 32, run_start + (k - hp), run_start + ((k - 32) % 31))
    return eq_prev, csrc.to(torch.int32)


def enc_sequences(raw, is_match, src_g, chunk: int):
    """Group match plan -> token arrays: (lit_lens u8[G], match_lens u8[G],
    srcs i32[G], lits u8[G*8], n_seq, n_lit). The arrays have G capacity;
    the 0-dim ``n_seq`` / ``n_lit`` say how much of them is real."""
    dev = raw.device
    g_count = is_match.shape[0]
    chunk_groups = chunk // ENC_GROUP
    gidx = torch.arange(g_count, dtype=torch.int32, device=dev)
    at_cb = (gidx % chunk_groups) == 0
    prev_m = _roll1(is_match, False)
    prev_src = _roll1(src_g)
    ext_run = is_match & prev_m & (src_g == prev_src + 1) & ~at_cb
    run_change = at_cb | (is_match != prev_m) | (is_match & ~ext_run)
    runpos = gidx - _cummax(torch.where(run_change, gidx, -1))
    cap_break = (runpos > 0) & (runpos % ENC_MAX_RUN == 0)
    piece_change = run_change | cap_break
    # a match piece right after a literal group joins that literal
    # piece's sequence (lits-then-match); every other piece starts one
    seg_start = piece_change & ~(is_match & ~prev_m & ~at_cb)
    seg_id = torch.cumsum(seg_start.to(torch.int32), 0, dtype=torch.int32) - 1
    n_seq = seg_id[-1] + 1
    litg = ~is_match
    seg64 = seg_id.to(torch.int64)
    lit_cnt = torch.zeros((g_count,), dtype=torch.int32, device=dev)
    lit_cnt.index_add_(0, seg64, litg.to(torch.int32))
    mat_cnt = torch.zeros((g_count,), dtype=torch.int32, device=dev)
    mat_cnt.index_add_(0, seg64, is_match.to(torch.int32))
    lit_lens = (lit_cnt * ENC_GROUP).to(torch.uint8)
    match_lens = (mat_cnt * ENC_GROUP).to(torch.uint8)
    first_m = is_match & (~prev_m | seg_start)
    # each segment has at most one first match group; the rest aim at the
    # spare slot g_count, which is cut off
    srcs = torch.zeros((g_count + 1,), dtype=torch.int32, device=dev)
    srcs[torch.where(first_m, seg_id, g_count).to(torch.int64)] = src_g * ENC_GROUP
    lit_i = litg.to(torch.int32)
    lit_pos = torch.cumsum(lit_i, 0, dtype=torch.int32) - lit_i
    n_lit = lit_i.sum(dtype=torch.int32) * ENC_GROUP
    dst = (torch.where(litg, lit_pos, g_count).to(torch.int64)[:, None] * ENC_GROUP
           + torch.arange(ENC_GROUP, dtype=torch.int64, device=dev)[None, :]).reshape(-1)
    lits = torch.zeros((g_count * ENC_GROUP + ENC_GROUP,), dtype=torch.uint8, device=dev)
    lits[dst] = raw
    return (lit_lens, match_lens, srcs[:g_count], lits[: g_count * ENC_GROUP],
            n_seq, n_lit)


def encode_result(raw: torch.Tensor, chunk: int):
    """The down link's card half: u8 stream (length % 8 == 0) -> (lit_lens,
    match_lens, srcs, lits, n_seq, n_lit, depth), through the constant
    runs and the ``glz_enc_match`` kernel. A stream within one chunk
    clamps the window to its own 128-group-rounded size, as the JAX
    package does, which also sets the kernel's squaring rounds."""
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    g_count = raw.shape[0] // ENC_GROUP
    if g_count <= chunk // ENC_GROUP:
        chunk = max(128, ((g_count + 127) // 128) * 128) * ENC_GROUP
    chunk_groups = chunk // ENC_GROUP
    w0, w1 = enc_group_words(raw)
    const_m, csrc = enc_const_runs(w0, w1, chunk_groups)
    root = cuda_kernels.glz_encode_match(w0, w1, const_m, chunk_groups)
    gidx = torch.arange(g_count, dtype=torch.int32, device=raw.device)
    wm = (root != gidx) & ~const_m
    is_match = const_m | wm
    src_g = torch.where(const_m, csrc, torch.where(wm, root, gidx))
    # constant runs chain up to MAX_DEPTH; window matches are depth 1
    depth = const_m.any().to(torch.int32) * (MAX_DEPTH - 1) + 1
    ll, ml, srcs, lits, n_seq, n_lit = enc_sequences(raw, is_match, src_g, chunk)
    return ll, ml, srcs, lits, n_seq, n_lit, depth
