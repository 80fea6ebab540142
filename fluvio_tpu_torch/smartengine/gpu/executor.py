"""Fused GPU chain executor — the narrow ragged path.

The port's counterpart of ``fluvio_tpu/smartengine/tpu/executor.py``
(`TpuChainExecutor`) for filter, map, filter_map, array_map and aggregate
chains over records that fit the narrow layout (one row per record):

1. the host stages a batch's values as 4-aligned ragged bytes (i32 words)
   plus the columns the card cannot derive (`_stage_flat`,
   `stage_link_columns`);
2. on the card, `ragged_repad_words` re-pads the values and
   `derived_meta_columns` synthesizes the rest;
3. the stages update a lazy validity mask (filters) and rewrite the value
   column (maps) — span maps only track (start, length) views, and the
   span bytes are materialized only if a later stage reads them; an
   array_map stage explodes each record into ``fanout_cap`` output rows
   (views of its source record, `_ArrayMapStage`), and an aggregate stage
   runs a segmented scan seeded by its carry, which stays on the card
   from batch to batch (`_AggregateStage`, `_device_carries`);
4. results compact on the card: filter-only chains ship a 1-bit survivor
   mask, view chains (start, length) descriptors, byte-mode chains (an
   aggregate's decimals are rendered on the card) one packed 4-aligned
   payload of the compacted values (`kernels.packed_payload`) with its
   byte count in the header, u8 or int32 lengths and the keys; explode
   chains ship each output row's source row in place of the mask; the
   header and mask copies start at dispatch and land in pinned host
   memory;
5. the host rebuilds the output buffer (`_materialize_view_flat`, or
   `_fetch_bytes`, which adopts the payload flat-backed; `_assemble`). An
   explode whose rows overflow the capacity runs again at the exact
   (bucketed) count from the batch's own carries, and the learned
   capacity grows.

Exact first error (the reference chain's: it stops after the failing
instance and returns that instance's partial output). A JSON-array
explode masks the first record that is no JSON array and every later one,
and the header carries that row and the explode's stage index k. The
finish then runs stages 0..k again on the card from the batch's starting
carries (`_first_error`, over the inputs the batch staged): the explode's
elements before the failing row are the chain's output, the stages
before k keep the carries they advanced over the whole batch, and stages
k and after keep the starting ones. The output buffer's ``error`` is the
`SmartModuleTransformRuntimeError` at that record, its key and value as
stage k saw them (one row copied from the card when an earlier stage
rewrote them).

Batches wider than the narrow layout (`StripeParams.threshold`) take the
striped path (`_dispatch_striped`, the reference's `_chain_fn_striped`):
the same ragged upload re-padded into stripe rows (`gpu/stripes.py`),
segment-level verdicts, aggregates over the segment state, and the
segment survivor mask, (start, length) descriptors, an aggregate's
byte-mode payload or a split explode's element descriptors down, rebuilt
by the same host code.

The glz link (`gpu/glz.py`), on only when a `LinkParams` asks for it:
the up link ships the flat as glz tokens, compressed on the host (a
worker thread compresses batch k+1 ahead in `process_stream`) and decoded
on the card before the re-pad; the down link encodes the (start, length)
descriptors of view chains, or the byte-mode payload, on the card and
downloads the tokens when they are smaller than the raw download.
`link_counts` counts which form each batch took, the declines by reason
and the bytes each way.

Telemetry (`fluvio_tpu_torch.telemetry`, the reference's seams): each
dispatched batch opens a `BatchSpan` (path ``fused`` or ``striped``,
chain ``span_chain`` or the chain signature) whose phases are ``stage``
(the host's ragged flat and link columns), ``glz_compress`` or ``h2d``
(the uploads), ``dispatch`` (the chain's torch calls), ``device`` (end of
dispatch to the return of the batch's result event, the first wait the
finish makes anyway: telemetry adds no synchronisation), ``d2h`` (the
synchronous downloads after it) and ``fetch`` (the host rebuild, on the
fetch worker when deferred, net of the wait and the downloads); the span
ends when the rebuild does. A batch's handle holds the tensors it
uploaded until its finish or discard (`_Fetch.staged`), and the ledger
books their bytes (owners ``staged_batch`` and ``glz_tokens``) with the
``live_batch_handles`` gauge over the same span;
link forms, declines and stripe fallbacks count on the registry's
families (a partitioned batch's again under its partition tag).

What the port does not cover raises :class:`GpuSpill` instead of running
anywhere else: wide batches of a chain with no striped lowering (a
JSON-array explode, a word count, a JsonGet contribution, a key rewrite
among them; ``record-too-wide-unstripeable``), and an explode that
overflows its capacity again after its retry (``fanout-overflow``).
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.smartengine.config import SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import glz, kernels, stripes
from fluvio_tpu_torch.smartengine.gpu.buffer import (
    MAX_RECORD_WIDTH,
    RecordBuffer,
    apply_postops_host,
    ragged_range_select,
)
from fluvio_tpu_torch.smartengine.gpu.lower import (
    Unlowerable,
    apply_postops,
    infer_type,
    lower_expr,
    lower_span,
    materialize_span,
)
from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import (
    SmartModuleInput,
    SmartModuleKind,
    SmartModuleOutput,
    SmartModuleTransformRuntimeError,
)
from fluvio_tpu_torch.telemetry import TELEMETRY


# canned aggregate kinds -> their combine monoid
_AGG_OP = {
    "sum_int": "add",
    "count": "add",
    "word_count": "add",
    "max_int": "max",
    "min_int": "min",
}
_AGG_NEUTRAL = {op: neutral for op, (neutral, _) in kernels._AGG_OPS.items()}


class GpuSpill(Exception):
    """The chain or batch is outside what the GPU port runs (the
    counterpart of the reference's ``TpuSpill``). ``reason`` is a short
    stable key. The port reruns nothing elsewhere: the caller decides."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class _FanoutOverflow(Exception):
    def __init__(self, total: int):
        super().__init__(f"fanout total {total} exceeded capacity")
        self.total = total


class _Deferred:
    """A column computed only when a later stage or the output reads it."""

    def __init__(self, fn: Callable[[], torch.Tensor]):
        self.fn = fn


def _deferred_pair(fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]]):
    """Two deferred columns from one call of ``fn``, made at most once
    (a rendering's values and lengths)."""
    made: List = []

    def part(i: int) -> torch.Tensor:
        if not made:
            made.append(fn())
        return made[0][i]

    return _Deferred(lambda: part(0)), _Deferred(lambda: part(1).to(torch.int32))


class _State(dict):
    """Chain state whose deferred columns resolve (once) on first read."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, _Deferred):
            value = value.fn()
            self[key] = value
        return value

    def copy(self) -> "_State":
        return _State(self)


@dataclass(frozen=True)
class _Carry:
    """One aggregate's running state on the card, 0-d tensors: the
    accumulator (i64), the window it belongs to (i64) and whether any
    record has reached it (bool)."""

    acc: torch.Tensor
    win: torch.Tensor
    has: torch.Tensor


Carries = Tuple[_Carry, ...]


@dataclass
class _FilterStage:
    predicate: Callable

    def apply(self, state: _State, carries: Carries, base_ts: int, ctx: Dict):
        state = state.copy()
        state["valid"] = state["valid"] & self.predicate(state)
        return state, carries


@dataclass
class _MapStage:
    value_fn: Optional[Callable]
    key_fn: Optional[Callable]
    predicate: Optional[Callable] = None  # filter_map when set
    span_fn: Optional[Callable] = None  # value is a view of current values
    span_postops: Tuple[str, ...] = ()  # static byte-wise folds on the view

    def apply(self, state: _State, carries: Carries, base_ts: int, ctx: Dict):
        new_state = state.copy()
        if self.predicate is not None:
            new_state["valid"] = state["valid"] & self.predicate(state)
        if self.span_fn is not None:
            # view-preserving rewrite: track provenance into the original
            # record bytes; the bytes themselves are deferred, so the
            # extract kernel runs only if something reads them
            st, ln = self.span_fn(state)
            ln = ln.to(torch.int32)
            new_state["view_start"] = state["view_start"] + st
            postops = self.span_postops
            new_state["values"] = _Deferred(
                lambda: apply_postops(materialize_span(state["values"], st, ln), postops)
            )
            new_state["lengths"] = ln
        else:
            v, l = self.value_fn(state)
            new_state["values"], new_state["lengths"] = v, l.to(torch.int32)
        if self.key_fn is not None:
            kv, kl = self.key_fn(state)
            new_state["keys"], new_state["key_lengths"] = kv, kl.to(torch.int32)
        return new_state, carries


@dataclass
class _ArrayMapStage:
    """Fan-out explode (transform kind array_map). Every output element is
    a substring of its source record, so the stage places (source row,
    start, length) descriptors in ``ctx["fanout_cap"]`` rows; the view
    start and source row compose through it. The element bytes, keys and
    key lengths are deferred: nothing gathers a ``[cap, W]`` matrix (or
    runs the extract kernel over it) unless a later stage or the output
    reads it. Offset and timestamp deltas are fresh: the host gives every
    output row its source record's key and its batch's fresh deltas
    (`RecordBuffer.fresh_offset_deltas`, zeros for one batch)."""

    mode: str  # "json_array" | "split"
    sep: bytes

    def apply(self, state: _State, carries: Carries, base_ts: int, ctx: Dict):
        cap = ctx["fanout_cap"]
        values, lengths, valid = state["values"], state["lengths"], state["valid"]
        n = lengths.shape[0]
        if self.mode == "json_array":
            flag, sg, lg, ff, fs, fl, err = kernels.json_array_bounds(values, lengths)
        else:
            flag, sg, lg, ff, fs, fl, err = kernels.split_bounds(values, lengths, self.sep)
        err_v = err & valid
        # first-error masking: the failing record and every later one
        # contribute nothing, so the elements before it are the explode's
        # exact output (the finish re-dispatches the stages up to this one)
        ridx = torch.arange(n, dtype=torch.int32, device=valid.device)
        first_err = torch.where(err_v, ridx, n).min()
        total, local_row, rel_start, elen = kernels.fanout_scatter(
            flag, sg, lg, ff, fs, fl, valid & (ridx < first_err), cap
        )
        del flag, sg, lg  # the [N, W] grids die here
        lr = local_row.clamp(0, n - 1).to(torch.int64)
        keys, key_lengths = state["keys"], state["key_lengths"]
        new_state = _State()
        new_state["valid"] = (torch.arange(cap, dtype=torch.int32, device=valid.device)
                              < total.clamp(max=cap))
        new_state["view_start"] = state["view_start"][lr] + rel_start
        new_state["src_row"] = state["src_row"][lr]
        new_state["lengths"] = elen
        new_state["values"] = _Deferred(lambda: materialize_span(values[lr], rel_start, elen))
        new_state["keys"] = _Deferred(lambda: keys[lr])
        new_state["key_lengths"] = _Deferred(lambda: key_lengths[lr])
        new_state["offset_deltas"] = torch.zeros(
            (cap,), dtype=state["offset_deltas"].dtype, device=valid.device)
        new_state["timestamp_deltas"] = torch.zeros(
            (cap,), dtype=state["timestamp_deltas"].dtype, device=valid.device)
        new_state["fan_total"] = total
        # the header's error columns: the failing row + 1 (0: none) and
        # this stage's index
        new_state["fan_err"] = torch.where(first_err < n, first_err + 1, 0)
        new_state["fan_err_stage"] = torch.full((), ctx["stage"], dtype=torch.int64,
                                                device=valid.device)
        return new_state, carries


def _canned_contribution(kind: str) -> Callable:
    """The classic reductions as contribution functions: prebuilt
    instances of the general (contribution, combine monoid) form."""
    if kind in ("sum_int", "max_int", "min_int"):
        return lambda s: kernels.parse_int(s["values"], s["lengths"])
    if kind == "count":
        return lambda s: torch.ones(s["lengths"].shape[0], dtype=torch.int64,
                                    device=s["lengths"].device)
    if kind == "word_count":
        return lambda s: kernels.count_words(s["values"], s["lengths"])
    raise Unlowerable(f"aggregate kind {kind}")


@dataclass
class _AggregateStage:
    """Running aggregate (transform kind aggregate): each record's output
    value is the accumulator after it, in decimal. With ``window_ms`` the
    accumulator restarts at every tumbling window and each output's key
    is its window's start.

    The carry enters as a virtual row 0 ahead of the batch, so a
    segmented scan over ``[carry] + records`` continues it; a record
    starts a new segment where no earlier row was valid or its window
    differs from the last valid row's. The decimal rendering (and the
    window keys') is deferred until a later stage or the fetch reads it."""

    op: str  # combine monoid: "add" | "max" | "min"
    window_ms: Optional[int]
    index: int  # carry slot
    contribution_fn: Callable  # state -> i64[N] per-record contribution

    def apply(self, state: _State, carries: Carries, base_ts: int, ctx: Dict):
        carry = carries[self.index]
        valid = state["valid"]
        neutral = _AGG_NEUTRAL[self.op]
        xm = torch.where(valid, self.contribution_fn(state).to(torch.int64), neutral)
        n = xm.shape[0]
        dev = xm.device
        if self.window_ms:
            if base_ts < 0:
                ts = torch.zeros((n,), dtype=torch.int64, device=dev)
            else:
                ts = (base_ts + state["timestamp_deltas"].to(torch.int64)).clamp(min=0)
            w = ts - ts % self.window_ms
        else:
            w = torch.zeros((n,), dtype=torch.int64, device=dev)

        x_all = torch.cat([torch.where(carry.has, carry.acc, neutral)[None], xm])
        w_all = torch.cat([carry.win[None], w])
        valid_all = torch.cat([carry.has[None], valid])
        prevw_incl, prevhas_incl = kernels.propagate_last_valid(w_all, valid_all)
        prevw = torch.cat([prevw_incl.new_zeros(1), prevw_incl[:-1]])
        prevhas = torch.cat([prevhas_incl.new_zeros(1), prevhas_incl[:-1]])
        reset_all = valid_all & (~prevhas | (w_all != prevw))
        scan = kernels.segmented_scan(x_all, reset_all, self.op)
        out_vals = scan[1:]

        new_carry = _Carry(
            acc=kernels.last_true_value(valid_all, scan, carry.acc),
            win=kernels.last_true_value(valid_all, w_all, carry.win),
            has=carry.has | valid.any(),
        )
        new_state = state.copy()
        new_state["values"], new_state["lengths"] = _deferred_pair(
            lambda: kernels.int_to_ascii(out_vals))
        if self.window_ms:
            new_state["keys"], new_state["key_lengths"] = _deferred_pair(
                lambda: kernels.int_to_ascii(w))
        new_carries = list(carries)
        new_carries[self.index] = new_carry
        return new_state, tuple(new_carries)


def ragged_repad_words(flat: torch.Tensor, lengths: torch.Tensor, width: int):
    """Re-pad a 4-aligned ragged upload on the card: one gather of i32
    words rebuilds the padded value matrix. Returns (values u8[n, width],
    lengths i32[n])."""
    lengths = lengths.to(torch.int32)
    n = lengths.shape[0]
    lengths4 = (lengths + 3) & ~3
    # int64 accumulation; `check_flat_addressing` bounds the total anyway
    word_starts = (torch.cumsum(lengths4.to(torch.int64), 0) - lengths4) >> 2
    wwidth = width // 4
    jw = torch.arange(wwidth, dtype=torch.int64, device=flat.device)[None, :]
    widx = (word_starts[:, None] + jw).clamp(0, flat.shape[0] - 1)
    words = flat[widx]
    # unpack little-endian bytes from the words: byte k = (w >> 8k) & 0xFF
    shifts = torch.arange(4, dtype=torch.int32, device=flat.device) * 8
    gathered = ((words[:, :, None] >> shifts) & 0xFF).reshape(n, width)
    keep = torch.arange(width, dtype=torch.int32, device=flat.device)[None, :] < lengths[:, None]
    return torch.where(keep, gathered, 0).to(torch.uint8), lengths


def derived_meta_columns(
    n: int, kwidth: int, has_keys: bool, keys, key_lengths,
    has_offsets: bool, offset_deltas, ts_mode: str, timestamp_deltas, device,
):
    """Synthesize on the card the columns `stage_link_columns` kept off the
    link. Returns (keys, key_lengths, offset_deltas, timestamp_deltas)."""
    if not has_keys:
        keys = torch.zeros((n, kwidth), dtype=torch.uint8, device=device)
        key_lengths = torch.full((n,), -1, dtype=torch.int32, device=device)
    else:
        key_lengths = key_lengths.to(torch.int32)
    if not has_offsets:
        offset_deltas = torch.arange(n, dtype=torch.int32, device=device)
    if ts_mode == "zero":
        timestamp_deltas = torch.zeros((n,), dtype=torch.int64, device=device)
    else:
        timestamp_deltas = timestamp_deltas.to(torch.int64)
    return keys, key_lengths, offset_deltas, timestamp_deltas


def stage_link_columns(buf: RecordBuffer):
    """Host-side link policy: which columns cross to the card, at which
    dtypes. Derivable columns report as absent (arange offsets, zero
    timestamps); timestamps ride i32 when every delta fits, else i64, and
    lengths ride u8 when the width allows. (The reference's u16 tiers are
    left out: torch's uint16 supports too few operations to widen on the
    card everywhere.)

    Returns (lengths_up, has_keys, has_offsets, ts_mode, ts_up)."""
    has_keys = buf.has_keys()
    off = buf.offset_deltas[: buf.count]
    has_offsets = not np.array_equal(off, np.arange(buf.count, dtype=off.dtype))
    live_ts = buf.timestamp_deltas[: buf.count]
    if buf.count == 0 or not live_ts.any():
        ts_mode, ts_up = "zero", None
    elif np.abs(live_ts).max() < 2**31:
        ts_mode, ts_up = "i32", buf.timestamp_deltas.astype(np.int32)
    else:
        ts_mode, ts_up = "i64", buf.timestamp_deltas
    if buf.width < (1 << 8):
        lengths_up = buf.lengths.astype(np.uint8)
    else:
        lengths_up = buf.lengths.astype(np.int32)
    return lengths_up, has_keys, has_offsets, ts_mode, ts_up


def _narrow_dtype(bound: int) -> torch.dtype:
    """Smallest integer dtype that holds 0..bound (descriptor downloads)."""
    if bound < (1 << 8):
        return torch.uint8
    if bound < (1 << 15):
        return torch.int16
    return torch.int32


class _Fetch:
    """Device -> host copies started at dispatch: pinned host tensors plus
    the event that marks them complete (None on the CPU)."""

    def __init__(self, device: torch.device, prev_carries: Carries = (), cap: int = 0):
        self.cuda = device.type == "cuda"
        self.host: Dict[str, torch.Tensor] = {}
        self._host: Optional[Dict[str, np.ndarray]] = None
        self.event = None
        # the aggregate carries the batch started from (restored when its
        # fetch fails or its explode re-dispatches) and its explode capacity
        self.prev_carries = prev_carries
        self.cap = cap
        # survivors are whole input records: the mask is the whole download
        self.whole_records = False
        # byte mode: the packed payload, the narrowed lengths and the
        # compacted keys, left on the card until the header says how much
        # of them to download; the payload's byte count rides the header
        # at `payload_at`
        self.byte_cols: Optional[Tuple[torch.Tensor, ...]] = None
        self.payload_at = 0
        # explode chains: the compacted source-row column and its deltas
        # (the header's probe picks the download), and the staged inputs,
        # which an overflow re-runs at a larger capacity: the narrow
        # path's arrays, or a striped batch's (ctx, segment survivors)
        self.src_col: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.arrays: Optional[Dict[str, torch.Tensor]] = None
        self.striped: Optional[Tuple[dict, torch.Tensor]] = None
        # down link: the glz tokens of the result stream (descriptors or
        # payload), left on the card until "down_meta" says whether they
        # beat the raw download; a view chain's raw descriptor columns wait
        # beside them in `desc`
        self.down: Optional[Tuple[torch.Tensor, ...]] = None
        self.desc: Optional[Tuple] = None
        # the batch's uploads, held until its finish or discard; its span
        # (None with capture off) and whether the device-memory ledger
        # books the uploads
        self.staged: List[torch.Tensor] = []
        self.span = None
        self.booked = False
        # a first-error re-dispatch: how its stage run ships (None: the
        # chain's), the failing row and its stage; the error the finish
        # resolved, for the caller that settles the batch
        self.ship = None
        self.err_row: Optional[int] = None
        self.err_stage: Optional[int] = None
        self.error = None

    def start(self, name: str, t: torch.Tensor) -> None:
        if self.cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self.host[name] = h
        else:
            self.host[name] = t

    def seal(self) -> None:
        if self.cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> Dict[str, np.ndarray]:
        """The batch's first blocking wait: the device phase of its span
        ends when the copies' event returns. Later calls return the same
        host arrays."""
        if self._host is not None:
            return self._host
        if self.event is not None:
            self.event.synchronize()
        span = self.span
        if span is not None:
            span.mark_device_ready()
            t = time.perf_counter()
        host = self._host = {k: v.numpy() for k, v in self.host.items()}
        if span is not None:
            span.lap("d2h", t)
        return host


def _bucket_rows(n: int, floor: int = 8) -> int:
    """pow2/8-granular row bucket (the reference's `_bucket_bytes`)."""
    v = floor
    while v < n:
        v <<= 1
    step = max(floor, v >> 3)
    return ((n + step - 1) // step) * step


def _pad_slice(n: int, floor: int = 8) -> int:
    v = floor
    while v < n:
        v <<= 1
    return v


def pad_glz_tokens(comp: glz.Compressed):
    """A stream's token arrays zero-padded to pow2/8 buckets (floor 256),
    as the JAX executor stages them; pad sequences have length 0 and drop
    out of the decode. Returns (lit_lens, match_lens, srcs, lits)."""
    n_seq = len(comp.lit_lens)
    seq_pad = _bucket_rows(max(n_seq, 8), floor=256)
    lit_pad = _bucket_rows(max(comp.lits.size, 8), floor=256)
    ll = np.zeros(seq_pad, np.uint8)
    ll[:n_seq] = comp.lit_lens
    ml = np.zeros(seq_pad, np.uint8)
    ml[:n_seq] = comp.match_lens
    srcs = np.zeros(seq_pad, np.int32)
    srcs[:n_seq] = comp.srcs
    lits = np.zeros(lit_pad, np.uint8)
    lits[: comp.lits.size] = comp.lits
    return ll, ml, srcs, lits


def _itm(bound: int) -> int:
    """Byte width of a descriptor field whose values are <= ``bound``."""
    if bound <= (1 << 8):
        return 1
    if bound <= (1 << 16):
        return 2
    return 4


def desc_fields(width: int) -> Tuple[int, int]:
    """Little-endian byte widths of one interleaved (start, length)
    descriptor record for records of ``width`` bytes (the JAX executor's
    `_desc_fields`). Interleaving keeps each survivor's record contiguous,
    so corpus periodicity shows up as group periodicity for the encoder."""
    return _itm(width), _itm(width + 1)


def desc_stream(st: torch.Tensor, ln: torch.Tensor, width: int) -> torch.Tensor:
    """Interleave compacted (start, length) columns into one little-endian
    byte stream, zero-padded to a multiple of 8 for the encoder's groups
    (`desc_split` is its host inverse)."""
    f_st, f_ln = desc_fields(width)
    cols = []
    for col, f in ((st.to(torch.int32), f_st), (ln.to(torch.int32), f_ln)):
        for b in range(f):
            cols.append((col >> (8 * b)) & 0xFF)
    desc = torch.stack(cols, dim=1).to(torch.uint8).reshape(-1)
    pad = (-desc.shape[0]) % 8
    if pad:
        desc = torch.cat([desc, desc.new_zeros(pad)])
    return desc


def desc_split(desc: np.ndarray, count: int, width: int):
    """Host inverse of `desc_stream` over the decoded bytes: (start i64,
    length i32) columns of ``count`` survivors."""
    f_st, f_ln = desc_fields(width)
    stride = f_st + f_ln
    rec = np.ascontiguousarray(desc[: count * stride]).reshape(count, stride).astype(np.int64)
    st = rec[:, 0:f_st] @ (1 << (8 * np.arange(f_st, dtype=np.int64)))
    ln = rec[:, f_st:stride] @ (1 << (8 * np.arange(f_ln, dtype=np.int64)))
    return st, ln.astype(np.int32)


# header columns: survivor count, longest value, longest key, the explode's
# failing row + 1 (0: none), explode total, the failing stage's index; the
# delta probes of `_delta_probe` follow
_HEADER = 6


def _delta_probe(col: torch.Tensor, count: torch.Tensor):
    """A compacted int column's deltas for a narrow download: (deltas,
    [min delta, max delta, first value]). ``d[0]`` is 0 and the rows past
    ``count`` are 0, so ``col[i] = col[0] + cumsum(d)[i]`` (int64,
    wrapping) for the live rows. The probe rides the header: its three
    scalars say, per batch, whether every delta fits a byte
    (`_download_src`)."""
    n = col.shape[0]
    d = col - torch.cat([col[:1], col[:-1]])
    d = torch.where(torch.arange(n, device=col.device) < count, d, 0)
    d[0] = 0
    return d, [d.min(), d.max(), col[0]]


def _link_counts() -> Dict[str, int]:
    return {
        "raw": 0, "glz": 0, "down-glz": 0, "down-packed": 0,
        glz.DECLINE_BELOW_MIN: 0, glz.DECLINE_RATIO: 0, glz.DECLINE_ENC_RATIO: 0,
        "h2d_bytes": 0, "d2h_bytes": 0,
    }


_FETCH_POOL: Optional[ThreadPoolExecutor] = None
_FETCH_POOL_LOCK = threading.Lock()


def fetch_mat_pool() -> ThreadPoolExecutor:
    """The process-wide single-worker pool of the deferred finish: batch
    k's `_materialize_view_flat` thunk runs here while the calling thread
    dispatches batch k+1 and waits for its downloads. One worker keeps
    completion in dispatch order; every executor shares it."""
    global _FETCH_POOL
    with _FETCH_POOL_LOCK:
        if _FETCH_POOL is None:
            _FETCH_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fetch-mat")
        return _FETCH_POOL


def _view_keys(buf: RecordBuffer, count: int, rows: int, src):
    """Survivor key columns for view-mode outputs."""
    if buf.has_keys():
        out_keys = np.zeros((rows, buf.keys.shape[1]), dtype=np.uint8)
        out_klens = np.full((rows,), -1, dtype=np.int32)
        out_keys[:count] = buf.keys[src]
        out_klens[:count] = buf.key_lengths[src]
    else:
        out_keys = np.zeros((rows, 1), dtype=np.uint8)
        out_klens = np.full((rows,), -1, dtype=np.int32)
    return out_keys, out_klens


def _materialize_view_flat(
    buf: RecordBuffer, count: int, rows: int, vw: int,
    st: np.ndarray, ln: np.ndarray, src: np.ndarray, postops, fanout: bool,
) -> RecordBuffer:
    """Flat-backed view materialization: gather every survivor's bytes
    straight into the 4-aligned ragged form — O(sum of lengths), no
    padded matrix.

    Fast path: survivor ranges in the input flat are ascending and
    disjoint for every real view (whole records, JsonGet spans), so one
    boolean range-select extracts the payload. Alignment-overrun or
    overlapping spans fall back to the exact gather."""
    ln64 = ln.astype(np.int64)
    l4 = (ln64 + 3) & ~3
    starts64 = np.cumsum(l4) - l4
    total = int(l4.sum()) if count else 0
    flat_out = np.zeros((total,), dtype=np.uint8)
    if count and total:
        in_flat, in_starts = buf.ragged_values()
        if len(in_flat):
            base = in_starts.astype(np.int64)[src] + st
            fast = (
                base[0] >= 0
                and base[-1] + l4[-1] <= len(in_flat)
                and bool((base[1:] >= base[:-1] + l4[:-1]).all())
            )
            if fast:
                flat_out = ragged_range_select(in_flat, base, l4)
                # zero the alignment-pad tail bytes (<= 3 per record)
                pad = l4 - ln64
                if pad.any():
                    npad = int(pad.sum())
                    padbase = np.repeat(starts64 + ln64, pad)
                    within = np.arange(npad, dtype=np.int64) - np.repeat(
                        np.cumsum(pad) - pad, pad
                    )
                    flat_out[padbase + within] = 0
            else:
                pos = np.arange(total, dtype=np.int64) - np.repeat(starts64, l4)
                idx = np.clip(np.repeat(base, l4) + pos, 0, len(in_flat) - 1)
                keep = pos < np.repeat(ln64, l4)
                flat_out = np.where(keep, in_flat[idx], 0).astype(np.uint8)
        flat_out = apply_postops_host(flat_out, postops)
    out_lengths = np.zeros((rows,), dtype=np.int32)
    out_lengths[:count] = ln64
    starts = np.zeros((rows,), dtype=np.int32)
    starts[:count] = starts64
    starts[count:] = total
    out_keys, out_klens = _view_keys(buf, count, rows, src)
    return _assemble(buf, count, rows, out_lengths, out_keys, out_klens, src,
                     flat_out, starts, vw, fanout)


def _assemble(buf, count, rows, out_lengths, out_keys, out_klens, src,
              flat: np.ndarray, starts: np.ndarray, vw: int, fanout: bool) -> RecordBuffer:
    """The flat-backed output buffer (``flat``/``starts`` the 4-aligned
    ragged values): offset/timestamp columns rebuilt from survivor
    source rows, the source's deltas where stages keep row identity;
    explode outputs are fresh records of their source record's batch,
    so they take the buffer's fresh deltas (zeros when it has none, as
    the interpreter makes fresh records)."""
    out_off = np.zeros((rows,), dtype=np.int32)
    out_ts = np.zeros((rows,), dtype=np.int64)
    src_c = np.clip(src[:count], 0, buf.offset_deltas.shape[0] - 1)
    if not fanout:
        out_off[:count] = buf.offset_deltas[src_c]
        out_ts[:count] = buf.timestamp_deltas[src_c]
    else:
        if buf.fresh_offset_deltas is not None:
            out_off[:count] = buf.fresh_offset_deltas[src_c]
        if buf.fresh_timestamp_deltas is not None:
            out_ts[:count] = buf.fresh_timestamp_deltas[src_c]
    return RecordBuffer(
        values=None,
        lengths=out_lengths,
        keys=out_keys,
        key_lengths=out_klens,
        offset_deltas=out_off,
        timestamp_deltas=out_ts,
        count=count,
        base_offset=buf.base_offset,
        base_timestamp=buf.base_timestamp,
        _flat=flat,
        _starts=starts,
        _width=vw,
        _rows=rows,
    )


def _with_error(out, error):
    """A finished output (or its rebuild thunk) with its ``error`` set."""
    if callable(out):
        return lambda: _with_error(out(), error)
    out.error = error
    return out


def lower_chain(entries: List[Tuple[SmartModuleDef, SmartModuleConfig]]):
    """(stages, programs, agg_configs) of a chain of DSL modules, or None
    when a program is missing or outside the lowerable subset (as the
    reference's rules decide: one array_map a chain, in mode
    ``json_array`` or ``split``; no windowed aggregate after an array_map;
    an aggregate's combine among ``dsl.AGGREGATE_COMBINES`` and its
    contribution an int). Touches no device and no telemetry, so the
    preflight (`analysis.spec`) walks the same rules."""
    if not entries:
        return None
    stages: List = []
    programs: List = []
    agg_configs: List[Tuple[str, Optional[int], bytes]] = []
    try:
        for module, config in entries:
            prog = module.dsl_program(module.transform_kind())
            if prog is None:
                return None
            prog = dsl.resolve_params(prog, config.params)
            programs.append(prog)
            if isinstance(prog, dsl.FilterProgram):
                if infer_type(prog.predicate) != "bool":
                    raise Unlowerable("filter predicate must be bool")
                stages.append(_FilterStage(lower_expr(prog.predicate)))
            elif isinstance(prog, (dsl.MapProgram, dsl.FilterMapProgram)):
                sp = lower_span(prog.value)
                span_fn, span_post = sp if sp is not None else (None, ())
                predicate = None
                if isinstance(prog, dsl.FilterMapProgram):
                    predicate = lower_expr(prog.predicate)
                stages.append(
                    _MapStage(
                        value_fn=None if span_fn else lower_expr(prog.value),
                        key_fn=lower_expr(prog.key) if prog.key is not None else None,
                        predicate=predicate,
                        span_fn=span_fn,
                        span_postops=span_post,
                    )
                )
            elif isinstance(prog, dsl.AggregateProgram):
                if prog.window_ms and any(isinstance(s, _ArrayMapStage) for s in stages):
                    # explode rows carry fresh (zero) timestamps: no window key
                    raise Unlowerable("windowed aggregate after array_map")
                if prog.contribution is not None:
                    if prog.combine not in dsl.AGGREGATE_COMBINES:
                        raise Unlowerable(f"aggregate combine {prog.combine}")
                    if infer_type(prog.contribution) != "int":
                        raise Unlowerable("aggregate contribution must be int-typed")
                    op, contribution_fn = prog.combine, lower_expr(prog.contribution)
                else:
                    if prog.kind not in _AGG_OP:
                        raise Unlowerable(f"aggregate kind {prog.kind}")
                    op, contribution_fn = _AGG_OP[prog.kind], _canned_contribution(prog.kind)
                stages.append(_AggregateStage(op, prog.window_ms or None, len(agg_configs),
                                              contribution_fn))
                agg_configs.append((op, prog.window_ms or None, config.initial_data))
            elif isinstance(prog, dsl.ArrayMapProgram):
                if prog.mode not in ("json_array", "split"):
                    raise Unlowerable(f"array_map mode {prog.mode}")
                if any(isinstance(s, _ArrayMapStage) for s in stages):
                    raise Unlowerable("one array_map per fused chain")
                stages.append(_ArrayMapStage(mode=prog.mode, sep=prog.sep))
            else:
                return None
    except (Unlowerable, KeyError):
        return None
    return stages, programs, agg_configs


@dataclass(frozen=True)
class _Ship:
    """How a run of stages ships its result to the host: ``identity_view``
    (filters only: the 1-bit mask is the whole download), ``viewable``
    (late materialization: every value-writing stage is a view of the
    record's own bytes, explode elements included, so the card ships
    (start, length) descriptors and the host rebuilds the bytes from the
    slab it already holds), the views' static byte-wise folds, whether a
    stage writes keys, and whether the run explodes."""

    identity_view: bool
    viewable: bool
    view_postops: Tuple[str, ...]
    writes_keys: bool
    fanout: bool

    @classmethod
    def of(cls, stages: Sequence) -> "_Ship":
        return cls(
            identity_view=all(isinstance(s, _FilterStage) for s in stages),
            viewable=all(
                isinstance(s, (_FilterStage, _ArrayMapStage))
                or (isinstance(s, _MapStage) and s.span_fn is not None and s.key_fn is None)
                for s in stages
            ),
            view_postops=tuple(
                op
                for s in stages
                if isinstance(s, _MapStage) and s.span_fn is not None
                for op in s.span_postops
            ),
            writes_keys=any(
                (isinstance(s, _MapStage) and s.key_fn is not None)
                or (isinstance(s, _AggregateStage) and s.window_ms)
                for s in stages
            ),
            fanout=any(isinstance(s, _ArrayMapStage) for s in stages),
        )


class _FirstError(Exception):
    """A batch's explode met a record that is no JSON array: ``row`` is its
    input row, ``stage`` the explode's index, ``cap`` the capacity of the
    run that saw it."""

    def __init__(self, row: int, stage: int, cap: int):
        super().__init__(f"transform error at row {row}, stage {stage}")
        self.row, self.stage, self.cap = row, stage, cap


class GpuChainExecutor:
    """A compiled chain over one torch device, with its aggregate state."""

    def __init__(
        self, stages: List, device: torch.device, programs: Tuple = (),
        stripe_params: Optional[stripes.StripeParams] = None,
        link_params: Optional[glz.LinkParams] = None,
        agg_configs: Sequence[Tuple[str, Optional[int], bytes]] = (),
    ):
        self.stages = stages
        self.device = device
        self._programs = tuple(programs)  # resolved DSL programs, for the striped build
        self.stripe_params = stripe_params or stripes.StripeParams()
        self.link = link_params or glz.LinkParams()
        # the link's per-batch record: up-link form (raw / glz), down-link
        # form (down-glz / down-packed), declines by reason, bytes each way
        self.link_counts = _link_counts()
        self._striped: Optional[stripes.StripedChain] = None
        self._striped_tried = False
        # one (combine op, window_ms, initial_data) row per aggregate stage;
        # the carries live on the card from batch to batch
        # (`_device_carries`) and reach the host list `carries` only when a
        # caller asks (`_ensure_host_state`)
        self.agg_configs = tuple(agg_configs)
        self.carries: List[Tuple[int, int, bool]] = self.initial_carries()
        self._device_carries: Optional[Carries] = None
        self._fanout = any(isinstance(s, _ArrayMapStage) for s in stages)
        # the chain@partition identity the partition runtime installs
        # around a partition's batch (`set_partition_identity`)
        self._chain_sig = "+".join(
            type(s).__name__.lstrip("_").replace("Stage", "").lower() for s in stages
        ) or "empty"
        self.span_chain: Optional[str] = None
        self.partition_tag: Optional[str] = None
        # the link form's name in the telemetry families: the up link's
        # decode and the down link's encode run as CUDA kernels on the
        # card, as their plain torch versions on the CPU
        self._link_route = "cuda" if device.type == "cuda" else "plain"
        self._glz_last_h2d = 0  # the last dispatch's uploaded token bytes
        # the tensors the dispatch in progress uploaded: its handle keeps
        # them until the finish (`_Fetch.staged`), so the bytes the ledger
        # books as staged are live on the card for as long as it says
        self._uploads: List[torch.Tensor] = []
        TELEMETRY.note_device(device)
        self._cap_ratio = 0.0  # learned explode elements per source row
        self.redispatches = 0  # explode batches run again after an overflow
        # batches whose explode met a record that is no JSON array, each
        # re-dispatched through the stages up to the explode (`_first_error`)
        self.error_redispatches = 0
        self.error_redispatch_seconds = 0.0
        # how the whole chain ships its result, and how a run of its first
        # k stages does (the first-error re-dispatch's), made on first need
        self._ship = _Ship.of(stages)
        self._ship_prefix: Dict[int, _Ship] = {}

    @property
    def _viewable(self) -> bool:
        return self._ship.viewable

    @property
    def _writes_keys(self) -> bool:
        return self._ship.writes_keys

    # -- build --------------------------------------------------------------

    @classmethod
    def try_build(
        cls, entries: List[Tuple[SmartModuleDef, SmartModuleConfig]], device: torch.device,
        stripe_params: Optional[stripes.StripeParams] = None,
        link_params: Optional[glz.LinkParams] = None,
    ) -> Optional["GpuChainExecutor"]:
        """Lower a chain of DSL modules (`lower_chain`); None when it does
        not lower."""
        lowered = lower_chain(entries)
        if lowered is None:
            return None
        stages, programs, agg_configs = lowered
        return cls(stages, device, programs, stripe_params, link_params, agg_configs)

    # -- aggregate state ----------------------------------------------------

    def initial_carries(self) -> List[Tuple[int, int, bool]]:
        """The chain's starting aggregate state, (accumulator, window, has)
        per aggregate: ``initial_data`` seeds an unwindowed accumulator
        (`dsl.parse_int_prefix`), a windowed one starts empty."""
        out: List[Tuple[int, int, bool]] = []
        for op, window_ms, initial in self.agg_configs:
            neutral = _AGG_NEUTRAL[op]
            if window_ms:
                out.append((neutral, 0, False))
            else:
                out.append((dsl.parse_int_prefix(initial) if initial else neutral, 0, True))
        return out

    def _carries_in(self) -> Carries:
        """The carries the next batch starts from, on the card: the last
        dispatch's, else the host list's."""
        if self._device_carries is None:
            self._device_carries = tuple(
                _Carry(
                    acc=torch.tensor(acc, dtype=torch.int64, device=self.device),
                    win=torch.tensor(win, dtype=torch.int64, device=self.device),
                    has=torch.tensor(has, dtype=torch.bool, device=self.device),
                )
                for acc, win, has in self.carries
            )
        return self._device_carries

    def _ensure_host_state(self) -> None:
        """Copy the card's carries to the host list ``carries`` (the one
        synchronisation the aggregate state costs, on demand)."""
        if self._device_carries is None:
            return
        self.carries = [(int(c.acc), int(c.win), bool(c.has)) for c in self._device_carries]

    def set_partition_identity(self, key: Optional[str], group=None):
        """Install (or clear, ``key=None``) the chain@partition identity:
        ``span_chain`` is ``"<chain>@<topic/partition>"``, ``partition_tag``
        ``"<topic/partition>:g<group>"``. Returns the previous pair for
        `restore_partition_identity`."""
        prev = (self.span_chain, self.partition_tag)
        if key is None:
            self.span_chain = self.partition_tag = None
        else:
            self.span_chain = f"{self._chain_sig}@{key}"
            self.partition_tag = f"{key}:g{group}"
        return prev

    def restore_partition_identity(self, prev) -> None:
        self.span_chain, self.partition_tag = prev

    def tag_decline(self, reason: str) -> None:
        """Count a link decline on the registry's family, and again under
        ``reason@<partition tag>`` when the partition runtime tagged this
        executor."""
        TELEMETRY.add_decline(reason)
        if self.partition_tag is not None:
            TELEMETRY.add_decline(f"{reason}@{self.partition_tag}")

    def _count_down_variant(self, variant: str) -> None:
        """A finished batch's down-link form: ``link_counts`` and the
        registry's ``link_variants`` (``down-packed``, or
        ``down-glz-<route>`` when glz tokens shipped), per partition too."""
        self.link_counts[variant] += 1
        name = f"down-glz-{self._link_route}" if variant == "down-glz" else variant
        TELEMETRY.add_link_variant(name)
        if self.partition_tag is not None:
            TELEMETRY.add_link_variant(f"{name}@{self.partition_tag}")

    def _fanout_cap(self, buf: RecordBuffer) -> int:
        """Explode capacity for this batch: the learned elements-per-row
        ratio (at least 4) times the batch's rows, bucketed."""
        if not self._fanout:
            return 0
        ratio = max(self._cap_ratio, 4.0)
        return _bucket_rows(max(int(ratio * buf.rows), 1024), 1024)

    def _learn_cap(self, buf: RecordBuffer, total: int) -> None:
        # 25% headroom over the observed density
        self._cap_ratio = max(self._cap_ratio, 1.25 * total / max(buf.rows, 1))

    def max_stageable_width(self) -> int:
        """The widest record value this chain stages: any up to the hard
        ceiling when the chain has a striped lowering, else the narrow
        layout's threshold. The consume path declines a wider slice before
        dispatching any of it."""
        if self._striped_chain() is not None:
            return MAX_RECORD_WIDTH
        return self.stripe_params.threshold

    def _striped_chain(self) -> Optional[stripes.StripedChain]:
        """The chain's striped lowering, built on first need; None when a
        stage is outside the stripeable subset (`stripes.try_build_striped`
        keeps the reference's build rules)."""
        if not self._striped_tried:
            self._striped_tried = True
            p = self.stripe_params
            sc = stripes.try_build_striped(self._programs, self.stages, p.width, p.overlap)
            postops = self._ship.view_postops
            if sc is not None and self._viewable and tuple(sc.postops) != postops:
                raise AssertionError(  # both derive from the same programs
                    f"striped postops {sc.postops} differ from the view's {postops}"
                )
            self._striped = sc
        return self._striped

    # -- on the card -----------------------------------------------------------

    def _run(self, arrays: Dict[str, torch.Tensor], count: int, base_ts: int,
             fetch: _Fetch) -> None:
        """Chain body: run the stages from the batch's carries, compact the
        results and start their copies to the host. A first-error
        re-dispatch (``fetch.err_row`` set) runs stages 0..``fetch.
        err_stage`` only, ships as ``fetch.ship`` says, and copies the
        failing row as that stage saw it when an earlier stage rewrote it."""
        n = arrays["lengths"].shape[0]
        state = _State(arrays)
        state["valid"] = torch.arange(n, device=self.device) < count
        state["view_start"] = torch.zeros((n,), dtype=torch.int32, device=self.device)
        state["src_row"] = torch.arange(n, dtype=torch.int32, device=self.device)
        carries = fetch.prev_carries
        ctx = {"fanout_cap": fetch.cap}
        ship = fetch.ship or self._ship
        upto = len(self.stages) if fetch.err_row is None else fetch.err_stage + 1
        for k, stage in enumerate(self.stages[:upto]):
            if k == fetch.err_stage and k and not all(
                    isinstance(s, _FilterStage) for s in self.stages[:k]):
                self._ship_err_row(fetch, state)
            ctx["stage"] = k
            state, carries = stage.apply(state, carries, base_ts, ctx)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        fan = ([state["fan_err"], state["fan_total"], state["fan_err_stage"]] if ship.fanout
               else [zero, zero, zero])
        valid = state["valid"]
        if ship.identity_view:
            self._ship_views(fetch, valid, state["lengths"])
        elif ship.viewable:
            width = arrays["values"].shape[1]
            self._ship_views(fetch, valid, state["lengths"], state["view_start"],
                             _narrow_dtype(width), width, fan,
                             state["src_row"] if ship.fanout else None)
        else:
            self._ship_bytes(fetch, state, fan)
        # the next dispatch continues from here; a failed fetch restores
        # `fetch.prev_carries`
        self._device_carries = carries

    def _ship_err_row(self, fetch: _Fetch, state: _State) -> None:
        """Copy the failing row's value and key as the failing stage sees
        them (an earlier stage rewrote them) beside the re-dispatch's
        result: one row, not the batch."""
        row = fetch.err_row
        fetch.start("err_value", state["values"][row])
        fetch.start("err_key", state["keys"][row])
        fetch.start("err_lengths", torch.stack([state["lengths"][row].to(torch.int64),
                                                state["key_lengths"][row].to(torch.int64)]))

    @staticmethod
    def _header(out_count, max_v, max_k, fan=(), probes=()) -> torch.Tensor:
        zero = torch.zeros((), dtype=torch.int64, device=out_count.device)
        fan = list(fan) or [zero, zero, zero]
        return torch.stack([t.to(torch.int64)
                            for t in [out_count, max_v, max_k, *fan, *probes]])

    def _ship_src(self, fetch: _Fetch, src_c: torch.Tensor, out_count) -> List:
        """Keep an explode's compacted source rows on the card beside their
        deltas; returns the probe for the header."""
        d, probe = _delta_probe(src_c, out_count)
        fetch.src_col = (src_c, d)
        return probe

    def _ship_views(self, fetch: _Fetch, valid, lengths, view_start=None,
                    desc_dtype: torch.dtype = torch.int32,
                    desc_width: int = MAX_RECORD_WIDTH, fan=(), src_row=None) -> None:
        """Start the downloads of a view-mode result: the survivor mask (an
        explode ships its source rows instead, ``src_row``) and, when the
        outputs are sub-record views (``view_start`` given), the compacted
        (start, length) descriptors in ``desc_dtype``. With the down link
        on, the descriptors instead stay on the card beside the glz tokens
        of their stream (field widths from ``desc_width``) until the fetch
        picks the smaller download."""
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        if view_start is None:
            fetch.start("mask", kernels.pack_mask(valid))
            fetch.whole_records = True
            mx = torch.where(valid, lengths, 0).max()
            fetch.start("header", self._header(valid.sum(), mx, zero, fan))
            return
        probes = []
        if src_row is None:
            fetch.start("mask", kernels.pack_mask(valid))
            out_count, (st, ln) = kernels.compact_rows(valid, view_start, lengths)
        else:
            out_count, (st, ln, src_c) = kernels.compact_rows(valid, view_start, lengths, src_row)
            probes = self._ship_src(fetch, src_c, out_count)
        fetch.start("header", self._header(out_count, ln.max(), zero, fan, probes))
        if not self.link.result_compress:
            fetch.start("span_start", st.to(desc_dtype))
            fetch.start("span_len", ln.to(desc_dtype))
            return
        self._down_encode(fetch, desc_stream(st, ln, desc_width))
        fetch.desc = (st.to(desc_dtype), ln.to(desc_dtype), desc_width)

    def _down_encode(self, fetch: _Fetch, stream: torch.Tensor) -> None:
        """The down link's card half: encode a result stream (length a
        multiple of 8) with the glz window match; the tokens stay on the
        card and their counts ride the header's copies."""
        ll, ml, srcs, lits, n_seq, n_lit, depth = glz.encode_result(stream, self.link.chunk)
        fetch.start("down_meta", torch.stack([n_seq, n_lit, depth]).to(torch.int32))
        fetch.down = (ll, ml, srcs, lits)

    def _ship_bytes(self, fetch: _Fetch, state: _State, fan) -> None:
        """Byte mode: the compacted values pack into one 4-aligned payload
        (`kernels.packed_payload`) whose byte count rides the header, so
        the fetch sizes the download without a second wait; the lengths
        narrow to u8 where the output width allows. Payload, lengths and
        keys stay on the card until the header arrives; the survivor mask,
        or an explode's source rows, identify each output's record. With
        the down link on, the payload is glz-encoded on the card too."""
        valid = state["valid"]
        cols = [state["values"], state["lengths"], state["keys"], state["key_lengths"]]
        probes = []
        if (fetch.ship or self._ship).fanout:
            out_count, compacted = kernels.compact_rows(valid, *cols, state["src_row"])
            probes = self._ship_src(fetch, compacted[4], out_count)
        else:
            fetch.start("mask", kernels.pack_mask(valid))
            out_count, compacted = kernels.compact_rows(valid, *cols)
        vals, lens, keys, klens = compacted[:4]
        payload, total = kernels.packed_payload(vals, lens)
        fetch.payload_at = _HEADER + len(probes)
        fetch.start("header", self._header(out_count, lens.max(), klens.max(), fan,
                                           [*probes, total]))
        # output widths can exceed the input's (a Concat map): the length
        # tier keys off the output matrix
        lens_d = lens.to(torch.uint8) if vals.shape[1] + 1 <= (1 << 8) else lens
        fetch.byte_cols = (payload, lens_d, keys, klens, vals.shape[1])
        if self.link.result_compress:
            pad = (-payload.shape[0]) % 8
            self._down_encode(fetch, torch.cat([payload, payload.new_zeros(pad)]) if pad
                              else payload)

    # -- staging ---------------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        self.link_counts["h2d_bytes"] += t.nbytes
        if self.device.type == "cuda":
            up = t.pin_memory().to(self.device, non_blocking=True)
        else:
            up = t.to(self.device)
        self._uploads.append(up)
        return up

    def _compressed(self, buf: RecordBuffer):
        """(stream, decline reason) of the buffer's flat at the link chunk,
        compressed once and cached on the buffer (the compress-ahead worker
        fills the same cache)."""
        cached = buf._glz
        if cached is None or cached[0] != self.link.chunk:
            flat, _starts = buf.ragged_values()
            comp, reason = glz.compress_link(flat, chunk=self.link.chunk)
            cached = buf._glz = (self.link.chunk, comp, reason)
        return cached[1], cached[2]

    def precompress_fn(self, buf: RecordBuffer) -> Optional[Callable]:
        """The compress-ahead job for ``buf`` (called as ``job(buf)`` on a
        worker thread before the buffer dispatches, filling the cache
        `_compressed` reads), or None when the up link is off."""
        return self._compressed if self.link.compress else None

    def _stage_flat(self, buf: RecordBuffer, span=None) -> torch.Tensor:
        """The flat on the card as i32 words: the 4-aligned ragged bytes,
        uploaded as they are or, with the up link on, as glz tokens decoded
        on the card. A batch the compressor declines ships raw and counts
        its reason. ``span`` takes the ``stage`` phase and the
        ``glz_compress`` (tokens) or ``h2d`` (raw) phase."""
        t = time.perf_counter() if span is not None else 0.0
        flat, _starts = buf.ragged_values()
        if span is not None:
            t = span.lap("stage", t)
        self._glz_last_h2d = 0
        if self.link.compress:
            comp, reason = self._compressed(buf)
            if comp is not None:
                ll, ml, srcs, lits = tokens = [self._upload(a) for a in pad_glz_tokens(comp)]
                self._glz_last_h2d = sum(t.nbytes for t in tokens)
                self.link_counts["glz"] += 1
                raw = glz.decode_link_flat((ll, ml, srcs), lits, comp.out_len, comp.chunk_bytes,
                                           comp.depth)
                TELEMETRY.add_link_variant(f"glz-{self._link_route}")
                if span is not None:
                    span.lap("glz_compress", t)
                return raw.view(torch.int32)
            self.link_counts[reason] += 1
            self.tag_decline(reason)
        self.link_counts["raw"] += 1
        TELEMETRY.add_link_variant("raw")
        if not len(flat):
            flat = np.zeros(4, dtype=np.uint8)  # all-empty values
        up = self._upload(flat.view(np.int32))
        if span is not None:
            span.lap("h2d", t)
        return up

    def _meta_arrays(self, buf: RecordBuffer, n: int, has_keys: bool, has_offsets: bool,
                     ts_mode: str, ts_np) -> Dict[str, torch.Tensor]:
        keys, key_lengths, offset_deltas, timestamp_deltas = derived_meta_columns(
            n, buf.keys.shape[1], has_keys,
            self._upload(buf.keys) if has_keys else None,
            self._upload(buf.key_lengths) if has_keys else None,
            has_offsets,
            self._upload(buf.offset_deltas) if has_offsets else None,
            ts_mode,
            self._upload(ts_np) if ts_np is not None else None,
            self.device,
        )
        return {
            "keys": keys,
            "key_lengths": key_lengths,
            "offset_deltas": offset_deltas,
            "timestamp_deltas": timestamp_deltas,
        }

    def dispatch_buffer(self, buf: RecordBuffer) -> _Fetch:
        """Phase 1: stage, run the chain and start the result copies
        without blocking on the card; the handle feeds `finish_buffer`."""
        # chain identity on the span: the per-chain latency family the SLO
        # engine keys on (chain@partition under the partition runtime)
        span = TELEMETRY.begin_batch(chain=self.span_chain or self._chain_sig)
        if buf.width > self.stripe_params.threshold:
            if self._striped_chain() is None:
                TELEMETRY.add_stripe_fallback()
                raise GpuSpill(
                    f"record width {buf.width} exceeds the narrow layout "
                    f"({self.stripe_params.threshold}) and the chain is not stripeable",
                    reason="record-too-wide-unstripeable",
                )
            if span is not None:
                span.path = "striped"
            dispatch = self._dispatch_striped
        else:
            dispatch = self._dispatch_narrow
        self._uploads = []
        try:
            fetch = dispatch(buf, span)
        finally:
            staged, self._uploads = self._uploads, []
        fetch.staged = staged
        if span is not None:
            span.mark_dispatched()
            fetch.span = span
            self._book(fetch, sum(t.nbytes for t in staged))
        return fetch

    def _book(self, handle: _Fetch, nbytes: int) -> None:
        """A dispatch went up: its uploaded bytes stay on the card until
        the finish (or a discard) releases them — ``staged_batch``, with
        the up link's token bytes under ``glz_tokens``."""
        glz_nbytes = min(self._glz_last_h2d, nbytes)
        handle.booked = True
        TELEMETRY.mem_acquire("staged_batch", ("batch", id(handle)), nbytes - glz_nbytes)
        if glz_nbytes:
            TELEMETRY.mem_acquire("glz_tokens", ("glz", id(handle)), glz_nbytes)
        TELEMETRY.gauge_add("live_batch_handles", 1)

    @staticmethod
    def _unbook(handle: _Fetch) -> None:
        """Release the batch's uploads (and their ledger booking).
        Idempotent: a finish and a discard may both see a handle. The
        booking retires before the uploads drop, so the ledger never books
        bytes the allocator has already freed (`MemoryLedger.reconcile`)."""
        if handle.booked:
            handle.booked = False
            TELEMETRY.mem_release(("batch", id(handle)))
            TELEMETRY.mem_release(("glz", id(handle)))
            TELEMETRY.gauge_add("live_batch_handles", -1)
        handle.staged = []

    def _dispatch_narrow(self, buf: RecordBuffer, span=None) -> _Fetch:
        """The narrow path's phase 1. An explode chain's fetch keeps the
        staged inputs for an overflow's re-run (`_rerun`)."""
        flat_up = self._stage_flat(buf, span)
        t = time.perf_counter() if span is not None else 0.0
        lengths_up, has_keys, has_offsets, ts_mode, ts_np = stage_link_columns(buf)
        if span is not None:
            t = span.lap("stage", t)
        values, lengths = ragged_repad_words(flat_up, self._upload(lengths_up), buf.width)
        arrays = self._meta_arrays(buf, lengths.shape[0], has_keys, has_offsets, ts_mode, ts_np)
        arrays["values"], arrays["lengths"] = values, lengths
        if span is not None:
            t = span.lap("h2d", t)
        fetch = _Fetch(self.device, self._carries_in(), self._fanout_cap(buf))
        if self._fanout:
            fetch.arrays = arrays
        self._run(arrays, buf.count, buf.base_timestamp, fetch)
        fetch.seal()
        if span is not None:
            span.lap("dispatch", t)
        return fetch

    def _rerun(self, buf: RecordBuffer, handle: _Fetch, cap: int) -> _Fetch:
        """Run an explode batch again at ``cap`` rows, from the inputs it
        staged and the carries it started from. A striped batch re-runs
        only its fan-out, over the segment survivors its filters left."""
        fetch = _Fetch(self.device, handle.prev_carries, cap)
        fetch.span = handle.span
        if handle.striped is not None:
            ctx, valid = handle.striped
            fetch.striped = handle.striped
            self._ship_striped_fan(fetch, ctx, valid, self._striped.fan_grid(ctx))
        else:
            self._run(handle.arrays, buf.count, buf.base_timestamp, fetch)
        fetch.seal()
        if fetch.span is not None:
            fetch.span.mark_dispatched()  # the re-run restarts the device phase
        return fetch

    def _dispatch_striped(self, buf: RecordBuffer, span=None) -> _Fetch:
        """Striped phase 1: the narrow path's ragged upload, re-padded on
        the card into stripe rows with the segment sidecar derived from the
        lengths; filters reduce per segment, aggregates run on the segment
        axis (the narrow stages, sharing their carry slots). Filter and
        fold chains ship the segment survivor mask, span chains compacted
        int32 (start, length) descriptors (striped spans index records
        wider than int16) beside it, aggregate chains the byte-mode
        payload of their rendered outputs, split explodes their elements'
        int32 descriptors and source records (`_ship_striped_fan`)."""
        p = self.stripe_params
        sc = self._striped
        flat_up = self._stage_flat(buf, span)
        t = time.perf_counter() if span is not None else 0.0
        lengths_up, has_keys, has_offsets, ts_mode, ts_np = stage_link_columns(buf)
        srows = _bucket_rows(max(stripes.plan_rows(buf.lengths, buf.count, p.width, p.overlap), 8))
        if span is not None:
            t = span.lap("stage", t)
        lengths = self._upload(lengths_up).to(torch.int32)
        n = lengths.shape[0]
        plan, sv, kmax = stripes.stage_rows(flat_up, lengths, buf.lengths, buf.count, p, srows)
        arrays = self._meta_arrays(buf, n, has_keys, has_offsets, ts_mode, ts_np)
        if span is not None:
            t = span.lap("h2d", t)
        ctx = {
            "sv": sv, "plan": plan, "n": n, "kmax": kmax,
            "seg_state": _State(stripes.seg_state_of(plan, sv, lengths, arrays)),
        }
        fetch = _Fetch(self.device, self._carries_in(), self._fanout_cap(buf))
        # k > 0: the live records
        valid, seg_state, carries, fan, vspan = sc.run(
            ctx, plan["k"] > 0, fetch.prev_carries, buf.base_timestamp, {"fanout_cap": fetch.cap})
        if fan is not None:
            fetch.striped = (ctx, valid)
            self._ship_striped_fan(fetch, ctx, valid, fan)
            del fan  # the last reference to the [r, s] grids
        elif sc.has_agg:
            self._ship_bytes(fetch, seg_state, ())
        elif vspan is None:
            self._ship_views(fetch, valid, lengths)
        else:
            # int32 descriptors at the widest field tier: striped spans index
            # records wider than the u16 tier
            self._ship_views(fetch, valid, vspan[1], vspan[0])
        self._device_carries = carries
        fetch.seal()
        if span is not None:
            span.lap("dispatch", t)
        return fetch

    def _ship_striped_fan(self, fetch: _Fetch, ctx: dict, valid: torch.Tensor, fan) -> None:
        """A striped split explode's output: `kernels.fanout_scatter` over
        the ``[r, s]`` emission grid (no final slot: an element ends at a
        separator or its record's end, both inside the grid), counting the
        rows of surviving segments only; the elements ship as int32
        (start, length) descriptors within their source records, the
        source records as an explode's source rows, and the header
        carries the exact element total."""
        plan = ctx["plan"]
        r = plan["seg"].shape[0]
        seg = plan["seg"].to(torch.int64)
        contributing = valid[seg] & plan["row_live"]
        zb = torch.zeros((r,), dtype=torch.bool, device=self.device)
        zi = torch.zeros((r,), dtype=torch.int32, device=self.device)
        flag, st_g, len_g = fan
        total, local_row, rel_start, elen = kernels.fanout_scatter(
            flag, st_g, len_g, zb, zi, zi, contributing, fetch.cap)
        del flag, st_g, len_g, fan
        src_seg = plan["seg"][local_row.clamp(0, r - 1).to(torch.int64)]
        live = torch.arange(fetch.cap, dtype=torch.int32, device=self.device) < total.clamp(
            max=fetch.cap)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        self._ship_views(fetch, live, elen, rel_start, torch.int32, MAX_RECORD_WIDTH,
                         [zero, total, zero], src_seg)

    # -- host side -------------------------------------------------------------

    def finish_buffer(self, buf: RecordBuffer, handle: _Fetch) -> RecordBuffer:
        """Phase 2: wait for this batch's copies and rebuild the output.

        An explode whose element total overflowed its capacity runs again
        at the exact (bucketed) total from the batch's own carries, and
        the learned capacity grows; a retry that overflows too raises
        :class:`GpuSpill` (``fanout-overflow``), with the carries back
        where the batch found them. A record that is no JSON array ends
        the batch as the reference's chain ends it: the stages up to the
        explode run again on the card (`_first_error`), and their output
        comes back with its ``error`` set."""
        out = self.finish_buffer_deferred(buf, handle)
        return out() if callable(out) else out

    def finish_buffer_deferred(self, buf: RecordBuffer, handle: _Fetch):
        """`finish_buffer` with its pure host half split off: every
        download, the overflow re-dispatch, a `GpuSpill` with its carry
        restore and the link's byte accounting settle here, on the
        calling thread; then it returns the finished buffer (byte mode)
        or a zero-argument thunk, pure numpy over host arrays that
        touches no executor state, which rebuilds the view-mode output
        (`_materialize_view_flat`). The stream loops run the thunk on
        `fetch_mat_pool()` while the next batch dispatches.

        The batch's span ends when its output is rebuilt (inside the
        thunk when deferred); its ``fetch`` phase is the finish's time net
        of the wait for the card and the downloads."""
        span = handle.span
        t_f0 = time.perf_counter() if span is not None else 0.0
        d2h0 = span.phase("d2h") if span is not None else 0.0
        error = None
        try:
            try:
                out = self._settle(buf, handle)
            except _FirstError as fe:
                out, error = self._first_error(buf, handle, fe)
        except GpuSpill:
            self._device_carries = handle.prev_carries
            raise
        finally:
            # every finish outcome retires the batch's ledger booking
            self._unbook(handle)
        handle.error = error
        if error is not None:
            out = _with_error(out, error)
        if span is None:
            return out

        def complete(result):
            wait = span.ready_t - t_f0 if span.ready_t is not None and span.ready_t > t_f0 else 0.0
            span.add("fetch", (time.perf_counter() - t_f0) - wait - (span.phase("d2h") - d2h0))
            # records: the INPUT records staged through this batch
            TELEMETRY.end_batch(span, records=buf.count)
            return result

        if callable(out):
            return lambda: complete(out())
        return complete(out)

    def _settle(self, buf: RecordBuffer, handle: _Fetch):
        """`_finish`, with an overflowed explode run again once at its
        exact (bucketed) total. Raises `_FirstError` for a batch whose
        explode failed."""
        try:
            return self._finish(buf, handle)
        except _FanoutOverflow as o:
            self._learn_cap(buf, o.total)
            self.redispatches += 1
            retry = self._rerun(buf, handle, _bucket_rows(o.total, 1024))
            try:
                return self._finish(buf, retry)
            except _FanoutOverflow as e:
                raise GpuSpill(f"fanout overflow after retry: {e.total}",
                               reason="fanout-overflow") from None

    def _first_error(self, buf: RecordBuffer, handle: _Fetch, fe: _FirstError):
        """Exact first-error semantics on the card, the reference chain's
        (engine.rs:159-161): it stops after the failing instance and returns
        that instance's partial output. From the batch's starting carries,
        stages 0..k (k the explode) run again over the staged inputs; the
        explode's mask already ends before the failing row, so its elements
        are the chain's output. Stages before k advance their carries over
        the whole batch, stages k and after keep the batch's starting ones.
        Returns (output, `SmartModuleTransformRuntimeError` at the failing
        record with its key and value as stage k saw them)."""
        t0 = time.perf_counter()
        k1 = fe.stage + 1
        ship = self._ship_prefix.get(k1)
        if ship is None:
            ship = self._ship_prefix[k1] = _Ship.of(self.stages[:k1])
        fetch = _Fetch(self.device, handle.prev_carries, fe.cap)
        fetch.span = handle.span
        fetch.ship, fetch.err_row, fetch.err_stage = ship, fe.row, fe.stage
        self._run(handle.arrays, buf.count, buf.base_timestamp, fetch)
        fetch.seal()
        if fetch.span is not None:
            fetch.span.mark_dispatched()  # the re-run restarts the device phase
        # the same elements as the run that saw the error: no overflow
        out = self._finish(buf, fetch)
        host = fetch.wait()
        if "err_value" in host:
            vlen, klen = (int(x) for x in host["err_lengths"])
            value = host["err_value"][:vlen].tobytes()
            key = None if klen < 0 else host["err_key"][:klen].tobytes()
        else:  # only filters before the explode: the row is the input's
            value, key = buf.record_bytes(fe.row)
        error = SmartModuleTransformRuntimeError(
            hint="input record is not a JSON array",
            offset=buf.base_offset + int(buf.offset_deltas[fe.row]),
            kind=SmartModuleKind.ARRAY_MAP,
            record_key=key,
            record_value=value,
        )
        self.error_redispatches += 1
        self.error_redispatch_seconds += time.perf_counter() - t0
        return out, error

    def discard_dispatch(self, handle: _Fetch) -> None:
        """Drop a dispatched batch without finishing it: the carries go
        back to those the batch started from (its span is dropped)."""
        self._unbook(handle)
        self._device_carries = handle.prev_carries

    def dispatch_buffers(self, bufs: Sequence[RecordBuffer]) -> List[Tuple[RecordBuffer, _Fetch]]:
        """Dispatch every buffer before any is read, for `finish_buffer`
        in order; returns [(buf, handle), ...]. With the up link on, one
        worker compresses buffer k+1 while buffer k dispatches. A dispatch
        that fails discards the handles before it (the carries go back to
        where the first buffer found them) and raises."""
        out: List[Tuple[RecordBuffer, _Fetch]] = []
        pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="glz-compress")
                if self.link.compress and len(bufs) > 1 else None)
        job = None
        try:
            for i, buf in enumerate(bufs):
                if job is not None:
                    job.result()  # the worker never races a dispatch on its buffer
                    job = None
                if pool is not None and i + 1 < len(bufs):
                    job = pool.submit(self._compressed, bufs[i + 1])
                out.append((buf, self.dispatch_buffer(buf)))
        except BaseException:
            for _, h in reversed(out):
                self.discard_dispatch(h)
            raise
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return out

    def _finish(self, buf: RecordBuffer, handle: _Fetch) -> RecordBuffer:
        host = handle.wait()
        span = handle.span
        self.link_counts["d2h_bytes"] += sum(a.nbytes for a in host.values())
        hdr = [int(x) for x in host["header"]]
        count, max_v, max_k, err_row1, fan_total, err_stage = hdr[:_HEADER]
        ship = handle.ship or self._ship
        if ship.fanout and fan_total > handle.cap:
            raise _FanoutOverflow(fan_total)
        if err_row1 and handle.err_row is None:
            raise _FirstError(err_row1 - 1, err_stage, handle.cap)
        rows = _bucket_rows(max(count, 1))
        if handle.src_col is not None:
            t = time.perf_counter() if span is not None else 0.0
            src = self._download_src(*handle.src_col, hdr[_HEADER:_HEADER + 3], count, rows)
            if span is not None:
                span.lap("d2h", t)
        else:
            src = np.flatnonzero(np.unpackbits(host["mask"], bitorder="little")[: buf.rows])[:count]
        if not ship.viewable:
            return self._fetch_bytes(buf, handle, host, hdr, count, rows, src)
        variant = "down-packed"
        if handle.whole_records:
            st = np.zeros(count, dtype=np.int64)
            ln = buf.lengths[src].astype(np.int32)
        elif handle.desc is not None:
            t = time.perf_counter() if span is not None else 0.0
            st, ln, variant = self._down_fetch(handle, host["down_meta"], count, rows)
            if span is not None:
                span.lap("d2h", t)
        else:
            st = host["span_start"][:count].astype(np.int64)
            ln = host["span_len"][:count].astype(np.int32)
        self._count_down_variant(variant)
        vw = min(_pad_slice(max(max_v, 1)), buf.width)
        return functools.partial(_materialize_view_flat, buf, count, rows, vw, st, ln, src,
                                 ship.view_postops, ship.fanout)

    def _download_src(self, col: torch.Tensor, delta: torch.Tensor, probe: Sequence[int],
                      count: int, rows: int) -> np.ndarray:
        """An explode's compacted source rows, as int64: u8 deltas (then one
        cumsum from the first row) when every step fits a byte, which it
        does unless a run of records explodes to nothing; else the column."""
        lo, hi, first = probe
        if 0 <= lo and hi <= 255:
            raw = self._download(delta[:rows].to(torch.uint8))
            return np.cumsum(raw[:count].astype(np.int64)) + np.int64(first)
        return self._download(col[:rows])[:count].astype(np.int64)

    def _download(self, t: torch.Tensor) -> np.ndarray:
        """One synchronous device -> host copy, counted on the link."""
        out = t.cpu().numpy()
        self.link_counts["d2h_bytes"] += out.nbytes
        return out

    def _down_try(self, handle: _Fetch, meta, raw_cost: int) -> Optional[np.ndarray]:
        """The down link's fetch half: download the glz tokens of the
        result stream when their bucketed slices (6 bytes a sequence plus
        the literals) cost less than ``raw_cost``, the bytes of the raw
        download, and decode them on the host; else count the decline
        (`glz-enc-ratio`) and return None, and the caller downloads the
        raw form. Returns the whole decoded stream."""
        ll, ml, srcs, lits = handle.down
        n_seq, n_lit, depth = (int(x) for x in meta)
        bs = min(_bucket_rows(max(n_seq, 8), floor=256), ll.shape[0])
        bl = min(_bucket_rows(max(n_lit, 8), floor=256), lits.shape[0])
        if bs * 6 + bl >= raw_cost:
            self.link_counts[glz.DECLINE_ENC_RATIO] += 1
            self.tag_decline(glz.DECLINE_ENC_RATIO)
            return None
        return glz.decode_result_host(
            self._download(ll[:bs]), self._download(ml[:bs]), self._download(srcs[:bs]),
            self._download(lits[:bl]), n_seq, n_lit, lits.shape[0], depth,
        )

    def _down_fetch(self, handle: _Fetch, meta, count: int, rows: int):
        """A view chain's descriptors with the down link on: the decoded
        token stream split into columns, or the raw descriptor rows when
        the tokens decline. Returns (start i64, length i32, down-link
        variant)."""
        st_d, ln_d, desc_width = handle.desc
        rows = min(rows, st_d.shape[0])
        stream = self._down_try(handle, meta, rows * (st_d.element_size() + ln_d.element_size()))
        if stream is None:
            st = self._download(st_d[:rows])[:count].astype(np.int64)
            ln = self._download(ln_d[:rows])[:count].astype(np.int32)
            return st, ln, "down-packed"
        st, ln = desc_split(stream, count, desc_width)
        return st, ln, "down-glz"

    def _fetch_bytes(self, buf, handle, host, hdr, count, rows, src) -> RecordBuffer:
        """Byte mode: download the packed payload sliced to its bucketed
        byte count (``payload[:pb]``), or its glz tokens when the down
        link is on and they are smaller, with the narrowed lengths and the
        keys sliced to the survivor rows; the output adopts the payload
        flat-backed, its row starts one cumsum of the aligned lengths (no
        ``[rows, width]`` matrix on either side)."""
        payload, lens_d, keys, klens, width = handle.byte_cols
        t_d2h = time.perf_counter() if handle.span is not None else 0.0
        max_v, max_k = hdr[1], hdr[2]
        rows = min(rows, lens_d.shape[0])
        vw = min(_pad_slice(max(max_v, 1)), width)
        pb = min(_bucket_rows(max(hdr[handle.payload_at], 1), floor=256), payload.shape[0])
        flat_src, variant = None, "down-packed"
        if handle.down is not None:
            flat_src = self._down_try(handle, host["down_meta"], pb)
            if flat_src is not None:
                variant = "down-glz"
        if flat_src is None:
            flat_src = self._download(payload[:pb])
        # the row starts are one exclusive cumsum of the aligned lengths,
        # in torch on the host (several times numpy's speed on 1 M rows);
        # int32 is safe: the payload's total fits it (`kernels.packed_payload`)
        out_lengths = torch.from_numpy(self._download(lens_d[:rows])).to(torch.int32)
        out_lengths[count:] = 0
        l4 = (out_lengths + 3) & ~3
        starts = torch.zeros_like(l4)
        torch.cumsum(l4[:-1], 0, dtype=torch.int32, out=starts[1:])
        total = int(starts[-1] + l4[-1])
        ship = handle.ship or self._ship
        if buf.has_keys() or ship.writes_keys:
            out_klens = self._download(klens[:rows]).astype(np.int32)
            if max_k > 0:
                kw = min(_pad_slice(max_k), keys.shape[1])
                out_keys = self._download(keys[:rows, :kw])
            else:
                out_keys = np.zeros((rows, 1), dtype=np.uint8)
        else:
            out_klens = np.full((rows,), -1, dtype=np.int32)
            out_keys = np.zeros((rows, 1), dtype=np.uint8)
        if handle.span is not None:
            handle.span.lap("d2h", t_d2h)  # the downloads (and a token decode)
        self._count_down_variant(variant)
        return _assemble(buf, count, rows, out_lengths.numpy(), out_keys, out_klens, src,
                         flat_src[:total], starts.numpy(), vw, ship.fanout)

    # -- entry points ----------------------------------------------------------

    def process_buffer(self, buf: RecordBuffer) -> RecordBuffer:
        return self.finish_buffer(buf, self.dispatch_buffer(buf))

    def process(self, inp: SmartModuleInput, metrics=None) -> SmartModuleOutput:
        """One `SmartModuleInput` through the chain (the chain instance's
        `process`), as one batch. A record past the hard width ceiling
        raises :class:`GpuSpill` (``record-too-wide``); a spill of
        `process_buffer` propagates too: nothing reruns elsewhere. A
        transform error comes back as the output's ``error`` beside the
        records before it. Fuel is the records staged times the stages."""
        try:
            buf = RecordBuffer.from_smartmodule_input(inp)
        except ValueError as e:
            raise GpuSpill(str(e), reason="record-too-wide") from None
        out = self.process_buffer(buf)
        if self.agg_configs:
            self._ensure_host_state()
        if metrics is not None:
            metrics.add_fuel_used(buf.count * max(len(self.stages), 1))
        return SmartModuleOutput(successes=out.to_records(), error=out.error)

    def process_stream(self, bufs):
        """Pipelined generator: batch k+1 is staged and queued on the card
        before batch k's results are waited for, so the card works on k+1
        while the host rebuilds k. A batch already dispatched is still
        delivered when the next one fails to dispatch.

        Batch k+1 is taken from ``bufs`` once batch k has dispatched, before
        batch k-1 is finished: with the up link on, one worker thread
        compresses it meanwhile (the compressor releases the GIL), and its
        job is settled before that buffer dispatches. The cost of that
        lookahead: batch k-1's results yield once batch k+1 has arrived.

        Each batch finishes through `finish_buffer_deferred`: its view
        rebuild runs on `fetch_mat_pool()` while the next batch dispatches.

        A chain with an explode and an aggregate runs one batch at a time:
        an overflow re-dispatch restarts its batch from the carries that
        the next batch's dispatch would already have moved on from."""
        if self.agg_configs and self._fanout:
            for buf in bufs:
                yield self.process_buffer(buf)
            return
        if not self.link.compress:
            yield from self._pipeline(iter(bufs), None)
            return
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="glz-compress") as pool:
            yield from self._pipeline(iter(bufs), pool)

    def _pipeline(self, it, pool: Optional[ThreadPoolExecutor]):
        """Batch k's deferred finish settles on this thread, then its thunk
        runs on `fetch_mat_pool()` while batch k+1 dispatches and batch k-1's
        thunk is collected. A failure drains the thunk in flight (its
        batch is delivered) before it propagates."""
        pending = None
        job = None
        mat = None  # the previous batch's thunk on the fetch worker
        cur = next(it, None)
        try:
            while cur is not None:
                try:
                    if job is not None:
                        job.result()  # the worker never races a dispatch on its buffer
                        job = None
                    handle = self.dispatch_buffer(cur)
                except BaseException:
                    if mat is not None:
                        done, mat = mat, None
                        yield done.result()
                    if pending is not None:
                        yield self.finish_buffer(*pending)
                    raise
                nxt = next(it, None)
                if nxt is not None and pool is not None:
                    job = pool.submit(self._compressed, nxt)
                if pending is not None:
                    out = self.finish_buffer_deferred(*pending)
                    if mat is not None:
                        done, mat = mat, None
                        yield done.result()
                    if callable(out):
                        mat = fetch_mat_pool().submit(out)
                    else:
                        yield out
                pending = (cur, handle)
                cur = nxt
            if pending is not None:
                out = self.finish_buffer_deferred(*pending)
                if mat is not None:
                    done, mat = mat, None
                    yield done.result()
                yield out() if callable(out) else out
        except GeneratorExit:
            raise
        except BaseException:
            if mat is not None:
                yield mat.result()
            raise
