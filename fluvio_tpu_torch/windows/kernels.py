"""The windowed-state update and merge as torch code.

The port's counterpart of ``fluvio_tpu/windows/kernels.py``, which is one
jitted XLA program, not Pallas. The per-batch update is a pure function
of (bank, batch): window assignment (tumbling or sliding replication),
optional per-key segmentation, a sort-based segmented merge of the
batch's contributions into the device-resident state bank, watermark
advance, window closing and delta-row compaction, everything up to (but
not including) the delta download. It runs eagerly on the tensors'
device and synchronises nothing with the host.

Merge strategy, as in the reference: concat (bank entries ++ replicated
batch rows), one stable sort over the composite int64 segment id
(key * KEY_STRIDE + window_index; empties sort last), segment heads where
the id changes, then the same `segmented_scan` and `compact_rows` the
aggregate stage uses. Ties sort only inside one id, and the monoids are
commutative integer ops, so every value is bit-equal to the reference's.

No function here writes into a tensor it was given: the bank's tensors
are never changed in place, so a batch that fails leaves the carry as it
was.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from fluvio_tpu_torch.smartengine.gpu.kernels import (
    _first_true,
    compact_rows,
    parse_int,
    segmented_scan,
)
from fluvio_tpu_torch.windows.spec import EMPTY_ID, INT64_MIN, KEY_STRIDE, WindowSpec

# ---------------------------------------------------------------------------
# Keyed record parsing
# ---------------------------------------------------------------------------


def parse_two_ints(values: torch.Tensor,
                   lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-record ``"<key> <value>"`` parse: the leading ASCII int and the
    int after the first space (0 when absent). `parse_int` twice, the
    second time over each row shifted past its first space."""
    width = values.shape[1]
    lengths = lengths.to(torch.int32)
    first = parse_int(values, lengths)
    col = torch.arange(width, dtype=torch.int64, device=values.device)
    is_sp = (values == 32) & (col[None, :] < lengths[:, None])
    sp = _first_true(is_sp)  # width where the row has no space
    idx = (sp[:, None] + 1 + col[None, :]).clamp(0, width - 1)
    shifted = torch.gather(values, 1, idx)
    rest = torch.where(sp < width, lengths - sp - 1, 0)
    second = parse_int(shifted, rest)
    return first, second


# ---------------------------------------------------------------------------
# Segmented merge (the bank combine)
# ---------------------------------------------------------------------------


def _segment_merge(ids, accs, cnts, touched, op: str):
    """Combine rows sharing a composite id: one stable sort + segmented
    scans; returns (n_entries, entry columns, live mask), entries
    compacted to the front with empty slots re-marked EMPTY_ID."""
    m = ids.shape[0]
    dev = ids.device
    sid, order = torch.sort(ids, stable=True)
    sacc = accs[order]
    scnt = cnts[order]
    stb = touched[order]
    change = sid[1:] != sid[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    head = torch.cat([one, change])
    tail = torch.cat([change, one])
    acc_run = segmented_scan(sacc, head, op)
    cnt_run = segmented_scan(scnt, head, "add")
    tb_run = segmented_scan(stb, head, "add")
    is_entry = tail & (sid != EMPTY_ID)
    n_entries, (e_ids, e_accs, e_cnts, e_tb) = compact_rows(
        is_entry, sid, acc_run, cnt_run, tb_run
    )
    # compact_rows zero-fills dropped slots; a zero id is a REAL composite
    # id (key 0, window 0), so dead slots must be re-marked
    live = torch.arange(m, dtype=torch.int32, device=dev) < n_entries
    e_ids = torch.where(live, e_ids, EMPTY_ID)
    return n_entries, e_ids, e_accs, e_cnts, e_tb, live


def _new_bank(n_open, o_ids, o_accs, o_cnts, capacity: int, neutral: int):
    """The first ``capacity`` compacted open entries as the next bank;
    slots past ``n_open`` empty."""
    in_bank = torch.arange(capacity, dtype=torch.int32, device=o_ids.device) < n_open
    return (
        torch.where(in_bank, o_ids[:capacity], EMPTY_ID),
        torch.where(in_bank, o_accs[:capacity], neutral),
        torch.where(in_bank, o_cnts[:capacity], 0),
    )


def _update_core(
    window_ms: int,
    slide_ms: int,
    fanout: int,
    lateness_ms: int,
    op: str,
    neutral: int,
    capacity: int,
    emit_cap: int,
    delta_only: bool,
    bank_ids,
    bank_accs,
    bank_cnts,
    watermark,
    contribs,
    keys,
    ts,
    valid,
):
    """One batch's full window-state transition; returns (header, the new
    bank's three columns, the four emit columns). The header holds, as
    int64: emitted rows, open entries, closed entries, late rows, the new
    watermark, the bank-overflow flag, the emit-overflow flag and invalid
    rows."""
    dev = contribs.device
    # composite-id packing only holds for keys in [0, KEY_STRIDE): an
    # out-of-range key would alias into another key's window-id space.
    # Such rows are invalid: counted in the header and dropped entirely
    # (no fold, no watermark advance); reference.py mirrors it.
    key_ok = (keys >= 0) & (keys < KEY_STRIDE)
    invalid = valid & ~key_ok
    valid = valid & key_ok
    # -- window assignment (sliding replicates each record over the fanout
    # window phases; tumbling is fanout == 1) -------------------------------
    base_idx = torch.where(valid, torch.div(ts, slide_ms, rounding_mode="floor"), 0)
    j = torch.arange(fanout, dtype=torch.int64, device=dev)
    win_idx = base_idx[:, None] - j[None, :]
    rep_valid = valid[:, None] & (win_idx >= 0)
    win_end = win_idx * slide_ms + window_ms
    # late vs the PRE-batch watermark: the window already closed in an
    # earlier batch, so folding this row in would re-open it
    late = rep_valid & (win_end + lateness_ms <= watermark)
    rep_valid = rep_valid & ~late
    ids = torch.where(rep_valid, keys[:, None] * KEY_STRIDE + win_idx, EMPTY_ID)
    rep_acc = torch.where(rep_valid, contribs[:, None], neutral)
    rep_cnt = rep_valid.to(torch.int64)
    # -- merge into the bank ------------------------------------------------
    all_ids = torch.cat([bank_ids, ids.reshape(-1)])
    all_accs = torch.cat([bank_accs, rep_acc.reshape(-1)])
    all_cnts = torch.cat([bank_cnts, rep_cnt.reshape(-1)])
    all_tb = torch.cat([torch.zeros_like(bank_cnts), rep_cnt.reshape(-1)])
    n_entries, e_ids, e_accs, e_cnts, e_tb, live = _segment_merge(
        all_ids, all_accs, all_cnts, all_tb, op
    )
    # -- watermark + closing ------------------------------------------------
    # the extra element keeps an empty batch's max defined
    floor = torch.full((1,), INT64_MIN + 1, dtype=torch.int64, device=dev)
    batch_max = torch.cat([torch.where(valid, ts, INT64_MIN + 1), floor]).max()
    new_wm = torch.maximum(watermark, batch_max)
    e_win_idx = torch.where(live, torch.remainder(e_ids, KEY_STRIDE), 0)
    e_win_end = e_win_idx * slide_ms + window_ms
    closed = live & (e_win_end + lateness_ms <= new_wm)
    open_m = live & ~closed
    # -- delta emission: closed windows always ship; open entries ship only
    # when this batch touched them (delta_only off = full state). Closed
    # rows compact FIRST, so the emit-overflow resync can still fetch the
    # batch's closes as a bounded prefix of the emit columns.
    emit_open = (open_m & (e_tb > 0)) if delta_only else open_m
    m = e_ids.shape[0]
    n_emit, (m_ids, m_accs, m_cnts, m_closed) = compact_rows(
        torch.cat([closed, emit_open]),
        torch.cat([e_ids, e_ids]),
        torch.cat([e_accs, e_accs]),
        torch.cat([e_cnts, e_cnts]),
        torch.cat([
            torch.ones((m,), dtype=torch.int32, device=dev),
            torch.zeros((m,), dtype=torch.int32, device=dev),
        ]),
    )
    # -- new bank: open entries only, compacted to capacity -----------------
    n_open, (o_ids, o_accs, o_cnts) = compact_rows(open_m, e_ids, e_accs, e_cnts)
    nb_ids, nb_accs, nb_cnts = _new_bank(n_open, o_ids, o_accs, o_cnts, capacity, neutral)
    # -- bounded emit columns + scalar header -------------------------------
    e_slice = min(emit_cap, m_ids.shape[0])
    header = torch.stack([
        n_emit.to(torch.int64),
        n_open.to(torch.int64),
        closed.sum(),
        late.sum(),
        new_wm,
        (n_open > capacity).to(torch.int64),
        (n_emit > e_slice).to(torch.int64),
        invalid.sum(),
    ])
    return (
        header,
        nb_ids,
        nb_accs,
        nb_cnts,
        m_ids[:e_slice],
        m_accs[:e_slice],
        m_cnts[:e_slice],
        m_closed[:e_slice],
    )


def _merge_core(op: str, neutral: int, capacity: int, a, b):
    """Associative bank combine for striped/sharded ingest: two banks'
    entries merge into one (watermark = max). No closing and no emission
    here: those happen at the next update against the merged bank, so
    split ingest stays bit-equal to serial ingest. Returns (header of
    open entries, watermark, overflow flag; the bank's three columns)."""
    a_ids, a_accs, a_cnts, a_wm = a
    b_ids, b_accs, b_cnts, b_wm = b
    ids = torch.cat([a_ids, b_ids])
    accs = torch.cat([a_accs, b_accs])
    cnts = torch.cat([a_cnts, b_cnts])
    _n, e_ids, e_accs, e_cnts, _tb, live = _segment_merge(
        ids, accs, cnts, torch.zeros_like(cnts), op
    )
    n_open, (o_ids, o_accs, o_cnts) = compact_rows(live, e_ids, e_accs, e_cnts)
    nb_ids, nb_accs, nb_cnts = _new_bank(n_open, o_ids, o_accs, o_cnts, capacity, neutral)
    header = torch.stack([
        n_open.to(torch.int64),
        torch.maximum(a_wm, b_wm),
        (n_open > capacity).to(torch.int64),
    ])
    return header, nb_ids, nb_accs, nb_cnts


# ---------------------------------------------------------------------------
# The bound functions of one spec
# ---------------------------------------------------------------------------


def _spec_statics(spec: WindowSpec) -> tuple:
    return (
        spec.window_ms,
        spec.slide_ms,
        spec.fanout,
        spec.lateness_ms,
        spec.op,
        spec.neutral,
        spec.capacity,
        spec.emit_capacity,
        spec.delta_only,
    )


def _from_values(statics, keyed, bank_ids, bank_accs, bank_cnts, watermark,
                 values, lengths, ts, valid):
    if keyed:
        keys, contribs = parse_two_ints(values, lengths)
    else:
        keys = torch.zeros(values.shape[:1], dtype=torch.int64, device=values.device)
        contribs = parse_int(values, lengths)
    return _update_core(
        *statics, bank_ids, bank_accs, bank_cnts, watermark,
        contribs, keys, ts, valid,
    )


def _from_arrays(statics, bank_ids, bank_accs, bank_cnts, watermark,
                 contribs, keys, ts, valid):
    return _update_core(
        *statics, bank_ids, bank_accs, bank_cnts, watermark,
        contribs, keys, ts, valid,
    )


class WindowEagerOps:
    """The update and merge functions of one `WindowSpec`, bound to its
    statics and run eagerly (the counterpart of the reference's
    ``WindowJits``, which compiles one XLA program each; this compiles
    nothing): the value-parsing update (the RecordBuffer path), the
    pre-parsed-array update (the seam striped/sharded split-backs feed)
    and the bank merge (the shard combine)."""

    def __init__(self, spec: WindowSpec):
        self.spec = spec
        statics = _spec_statics(spec)
        self.update_values = functools.partial(_from_values, statics, spec.keyed)
        self.update_arrays = functools.partial(_from_arrays, statics)
        self.merge = functools.partial(_merge_core, spec.op, spec.neutral, spec.capacity)
