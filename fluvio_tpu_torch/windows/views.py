"""Broker-side materialized view: folds window deltas into a queryable
table (the port's copy of ``fluvio_tpu/windows/views.py``).

The consumer-facing read surface of the delta-only downlink: each batch
ships only closed windows and changed (key, window) entries; the view
folds them into an open table and a closed table keyed by the composite
segment id. Folding is IDEMPOTENT by construction — an upsert overwrites
with the same merged value and a re-delivered close re-writes the same
final row — so the failover/migration replay ladder (re-serving deltas
from the last committed snapshot) converges to the identical table
instead of double-counting. `duplicate_closes` stays observable so the
exactly-once tests can pin that normal runs never re-close.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from fluvio_tpu_torch.windows.spec import KEY_STRIDE, WindowSpec


def split_id(spec: WindowSpec, composite: int) -> Tuple[int, int]:
    """(key, win_start) from a composite segment id."""
    key, win_idx = divmod(int(composite), KEY_STRIDE)
    return key, win_idx * spec.slide_ms


class MaterializedView:
    """Keyed window table folded from the delta stream."""

    def __init__(self, spec: WindowSpec):
        self.spec = spec
        self.open: Dict[int, Tuple[int, int]] = {}  # id -> (acc, count)
        self.closed: Dict[int, Tuple[int, int]] = {}
        self.watermark: Optional[int] = None
        self.close_events = 0
        self.duplicate_closes = 0
        self.resyncs = 0

    # -- folding -------------------------------------------------------------

    def apply_delta(self, delta) -> None:
        """Fold one batch's `WindowDelta` (engine.py). Resync deltas
        REPLACE the open table from their open rows — and still fold
        their closed rows (the batch's closes ride the resync as a
        prefix; their final aggregates left the bank when they closed);
        row deltas upsert/close incrementally."""
        if delta.kind == "resync":
            self.resyncs += 1
            fresh = {}
            for i, a, c, cl in zip(
                delta.ids, delta.accs, delta.counts, delta.closed
            ):
                i = int(i)
                if cl:
                    self._close(i, int(a), int(c))
                else:
                    fresh[i] = (int(a), int(c))
            self.open = fresh
        else:
            for i, a, c, cl in zip(
                delta.ids, delta.accs, delta.counts, delta.closed
            ):
                i = int(i)
                if cl:
                    self._close(i, int(a), int(c))
                    self.open.pop(i, None)
                else:
                    self.open[i] = (int(a), int(c))
        self.watermark = int(delta.watermark)

    def _close(self, i: int, acc: int, cnt: int) -> None:
        if i in self.closed:
            self.duplicate_closes += 1
        else:
            self.close_events += 1
        self.closed[i] = (acc, cnt)

    def resync(self, rows, watermark: int) -> None:
        """Full-state resync (consumer attach / failover seed): replace
        the open table from bank rows [[id, acc, count], ...]."""
        self.resyncs += 1
        self.open = {int(r[0]): (int(r[1]), int(r[2])) for r in rows}
        self.watermark = int(watermark)

    # -- reads ---------------------------------------------------------------

    def table(self) -> Dict[Tuple[int, int], Tuple[int, int, str]]:
        """{(key, win_start): (acc, count, "open"|"closed")} — the
        exactness-pin shape (host references produce the same)."""
        out = {}
        for i, (a, c) in self.closed.items():
            out[split_id(self.spec, i)] = (a, c, "closed")
        for i, (a, c) in self.open.items():
            out[split_id(self.spec, i)] = (a, c, "open")
        return out

    def query(
        self, key: Optional[int] = None, include_open: bool = True
    ) -> List[dict]:
        """Row-oriented read surface, optionally filtered by key."""
        rows = []
        sources = [("closed", self.closed)]
        if include_open:
            sources.append(("open", self.open))
        for status, table in sources:
            for i, (a, c) in table.items():
                k, ws = split_id(self.spec, i)
                if key is not None and k != key:
                    continue
                rows.append(
                    {
                        "key": k,
                        "win_start": ws,
                        "win_end": ws + self.spec.window_ms,
                        "value": a,
                        "count": c,
                        "status": status,
                    }
                )
        rows.sort(key=lambda r: (r["key"], r["win_start"]))
        return rows
