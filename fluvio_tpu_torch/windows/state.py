"""The device-resident window state bank.

The port's counterpart of ``fluvio_tpu/windows/state.py``: up to
``capacity`` (composite id, acc, count) rows plus one watermark scalar,
living on the torch device across batches so nothing but the per-batch
delta crosses the link down. The host mirrors (`occupancy`, `watermark`)
update from each batch's scalar header; `snapshot` / `restore` produce
and take the host tuples of the replica bus, and `to_device` re-places
the live tensors. Only `snapshot` and `full_rows` download the bank.
Every commit and restore books the bank's live bytes (`state_bytes`: the
live entries' id, acc and count plus the watermark scalar) under the
device-memory ledger's ``window_bank`` owner, always on, as the
reference books them: state size is exactness evidence.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from fluvio_tpu_torch.telemetry import memory as memory_mod
from fluvio_tpu_torch.windows.spec import EMPTY_ID, INT64_MIN, WindowCapacityError, WindowSpec

# bytes one live bank entry occupies on device (id + acc + count, i64)
ENTRY_BYTES = 24


class WindowStateBank:
    """Per-stream (or per-partition) windowed carry state on ``device``."""

    def __init__(self, spec: WindowSpec, device):
        self.spec = spec
        self.device = torch.device(device)
        self.occupancy = 0  # live entries (host mirror of the header)
        self.watermark = INT64_MIN + 1  # host mirror
        k = spec.capacity
        self.ids = torch.full((k,), EMPTY_ID, dtype=torch.int64, device=self.device)
        self.accs = torch.full((k,), spec.neutral, dtype=torch.int64, device=self.device)
        self.counts = torch.zeros((k,), dtype=torch.int64, device=self.device)
        self.wm = torch.tensor(self.watermark, dtype=torch.int64, device=self.device)

    def arrays(self) -> tuple:
        return self.ids, self.accs, self.counts, self.wm

    def commit(self, ids, accs, counts, wm, occupancy: int, watermark: int) -> None:
        """Install one batch's merged state (called only after the batch's
        header landed and passed its checks: a failed batch leaves the
        previous carry untouched)."""
        self.ids, self.accs, self.counts, self.wm = ids, accs, counts, wm
        self.occupancy = int(occupancy)
        self.watermark = int(watermark)
        memory_mod.note_window_bank(id(self), self.state_bytes())

    def state_bytes(self) -> int:
        """Live device bytes of the carry."""
        return self.occupancy * ENTRY_BYTES + 8

    def _live_rows(self) -> np.ndarray:
        """The live entries as host rows [[id, acc, count], ...]: one
        download of the first `occupancy` slots."""
        n = self.occupancy
        return torch.stack([self.ids[:n], self.accs[:n], self.counts[:n]], dim=1).cpu().numpy()

    # -- failover / migration (replica tuple format) -------------------------

    def snapshot(self) -> Tuple[List[tuple], int]:
        """Host snapshot: ([(id, acc, count), ...] live entries, the
        watermark), the carries/inst_state pair a replica publishes."""
        return [tuple(int(x) for x in row) for row in self._live_rows()], self.watermark

    def restore(self, entries: List[tuple], watermark: int) -> None:
        """Seed from a snapshot (promotion / migration / consumer resync):
        entries land compacted and the device tensors rebuild in one
        upload each."""
        k = self.spec.capacity
        if len(entries) > k:
            raise WindowCapacityError(
                f"snapshot holds {len(entries)} entries; bank capacity is {k}"
            )
        ids = np.full((k,), EMPTY_ID, dtype=np.int64)
        accs = np.full((k,), self.spec.neutral, dtype=np.int64)
        counts = np.zeros((k,), dtype=np.int64)
        for i, (eid, acc, cnt) in enumerate(entries):
            ids[i], accs[i], counts[i] = eid, acc, cnt
        self.ids = torch.from_numpy(ids).to(self.device)
        self.accs = torch.from_numpy(accs).to(self.device)
        self.counts = torch.from_numpy(counts).to(self.device)
        self.wm = torch.tensor(int(watermark), dtype=torch.int64, device=self.device)
        self.occupancy = len(entries)
        self.watermark = int(watermark)
        memory_mod.note_window_bank(id(self), self.state_bytes())

    def to_device(self, device) -> None:
        """Re-place the live tensors on ``device`` (the partition runtime's
        migration move); a device-to-device copy, no host round trip."""
        device = torch.device(device)
        if device == self.device:
            return
        self.ids, self.accs, self.counts, self.wm = (
            t.to(device) for t in (self.ids, self.accs, self.counts, self.wm)
        )
        self.device = device

    def full_rows(self) -> np.ndarray:
        """Every live entry as host rows [[id, acc, count], ...]: the
        resync payload (consumer attach / emit-capacity overflow)."""
        return self._live_rows().astype(np.int64, copy=False)


def merge_banks(
    ops, a: WindowStateBank, b: WindowStateBank,
    out: Optional[WindowStateBank] = None,
) -> WindowStateBank:
    """Associative combine of two banks (striped/sharded ingest): ``out``
    (default: a fresh bank on ``a``'s device) receives the merged entries
    and the larger watermark. Split ingest + merge equals one-stream
    ingest, bit for bit. ``ops`` is the spec's `WindowEagerOps`."""
    header, ids, accs, counts = ops.merge(a.arrays(), b.arrays())
    n_open, wm, overflow = header.cpu().tolist()
    if overflow:
        raise WindowCapacityError(f"bank merge overflows capacity {a.spec.capacity}")
    if out is None:
        out = WindowStateBank(a.spec, device=a.device)
    out.commit(ids, accs, counts, header[1], n_open, wm)
    return out
