"""Host-truth reference for the windowed-state engine.

The port's copy of ``fluvio_tpu/windows/reference.py``, so that
``chip_smoke.py`` and the card tests have host truth without the JAX
package.

Plain-python re-implementation of EXACTLY the device kernel's batch
semantics — same late rule (vs the PRE-batch watermark), same close rule
(vs the POST-batch watermark), same composite ids, same integer monoids
— so tests and the bench can pin bit-equality across batch boundaries,
faults, and migrations. Deliberately record-at-a-time and dict-backed:
slow, obvious, and independent of every array trick the kernel plays.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from fluvio_tpu_torch.windows.spec import INT64_MIN, KEY_STRIDE, WindowSpec


class HostWindowReference:
    """The oracle: fold batches on the host, expose the same table
    shape as `MaterializedView.table()`."""

    def __init__(self, spec: WindowSpec):
        self.spec = spec
        self.open: Dict[int, Tuple[int, int]] = {}  # id -> (acc, count)
        self.closed: Dict[int, Tuple[int, int]] = {}
        self.watermark = INT64_MIN + 1  # matches the bank's seed
        self.late = 0
        self.invalid = 0  # keys outside the composite-id packing range

    def _fold(self, composite: int, contrib: int) -> None:
        acc, cnt = self.open.get(composite, (self.spec.neutral, 0))
        if self.spec.op == "add":
            acc += contrib
        elif self.spec.op == "max":
            acc = max(acc, contrib)
        else:
            acc = min(acc, contrib)
        self.open[composite] = (acc, cnt + 1)

    def process_batch(
        self,
        records: Iterable[Tuple[int, int, int]],
    ) -> Dict[str, int]:
        """Fold one batch of ``(key, contrib, ts)`` rows (key 0 for
        unkeyed streams). Returns the batch's counts for pinning the
        engine header: {closed, late, invalid, watermark}."""
        spec = self.spec
        pre_wm = self.watermark
        batch_max = INT64_MIN + 1
        late = 0
        invalid = 0
        for key, contrib, ts in records:
            if key < 0 or key >= KEY_STRIDE:
                # kernel rule: a key outside [0, KEY_STRIDE) would alias
                # in the composite-id packing — dropped entirely, not
                # even advancing the watermark
                invalid += 1
                continue
            batch_max = max(batch_max, ts)
            base_idx = ts // spec.slide_ms
            for j in range(spec.fanout):
                win_idx = base_idx - j
                if win_idx < 0:
                    continue
                win_end = win_idx * spec.slide_ms + spec.window_ms
                if win_end + spec.lateness_ms <= pre_wm:
                    late += 1
                    continue
                self._fold(key * KEY_STRIDE + win_idx, contrib)
        new_wm = max(pre_wm, batch_max)
        n_closed = 0
        for composite in sorted(self.open):
            win_idx = composite % KEY_STRIDE
            win_end = win_idx * spec.slide_ms + spec.window_ms
            if win_end + spec.lateness_ms <= new_wm:
                self.closed[composite] = self.open.pop(composite)
                n_closed += 1
        self.watermark = new_wm
        self.late += late
        self.invalid += invalid
        return {
            "closed": n_closed,
            "late": late,
            "invalid": invalid,
            "watermark": new_wm,
        }

    # -- pin surfaces --------------------------------------------------------

    def table(self) -> Dict[Tuple[int, int], Tuple[int, int, str]]:
        """Same shape as `MaterializedView.table()` — the equality pin."""
        out = {}
        for table, status in ((self.closed, "closed"), (self.open, "open")):
            for composite, (acc, cnt) in table.items():
                key, win_idx = divmod(composite, KEY_STRIDE)
                out[(key, win_idx * self.spec.slide_ms)] = (acc, cnt, status)
        return out

    def bank_entries(self) -> Tuple[list, int]:
        """Open entries in the bank's snapshot tuple format
        ([(id, acc, count), ...] sorted by id, watermark) — pins the
        device bank's carry bit-for-bit (the bank compacts in id order
        because the merge argsorts)."""
        entries = [
            (composite, acc, cnt)
            for composite, (acc, cnt) in sorted(self.open.items())
        ]
        return entries, self.watermark


def parse_keyed_record(raw: bytes) -> Tuple[int, int]:
    """Host mirror of `kernels.parse_two_ints` for "<key> <value>"
    records: leading ASCII int, then the int after the first space
    (0 when absent)."""
    key = _leading_int(raw)
    sp = raw.find(b" ")
    value = _leading_int(raw[sp + 1:]) if sp >= 0 else 0
    return key, value


def _leading_int(raw: bytes) -> int:
    """parse_int's host semantics: skip leading whitespace, read
    digits, stop at the first non-digit; 0 when none."""
    i = 0
    while i < len(raw) and raw[i:i + 1].isspace():
        i += 1
    j = i
    while j < len(raw) and raw[j:j + 1].isdigit():
        j += 1
    return int(raw[i:j]) if j > i else 0
