"""Chain execution metrics.

The port's copy of ``fluvio_tpu/smartengine/metrics.py`` (parity:
fluvio-smartengine/src/engine/metrics.rs): bytes in, records out,
invocations and fuel (records processed times the chain's stages), and
the consume path's record of slices that ran coalesced on the card
(``fastpath_slices``) or were declined to the per-batch path
(``fallback_slices``, counted by reason).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field


@dataclass
class SmartModuleChainMetrics:
    bytes_in: int = 0
    records_out: int = 0
    invocation_count: int = 0
    fuel_used: int = 0
    fastpath_slices: int = 0
    fallback_slices: int = 0
    fallback_reasons: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add_bytes_in(self, n: int) -> None:
        with self._lock:
            self.bytes_in += n
            self.invocation_count += 1

    def add_records_out(self, n: int) -> None:
        with self._lock:
            self.records_out += n

    def add_fuel_used(self, n: int) -> None:
        with self._lock:
            self.fuel_used += n

    def add_fastpath(self) -> None:
        with self._lock:
            self.fastpath_slices += 1

    def add_fallback(self, reason: str) -> None:
        with self._lock:
            self.fallback_slices += 1
            self.fallback_reasons[reason] = self.fallback_reasons.get(reason, 0) + 1

    def to_dict(self) -> dict:
        # one snapshot under the lock: a reader never sees a torn update
        with self._lock:
            return {
                "bytes_in": self.bytes_in,
                "records_out": self.records_out,
                "invocation_count": self.invocation_count,
                "fuel_used": self.fuel_used,
                "fastpath_slices": self.fastpath_slices,
                "fallback_slices": self.fallback_slices,
                "fallback_reasons": dict(self.fallback_reasons),
            }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
