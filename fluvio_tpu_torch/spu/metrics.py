"""Broker metrics (the port's copy of ``fluvio_tpu/spu/metrics.py``;
parity: fluvio-spu/src/core/metrics.rs).

Inbound and outbound record and byte counters and the chains'
`SmartModuleChainMetrics`, plus the host milliseconds of each served
slice by phase (``slice_phases``: the storage ``read``, the consume
path's decompress, decode, stage, dispatch, finish and encode, then the
response's ``push`` and the consumer's ``ack_wait``), the newest 4,096
slices. ``to_dict`` adds the pipeline telemetry's snapshot under
``telemetry`` (the monitoring socket's ``json`` mode) unless asked not to.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field

from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics

SLICE_PHASES_KEPT = 4096


@dataclass
class RecordCounter:
    records: int = 0
    bytes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, records: int, nbytes: int) -> None:
        with self._lock:
            self.records += records
            self.bytes += nbytes

    def to_dict(self) -> dict:
        # under the lock: records and bytes advance together in add()
        with self._lock:
            return {"records": self.records, "bytes": self.bytes}


@dataclass
class SpuMetrics:
    inbound: RecordCounter = field(default_factory=RecordCounter)
    outbound: RecordCounter = field(default_factory=RecordCounter)
    smartmodule: SmartModuleChainMetrics = field(default_factory=SmartModuleChainMetrics)
    slice_phases: deque = field(default_factory=lambda: deque(maxlen=SLICE_PHASES_KEPT))

    def to_dict(self, include_telemetry: bool = True) -> dict:
        out = {
            "inbound": self.inbound.to_dict(),
            "outbound": self.outbound.to_dict(),
            "smartmodule": self.smartmodule.to_dict(),
        }
        if include_telemetry:
            from fluvio_tpu_torch.telemetry import TELEMETRY

            # per-phase latency histograms, batch latency by path, the
            # counters; the Prometheus renderer reads the registry itself
            out["telemetry"] = TELEMETRY.snapshot()
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
