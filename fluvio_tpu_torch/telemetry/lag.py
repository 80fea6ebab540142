"""Streaming consumer-lag / record-age engine.

The port's copy of ``fluvio_tpu/telemetry/lag.py``: the SPU's stream
handler and the partition runtime register their keys, commits and
served slices here, as the JAX package's do.

The canonical health signal of a Kafka-class platform is **consumer lag
and end-to-end record age** — yet until this module the two halves
lived on opposite sides of the broker: committed consumer offsets in
`partition.runtime.PartitionOffsets` / the stream handler's ack bus,
and the replica high watermark in `storage.replica.FileReplica`. The
:class:`LagEngine` is the join:

- **track**: every serving stream (and every partition-runtime
  consumer) registers its ``chain@topic/partition`` key with a weakref
  to its leader replica (anything exposing ``hw()``/``leo()``),
- **note_commit**: the consumer's acked offset moves the committed
  cursor (monotone),
- **note_serve**: each served slice books its record count and ONE
  end-to-end record-age observation (append wall-time -> served) into
  the registry's ``record_age`` histogram family,
- **sample**: the pull-join — ``lag = high watermark - committed`` per
  key, written into the registry's ``consumer_lag`` gauge family. The
  time-series tick and the Prometheus scrape both call it (via
  ``PipelineTelemetry.refresh_lag``), so lag keeps MOVING while a
  breached partition is fully shed and nothing is serving — exactly
  when the ``consumer_lag`` SLO rule must see it grow, and exactly how
  it ages back out after the backlog drains.

The SLO rules ``consumer_lag`` / ``record_age_p99`` (telemetry/slo.py)
window these families per key, and the admission controller's verdict
cache keys on the same ``chain@topic/partition`` identity — so a lag
breach sheds exactly the hot partition, closing the streaming control
loop.

Zero-cost contract: every entry point is one ``TELEMETRY.enabled``
check when capture is off; nothing here runs per record, and the join
runs only when a reader (tick/scrape/socket/CLI) shows up.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, Optional

from fluvio_tpu_torch.telemetry.registry import TELEMETRY, PipelineTelemetry

#: the SLO rule families this engine feeds (the lag CLI's breach gate
#: and the socket ``lag`` document filter on exactly these)
LAG_RULES = ("consumer_lag", "record_age_p99")


def _offset_of(leader, name: str) -> Optional[int]:
    fn = getattr(leader, name, None)
    if not callable(fn):
        return None
    try:
        return int(fn())
    except Exception:  # noqa: BLE001 — a torn-down replica must not raise
        return None


class LagEngine:
    """Joins committed consumer offsets against replica high watermarks
    into per-``chain@topic/partition`` lag gauges."""

    def __init__(
        self, telemetry: Optional[PipelineTelemetry] = None
    ) -> None:
        self.telemetry = telemetry if telemetry is not None else TELEMETRY
        self._lock = threading.Lock()
        # key -> zero-arg leader resolver (weakref when possible so a
        # closed stream's replica can be collected; strong closure for
        # un-weakref-able stand-ins in tests/bench)
        self._leaders: Dict[str, object] = {}
        self._committed: Dict[str, int] = {}

    # -- registration / movement ---------------------------------------------

    def track(self, key: str, leader) -> None:
        """Register one serving stream's leader replica under its
        ``chain@topic/partition`` key and install the registry's
        pull-join hook on first use."""
        if not self.telemetry.enabled:
            return
        try:
            ref = weakref.ref(leader)
        except TypeError:
            ref = (lambda obj=leader: obj)
        with self._lock:
            self._leaders.pop(key, None)
            self._leaders[key] = ref
            while len(self._leaders) > 128:
                old = next(iter(self._leaders))
                self._leaders.pop(old)
                self._committed.pop(old, None)
        if self.telemetry.lag_sampler is None:
            self.telemetry.lag_sampler = self.sample

    def untrack(self, key: str) -> None:
        with self._lock:
            self._leaders.pop(key, None)
            self._committed.pop(key, None)
        self.telemetry.clear_consumer_lag(key)

    def note_commit(self, key: str, offset: int) -> None:
        """Move one key's committed consumer offset (monotone — a held
        or shed slice simply never commits)."""
        if not self.telemetry.enabled:
            return
        with self._lock:
            if offset > self._committed.get(key, -1):
                self._committed[key] = int(offset)

    def note_serve(
        self, key: str, records: int, age_s: Optional[float] = None
    ) -> None:
        """One served slice: the record count (windowed served-rate)
        plus one end-to-end record-age observation when the slice
        carried append wall-times."""
        if not self.telemetry.enabled:
            return
        self.telemetry.add_served(key, records)
        if age_s is not None:
            self.telemetry.add_record_age(key, age_s)

    # -- the join ------------------------------------------------------------

    def sample(self) -> None:
        """Re-join every tracked key: lag = high watermark (LEO when no
        HW surface) - committed, written into the registry's
        ``consumer_lag`` family. Dead leader refs unregister."""
        t = self.telemetry
        if not t.enabled:
            return
        with self._lock:
            items = list(self._leaders.items())
            committed = dict(self._committed)
        dead = []
        for key, ref in items:
            leader = ref()
            if leader is None:
                dead.append(key)
                continue
            hw = _offset_of(leader, "hw")
            leo = _offset_of(leader, "leo")
            bound = hw if hw is not None else leo
            if bound is None:
                continue
            t.set_consumer_lag(
                key, max(bound - max(committed.get(key, -1), 0), 0)
            )
        for key in dead:
            self.untrack(key)

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Per-key lag document: committed/hw/leo/lag plus the served
        counters and record-age summary from the registry families —
        the socket ``lag`` mode and ``fluvio-tpu lag`` table rows."""
        with self._lock:
            items = list(self._leaders.items())
            committed = dict(self._committed)
        lag_g, served, ages = self.telemetry.lag_families()
        out: Dict[str, dict] = {}
        keys = sorted(set(k for k, _ in items) | set(lag_g) | set(served))
        leaders = dict(items)
        for key in keys:
            ref = leaders.get(key)
            leader = ref() if ref is not None else None
            hw = _offset_of(leader, "hw") if leader is not None else None
            leo = _offset_of(leader, "leo") if leader is not None else None
            bound = hw if hw is not None else leo
            com = committed.get(key, -1)
            entry: dict = {"committed": com}
            if hw is not None:
                entry["hw"] = hw
            if leo is not None:
                entry["leo"] = leo
            if bound is not None:
                entry["lag"] = max(bound - max(com, 0), 0)
            elif key in lag_g:
                entry["lag"] = int(lag_g[key])
            if key in served:
                entry["served_records"] = served[key]
            age = ages.get(key)
            if age is not None and age.count:
                entry["age_p50_ms"] = round(age.percentile(50) * 1000, 3)
                entry["age_p99_ms"] = round(age.percentile(99) * 1000, 3)
                entry["age_count"] = age.count
            out[key] = entry
        return out

    def reset(self) -> None:
        with self._lock:
            self._leaders = {}
            self._committed = {}


# -- process-global engine (one join for the socket/CLI/SLO surfaces) --------

_ENGINE: Optional[LagEngine] = None
_ENGINE_LOCK = threading.Lock()


def engine() -> LagEngine:
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = LagEngine()
        return _ENGINE


def reset_engine() -> None:
    """Drop the process-global engine AND its registry sampler hook
    (tests re-wire on next use)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is not None:
            _ENGINE.reset()
        _ENGINE = None
    TELEMETRY.lag_sampler = None


# -- broker seams (one enabled check when capture is off) --------------------


def track_stream(key: str, leader) -> None:
    if not TELEMETRY.enabled:
        return
    engine().track(key, leader)


def note_commit(key: str, offset: int) -> None:
    if not TELEMETRY.enabled:
        return
    engine().note_commit(key, offset)


def note_serve(key: str, records: int, age_s: Optional[float] = None) -> None:
    if not TELEMETRY.enabled:
        return
    engine().note_serve(key, records, age_s)


def serve_age_s(first_timestamp_ms: Optional[int]) -> Optional[float]:
    """Record age (seconds) for a slice whose batch header carries an
    append wall-time in ms; None when the producer stamped nothing."""
    if first_timestamp_ms is None or first_timestamp_ms <= 0:
        return None
    return max(time.time() - first_timestamp_ms / 1000.0, 0.0)


# -- the lag document (socket ``lag`` mode / ``fluvio-tpu lag``) -------------


def lag_snapshot() -> dict:
    """Per-partition lag/age table + the lag-rule SLO verdicts from the
    process-global engines. ``verdict`` is the worst lag-rule verdict
    across every key — the ``fluvio-tpu lag`` exit-code gate, symmetric
    with ``health``."""
    if not TELEMETRY.enabled:
        return {"enabled": False, "verdict": "disabled", "partitions": {}}
    from fluvio_tpu_torch.telemetry import slo as slo_mod

    eng = engine()
    eng.sample()
    doc = slo_mod.engine().evaluate()
    verdicts: Dict[str, dict] = {}
    worst = "ok"
    for chain, entry in (doc.get("chains") or {}).items():
        sub = {
            rule: ev.get("verdict", "ok")
            for rule, ev in (entry.get("rules") or {}).items()
            if rule in LAG_RULES
        }
        if sub:
            verdicts[chain] = sub
            worst = slo_mod.worst([worst, *sub.values()])
    out = {
        "enabled": True,
        "verdict": worst,
        "partitions": eng.snapshot(),
        "slo": verdicts,
        "targets": {
            rule: tgt
            for rule, tgt in (doc.get("targets") or {}).items()
            if rule in LAG_RULES
        },
    }
    return out
