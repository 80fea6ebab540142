"""Rolling-window time-series layer over the telemetry registry.

The port's copy of ``fluvio_tpu/telemetry/timeseries.py``; the window
geometry comes from ``TelemetryConfig`` (``slo_window_s``,
``slo_windows``) instead of the environment.

Everything the registry records is cumulative-since-boot (counters, mergeable
histograms) or point-in-time (gauges) — perfect for attribution, useless
for "is this chain healthy *right now*". This module adds the windowed
view WITHOUT a second instrumentation seam: a bounded ring of cumulative
snapshots of the registry (per-chain and per-path latency histograms,
compile histogram, error counters, gauges), captured at fixed window
boundaries, and window deltas computed by the SAME mergeable-histogram
subtraction of `LatencyHistogram.diff` — windowed rate / p50 /
p99 / error-ratio all fall out of diffing two ring entries.

Sampling is PULL-based: nothing here runs per batch. `maybe_tick()`
advances the ring only when a reader (the SLO evaluator, a Prometheus
scrape, the health CLI) shows up and a window boundary has passed, so
the hot-path cost of the whole layer is zero and the disabled-capture
contract is trivially preserved (`maybe_tick` is
one truthiness check when capture is off).

Determinism: the clock is injectable (tests drive a fake clock — no
wall-time sleeps). Each tick past a window boundary appends ONE
snapshot stamped at the latest boundary, so a reader gap yields a
single entry spanning the whole gap — the short window always covers
"everything since I last looked" (a sparse scraper still catches a
fresh burn), rates divide by true durations, and entries age out after
a fixed number of further ticks.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from fluvio_tpu_torch.telemetry.histogram import LatencyHistogram
from fluvio_tpu_torch.telemetry.registry import TELEMETRY, PipelineTelemetry

# window geometry: slo_window_s seconds per window, ring of slo_windows
# windows (defaults: 10 s x 30 = 5 min of history)
DEFAULT_WINDOW_S = 10.0
DEFAULT_WINDOWS = 30


class _Cum:
    """One cumulative registry snapshot stamped at a window boundary."""

    __slots__ = (
        "t", "generation", "chains", "paths", "compile_hist", "counters",
        "gauges", "lag", "served", "record_age",
    )

    def __init__(self, t: float, sample: dict) -> None:
        self.t = t
        self.generation: int = sample.get("generation", 0)
        self.chains: Dict[str, LatencyHistogram] = sample["chains"]
        self.paths: Dict[str, LatencyHistogram] = sample["paths"]
        self.compile_hist: LatencyHistogram = sample["compile_hist"]
        self.counters: Dict[str, float] = sample["counters"]
        self.gauges: Dict[str, float] = sample["gauges"]
        # streaming-lag families: lag is point-in-time per
        # chain@topic/partition, served is monotone, record_age is a
        # mergeable-histogram family like chains/paths
        self.lag: Dict[str, float] = sample.get("lag", {})
        self.served: Dict[str, int] = sample.get("served", {})
        self.record_age: Dict[str, LatencyHistogram] = sample.get(
            "record_age", {}
        )


class WindowDelta:
    """Observations between two ring snapshots (``old`` -> ``new``).

    Histogram deltas are exact (`LatencyHistogram.diff` on monotone
    counters); counter deltas are plain subtraction; gauges report the
    NEW snapshot's point-in-time values (a gauge has no meaningful
    delta — the ceiling rules read the level, not the movement)."""

    def __init__(self, old: _Cum, new: _Cum) -> None:
        self._old = old
        self._new = new
        self.duration_s = max(new.t - old.t, 1e-9)
        self.gauges = dict(new.gauges)
        # consumer lag is a level, not a movement: the lag rules read
        # the NEW snapshot's joined values (like the gauge ceilings)
        self.lag = dict(new.lag)
        self._chain_hists: Optional[Dict[str, LatencyHistogram]] = None
        self._path_hists: Optional[Dict[str, LatencyHistogram]] = None
        self._record_age: Optional[Dict[str, LatencyHistogram]] = None
        self._counters: Optional[Dict[str, float]] = None

    @staticmethod
    def _hist_deltas(
        new: Dict[str, LatencyHistogram], old: Dict[str, LatencyHistogram]
    ) -> Dict[str, LatencyHistogram]:
        out = {}
        empty = LatencyHistogram()
        for key, h in new.items():
            prev = old.get(key, empty)
            if h.count < prev.count:
                # the family restarted between snapshots (the registry's
                # bounded chain map evicted and re-created this chain):
                # a subtraction would go negative, so the honest windowed
                # view is everything since the restart
                d = h.copy()
            else:
                d = h.diff(prev)
            if d.count > 0:
                out[key] = d
        return out

    def chain_hists(self) -> Dict[str, LatencyHistogram]:
        """{chain: e2e delta histogram} — only chains with observations
        in the window (a chain born mid-window diffs against empty; an
        evicted-and-reborn chain reports since its rebirth). Memoized:
        one evaluation reads this several times per rule set."""
        if self._chain_hists is None:
            self._chain_hists = self._hist_deltas(
                self._new.chains, self._old.chains
            )
        return self._chain_hists

    def path_hists(self) -> Dict[str, LatencyHistogram]:
        if self._path_hists is None:
            self._path_hists = self._hist_deltas(
                self._new.paths, self._old.paths
            )
        return self._path_hists

    def record_age_hists(self) -> Dict[str, LatencyHistogram]:
        """{chain@topic/partition: record-age delta histogram} — only
        keys with served observations inside the window (the
        ``record_age_p99`` rule reads this)."""
        if self._record_age is None:
            self._record_age = self._hist_deltas(
                self._new.record_age, self._old.record_age
            )
        return self._record_age

    def served(self) -> Dict[str, float]:
        """{key: records served inside the window} (windowed serve
        rate = served()/duration_s)."""
        return {
            k: v - self._old.served.get(k, 0)
            for k, v in self._new.served.items()
            if v - self._old.served.get(k, 0) > 0
        }

    def compile_hist(self) -> LatencyHistogram:
        return self._new.compile_hist.diff(self._old.compile_hist)

    def counters(self) -> Dict[str, float]:
        if self._counters is None:
            self._counters = {
                k: v - self._old.counters.get(k, 0)
                for k, v in self._new.counters.items()
            }
        return self._counters

    def batches(self) -> int:
        return sum(d.count for d in self.path_hists().values())

    def summary(self) -> dict:
        """JSON-able windowed view (the Prometheus windowed gauges and
        the health document's evidence blocks render from this)."""
        chains = {}
        for chain, d in sorted(self.chain_hists().items()):
            chains[chain] = {
                "count": d.count,
                "rate_per_s": round(d.count / self.duration_s, 3),
                "p50_ms": round(d.percentile(50) * 1000, 3),
                "p99_ms": round(d.percentile(99) * 1000, 3),
            }
        out = {
            "duration_s": round(self.duration_s, 3),
            "chains": chains,
            "paths": {
                p: d.count for p, d in sorted(self.path_hists().items())
            },
            "counters": {
                k: round(v, 6) for k, v in sorted(self.counters().items()) if v
            },
        }
        if self.lag:
            out["lag"] = {k: round(v, 1) for k, v in sorted(self.lag.items())}
        served = self.served()
        if served:
            out["served"] = {
                k: int(v) for k, v in sorted(served.items())
            }
        return out


class TimeSeries:
    """Bounded ring of cumulative snapshots at fixed window boundaries.

    ``capacity`` is the number of WINDOWS retained; the ring holds
    capacity+1 cumulative snapshots so a delta across all retained
    windows has both endpoints."""

    def __init__(
        self,
        telemetry: Optional[PipelineTelemetry] = None,
        window_s: Optional[float] = None,
        capacity: Optional[int] = None,
        clock=time.monotonic,
    ) -> None:
        self.telemetry = telemetry if telemetry is not None else TELEMETRY
        cfg = self.telemetry.config
        self.window_s = float(window_s) if window_s else float(cfg.slo_window_s)
        self.capacity = int(capacity) if capacity else max(int(cfg.slo_windows), 1)
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: List[_Cum] = []

    # -- ticking -------------------------------------------------------------

    def maybe_tick(self) -> int:
        """Advance the ring to the current clock; returns the number of
        window boundaries appended (0 when inside the current window).
        One truthiness check when telemetry capture is off."""
        if not self.telemetry.enabled:
            return 0
        # pull-join the lag + memory gauges OUTSIDE the ring lock (the
        # samplers take their engine + registry locks): one attribute
        # check each when nothing is tracked
        self.telemetry.refresh_lag()
        self.telemetry.refresh_memory()
        now = self.clock()
        with self._lock:
            if not self._ring:
                self._ring.append(_Cum(now, self.telemetry.timeseries_sample()))
                return 0
            last_t = self._ring[-1].t
            n = int((now - last_t) // self.window_s)
            if n <= 0:
                self._check_generation()
                return 0
            # ONE snapshot per advance, stamped at NOW — the instant the
            # registry was actually sampled, so every window delta
            # divides by the true span its observations cover (a
            # boundary-aligned stamp would understate the span by up to
            # one window and overstate rates ~2x). A reader gap
            # therefore produces a single entry spanning the whole gap:
            # the most recent window delta covers everything since the
            # reader last looked (at least window_s wide), so a sparse
            # scraper still sees a fresh burn in its SHORT window — the
            # alerting-correct bias. Aging stays deterministic: entries
            # leave after capacity further ticks of the same clock.
            sample = self.telemetry.timeseries_sample()
            if self._ring and sample.get("generation", 0) != (
                self._ring[-1].generation
            ):
                # the registry was reset mid-history: cumulative
                # counters went backwards, so every retained delta is
                # poisoned — restart the ring from this boundary
                self._ring = []
            self._ring.append(_Cum(now, sample))
            del self._ring[: -(self.capacity + 1)]
            return n

    def _check_generation(self) -> None:
        """Drop a ring whose registry was reset (caller holds the
        lock): one cheap int read against the newest snapshot."""
        if self._ring and self.telemetry._generation != (
            self._ring[-1].generation
        ):
            self._ring = []

    def force_tick(self) -> None:
        """Append a snapshot at the current clock regardless of window
        boundaries (bench run-scoped evaluation + tests)."""
        if not self.telemetry.enabled:
            return
        self.telemetry.refresh_lag()
        self.telemetry.refresh_memory()
        with self._lock:
            sample = self.telemetry.timeseries_sample()
            if self._ring and sample.get("generation", 0) != (
                self._ring[-1].generation
            ):
                self._ring = []
            self._ring.append(_Cum(self.clock(), sample))
            del self._ring[: -(self.capacity + 1)]

    # -- reads ---------------------------------------------------------------

    def delta(self, windows: int = 1) -> Optional[WindowDelta]:
        """Delta over the most recent ``windows`` windows, or None until
        two snapshots exist. Clamped to the retained history."""
        with self._lock:
            if len(self._ring) < 2:
                return None
            k = min(max(int(windows), 1), len(self._ring) - 1)
            old, new = self._ring[-1 - k], self._ring[-1]
        return WindowDelta(old, new)

    def retained_windows(self) -> int:
        with self._lock:
            return max(len(self._ring) - 1, 0)
