"""Log-bucketed latency histogram (HDR-style, fixed bucket array).

The port's copy of ``fluvio_tpu/telemetry/histogram.py``.

The bucket boundaries are a FIXED geometric ladder shared by every
instance, so histograms merge by adding count arrays — no rebinning,
no per-instance configuration to disagree about. Recording is one
`bisect` on a precomputed tuple plus two integer adds: cheap enough to
stay always-on at one observation per phase per batch.

Boundaries: 1 µs ·  2^(k/2) for k = 0..55 — covering ~1 µs to ~190 s
with ≤ 41% relative bucket width (quantile error ≤ ~20%), 57 counters
total including the underflow and overflow (+Inf) buckets.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Optional

# upper bounds (seconds) of the finite buckets; observations above the
# last bound land in the +Inf overflow bucket
_BASE = 1e-6
_RATIO = 2.0 ** 0.5
_N_FINITE = 56
BUCKET_BOUNDS: tuple = tuple(_BASE * _RATIO**k for k in range(_N_FINITE))
N_BUCKETS = _N_FINITE + 1  # + overflow


class LatencyHistogram:
    """Mergeable fixed-bucket histogram over seconds."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        self.counts[bisect_right(BUCKET_BOUNDS, seconds)] += 1
        self.count += 1
        self.sum += seconds
        if self.min is None or seconds < self.min:
            self.min = seconds
        if self.max is None or seconds > self.max:
            self.max = seconds

    # -- merge / diff --------------------------------------------------------

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Accumulate ``other`` into self (same fixed bounds by
        construction). Returns self for chaining."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for v in (other.min, other.max):
            if v is None:
                continue
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
        return self

    def copy(self) -> "LatencyHistogram":
        h = LatencyHistogram()
        h.counts = list(self.counts)
        h.count = self.count
        h.sum = self.sum
        h.min = self.min
        h.max = self.max
        return h

    def diff(self, earlier: "LatencyHistogram") -> "LatencyHistogram":
        """Observations recorded since ``earlier`` (a prior `copy` of
        this histogram) — counters are monotone, so a plain subtraction
        is exact. min/max cannot be un-merged; the diff reports None."""
        h = LatencyHistogram()
        h.counts = [a - b for a, b in zip(self.counts, earlier.counts)]
        h.count = self.count - earlier.count
        h.sum = self.sum - earlier.sum
        return h

    # -- quantiles -----------------------------------------------------------

    def percentile(self, p: float) -> float:
        """p in [0, 100]; linear interpolation inside the landing bucket
        (0 for an empty histogram). The overflow bucket reports its
        lower bound — an honest floor, not an invented value."""
        if self.count == 0:
            return 0.0
        rank = (p / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = 0.0 if i == 0 else BUCKET_BOUNDS[i - 1]
                if i >= len(BUCKET_BOUNDS):
                    return BUCKET_BOUNDS[-1]
                hi = BUCKET_BOUNDS[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return BUCKET_BOUNDS[-1]  # pragma: no cover — rank <= count

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # -- export --------------------------------------------------------------

    def to_dict(self) -> dict:
        """Snapshot for the JSON surfaces: summary stats always, the raw
        count array only when non-empty (scrapes of idle processes stay
        small)."""
        d = {
            "count": self.count,
            "sum_s": round(self.sum, 6),
            "p50_ms": round(self.percentile(50) * 1000, 3),
            "p90_ms": round(self.percentile(90) * 1000, 3),
            "p99_ms": round(self.percentile(99) * 1000, 3),
        }
        if self.min is not None:
            d["min_ms"] = round(self.min * 1000, 3)
            d["max_ms"] = round(self.max * 1000, 3)
        return d

    def cumulative_buckets(self) -> List[tuple]:
        """(upper_bound_or_None, cumulative_count) pairs for Prometheus
        exposition (None = +Inf). Empty leading buckets are elided to
        keep the text surface compact; the +Inf bucket always emits."""
        out = []
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            bound = BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else None
            if c or bound is None:
                out.append((bound, cum))
        return out
