"""Window specifications for the windowed-state engine.

The port's copy of ``fluvio_tpu/windows/spec.py``. One `WindowSpec` fixes
everything the update needs statically: the window geometry (tumbling
when ``slide_ms == window_ms``, sliding when it divides it), the combine
monoid, whether records carry a per-key segment id, the allowed lateness,
and the two device capacities (state-bank entries and per-batch emit
rows). The port reads no environment variable: an unset lateness or
capacity takes the reference registry's default, which stands here as a
constant, and ``delta_only`` is an argument.
"""

from __future__ import annotations

from dataclasses import dataclass

# composite segment id: id = key * KEY_STRIDE + window_index. The window
# index is ts // slide_ms, so keys up to 2^31 and window indices up to 2^31
# pack into one sortable int64: one sort orders (key, window) pairs. Past
# 2^31 windows the packing aliases (ROADMAP.md §3); the port follows it.
KEY_STRIDE = 1 << 31
# sentinel id for unused bank slots / invalid rows: larger than any real
# composite id, so empties sort to the tail and one compaction drops them
EMPTY_ID = 1 << 62

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1
OP_NEUTRAL = {"add": 0, "max": INT64_MIN, "min": INT64_MAX}

# AggregateProgram kind -> combine monoid (the windowed-sum model's
# vocabulary; models/windowed_aggregate.py)
KIND_TO_OP = {"sum_int": "add", "max_int": "max", "min_int": "min"}

# the reference registry's defaults (FLUVIO_WINDOW_LATENESS_MS,
# FLUVIO_WINDOW_CAPACITY, FLUVIO_WINDOW_EMIT, FLUVIO_WINDOW_DELTA)
DEFAULT_LATENESS_MS = 0
DEFAULT_CAPACITY = 1024
DEFAULT_EMIT_CAPACITY = 1024
DEFAULT_DELTA_ONLY = True


class WindowCapacityError(RuntimeError):
    """Live (open) windows exceed the device bank capacity, or one batch
    closes more windows than the emit columns hold: raise the spec's
    capacity or close windows faster (smaller lateness). Loud at the seam
    by design: silently dropping a window would corrupt every exactness
    pin after it."""


@dataclass(frozen=True)
class WindowSpec:
    """Static geometry of one windowed-state stream."""

    window_ms: int
    slide_ms: int = 0  # 0 -> tumbling (slide == window)
    op: str = "add"
    keyed: bool = False
    lateness_ms: int = -1  # -1 -> DEFAULT_LATENESS_MS
    capacity: int = 0  # 0 -> DEFAULT_CAPACITY
    emit_capacity: int = 0  # 0 -> DEFAULT_EMIT_CAPACITY
    delta_only: bool = DEFAULT_DELTA_ONLY

    def __post_init__(self):
        if self.window_ms <= 0:
            raise ValueError("window_ms must be positive")
        slide = self.slide_ms or self.window_ms
        if slide <= 0 or self.window_ms % slide:
            raise ValueError(
                f"slide_ms ({slide}) must divide window_ms ({self.window_ms})"
            )
        if self.op not in OP_NEUTRAL:
            raise ValueError(f"unknown combine op {self.op!r}")
        object.__setattr__(self, "slide_ms", slide)
        if self.lateness_ms < 0:
            object.__setattr__(self, "lateness_ms", DEFAULT_LATENESS_MS)
        if self.capacity <= 0:
            object.__setattr__(self, "capacity", DEFAULT_CAPACITY)
        if self.emit_capacity <= 0:
            object.__setattr__(self, "emit_capacity", DEFAULT_EMIT_CAPACITY)

    @property
    def fanout(self) -> int:
        """Windows each record belongs to (1 for tumbling)."""
        return self.window_ms // self.slide_ms

    @property
    def tumbling(self) -> bool:
        return self.slide_ms == self.window_ms

    @property
    def neutral(self) -> int:
        return OP_NEUTRAL[self.op]

    @property
    def mode(self) -> str:
        base = "tumbling" if self.tumbling else "sliding"
        return f"{base}+keyed" if self.keyed else base

    def win_start(self, win_idx: int) -> int:
        return win_idx * self.slide_ms

    def describe(self) -> str:
        return (
            f"window[{self.mode} w={self.window_ms} s={self.slide_ms} "
            f"op={self.op} K={self.capacity} E={self.emit_capacity}]"
        )

    @classmethod
    def from_params(cls, kind: str, window_ms, slide_ms=0, keyed=False,
                    delta_only: bool = DEFAULT_DELTA_ONLY):
        """Spec from the windowed-aggregate model's param vocabulary."""
        op = KIND_TO_OP.get(str(kind))
        if op is None:
            raise ValueError(f"unknown windowed kind {kind!r}")
        return cls(
            window_ms=int(window_ms),
            slide_ms=int(slide_ms or 0),
            op=op,
            keyed=bool(keyed),
            delta_only=bool(delta_only),
        )


def delta_enabled() -> bool:
    """Delta-only emission (the default) vs full-state emission every
    batch. The reference reads ``FLUVIO_WINDOW_DELTA`` here; the port reads
    no environment, so this is the registry default, and a caller who wants
    full-state emission builds the spec with ``delta_only=False``."""
    return DEFAULT_DELTA_ONLY
