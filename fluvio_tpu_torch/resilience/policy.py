"""Recovery policy: fault classification, bounded retry with exponential
backoff and jitter, and the per-segment circuit breaker.

The port's counterpart of ``fluvio_tpu/resilience/policy.py``. The
classifier splits failures into three classes, in the card's vocabulary:

- **transient**: errors a clean re-run can plausibly clear
  (`torch.cuda.OutOfMemoryError`, a ``CUDA out of memory`` message,
  `ConnectionError`, `TimeoutError`, other `OSError`,
  `InjectedFault(transient=True)`). They are retried under `RetryPolicy`
  with the batch's carries restored before every attempt.
- **fatal**: a sticky CUDA context error ("illegal memory access",
  "device-side assert triggered", "unspecified launch failure", ...).
  After one, every later CUDA call of the process fails, so it is never
  retried, never re-run and never dead-lettered: it propagates and the
  stream ends with it. (Quarantining it would empty every later batch
  into a bounded directory that evicts its oldest entries.)
- **deterministic**: anything else (a lowering bug, malformed data,
  `InjectedFault(transient=False)`). Retrying cannot help; the batch goes
  straight to the card re-run, and a batch that fails there too is
  quarantined (`deadletter`).

The circuit breaker keeps a flapping card from degrading a stream one
failure at a time: M fused failures inside a sliding window trip the
segment open, and an open breaker skips the fused attempt (the batch goes
straight to the re-run ladder); after a cooldown it half-opens and probe
batches run the fused attempt again, P consecutive probe passes close it,
one probe failure re-opens it.

The budgets are one frozen `ResilienceConfig` (the reference's ``envreg``
defaults; the port reads no environment variable), reached as
``SmartEngine(resilience=...)`` and the SPU's
``SmartEngineConfig.resilience``.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from fluvio_tpu_torch.resilience.faults import InjectedFault
from fluvio_tpu_torch.telemetry import TELEMETRY

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"
FATAL = "fatal"

DEFAULT_DEADLETTER_DIR = "/tmp/fluvio-tpu-deadletter"


@dataclass(frozen=True)
class ResilienceConfig:
    """Retry, breaker and dead-letter budgets (defaults: the reference's
    ``FLUVIO_RETRY_*``, ``FLUVIO_BREAKER_*`` and ``FLUVIO_DEADLETTER_*``)."""

    retry_max: int = 2  # retries after the first attempt
    retry_base_ms: float = 2.0  # first backoff delay
    retry_cap_ms: float = 200.0  # backoff ceiling
    retry_jitter: float = 0.25  # randomized fraction of each delay
    breaker_threshold: int = 5  # failures in the window that trip it open
    breaker_window_s: float = 30.0  # sliding failure window
    breaker_cooldown_s: float = 5.0  # open -> half-open delay
    breaker_probes: int = 2  # half-open passes that close it again
    deadletter_dir: str = DEFAULT_DEADLETTER_DIR  # quarantined-batch directory
    deadletter_max: int = 64  # entries kept (the oldest are evicted)


DEFAULT_RESILIENCE = ResilienceConfig()

# substrings of a CUDA error that poisons the process's context: every
# later CUDA call fails after one (cudaErrorIllegalAddress, the
# device-side assert, cudaErrorLaunchFailure and their kin)
_STICKY_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "invalid program counter",
    "hardware stack error",
    "uncorrectable ECC error",
    "launch timed out",
)
_TRANSIENT_MARKERS = ("out of memory",)


def classify(exc: BaseException) -> str:
    """``transient`` | ``deterministic`` | ``fatal`` for a fused failure."""
    if isinstance(exc, InjectedFault):
        return TRANSIENT if exc.transient else DETERMINISTIC
    msg = str(exc)
    if any(m in msg for m in _STICKY_MARKERS):
        return FATAL
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return TRANSIENT
    if isinstance(exc, RuntimeError) and any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC


def is_fatal(exc: BaseException) -> bool:
    return classify(exc) == FATAL


def is_oom(exc: BaseException) -> bool:
    """A card allocation failure: the allocator's cache is freed before
    its retry."""
    return isinstance(exc, torch.cuda.OutOfMemoryError) or (
        isinstance(exc, RuntimeError) and "out of memory" in str(exc))


class RetryPolicy:
    """Bounded retry with exponential backoff and jitter, on ``config``'s
    budget."""

    def __init__(self, config: ResilienceConfig = DEFAULT_RESILIENCE):
        self.max_retries = config.retry_max
        self.base_ms = config.retry_base_ms
        self.cap_ms = config.retry_cap_ms
        self.jitter = config.retry_jitter
        self._rng = random.Random()

    def should_retry(self, exc: BaseException, attempt: int) -> bool:
        """``attempt`` counts retries already taken (0 before the first)."""
        return attempt < self.max_retries and classify(exc) == TRANSIENT

    def backoff_s(self, attempt: int) -> float:
        d = min(self.cap_ms, self.base_ms * (2.0 ** attempt))
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d / 1000.0

    def sleep(self, attempt: int) -> None:
        time.sleep(self.backoff_s(attempt))


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_BREAKER_SEQ = [0]


class CircuitBreaker:
    """A card segment's fused-attempt circuit breaker.

    States: ``closed`` (the fused attempt runs) -> ``open`` (every batch
    goes straight to the re-run ladder) -> ``half_open`` (probe batches
    run the fused attempt) -> ``closed`` again after P probe passes, or
    back to ``open`` on a probe failure. A chain processes one input at a
    time, so no lock.

    ``clock`` is injectable for tests; transitions report to the
    telemetry's ``breaker`` family under this breaker's ``name``
    (``chain-<n>``, numbered in creation order, as the reference names
    its breakers)."""

    def __init__(
        self,
        config: ResilienceConfig = DEFAULT_RESILIENCE,
        name: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.threshold = config.breaker_threshold
        self.window_s = config.breaker_window_s
        self.cooldown_s = config.breaker_cooldown_s
        self.probes = config.breaker_probes
        if name is None:
            _BREAKER_SEQ[0] += 1
            name = f"chain-{_BREAKER_SEQ[0]}"
        self.name = name
        self.clock = clock
        self.state = CLOSED
        self._failures: deque = deque()
        self._opened_at = 0.0
        self._probe_passes = 0
        TELEMETRY.record_breaker(self.name, CLOSED, transition=False)

    def _transition(self, state: str) -> None:
        self.state = state
        TELEMETRY.record_breaker(self.name, state)

    def allow_fused(self) -> bool:
        """Gate one batch's fused attempt; called before every attempt."""
        if self.state == OPEN:
            if self.clock() - self._opened_at >= self.cooldown_s:
                self._probe_passes = 0
                self._transition(HALF_OPEN)
                return True
            return False
        return True

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self._probe_passes += 1
            if self._probe_passes >= self.probes:
                self._failures.clear()
                self._transition(CLOSED)
        elif self._failures:
            # a closed breaker under mixed traffic: expire stale failures
            # so intermittent noise never accumulates to a trip
            self._expire()

    def record_failure(self) -> None:
        now = self.clock()
        if self.state == HALF_OPEN:
            self._opened_at = now
            self._transition(OPEN)
            return
        if self.state == OPEN:  # an open breaker makes no fused attempt
            return
        self._failures.append(now)
        self._expire(now)
        if len(self._failures) >= self.threshold:
            self._opened_at = now
            self._failures.clear()
            self._transition(OPEN)

    def _expire(self, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        while self._failures and now - self._failures[0] > self.window_s:
            self._failures.popleft()
