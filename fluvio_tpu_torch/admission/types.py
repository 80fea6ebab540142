"""Typed admission decisions and the admission settings.

The port's copy of ``fluvio_tpu/admission/types.py``. The admission
controller never raises into the serving path: every outcome is a value.
``Decision`` (truthy) admits; ``Rejected`` — a `Decision` subclass so
callers can isinstance-dispatch OR truth-test — is the typed decline the
broker turns into backpressure (hold the slice, retry after
``retry_after_s``), and the pipeline's exactly-once accounting turns into
a resubmit. Reasons use one stable vocabulary, shared with the
``TELEMETRY.admission`` counter family and the Prometheus
``admission_decisions_total`` export:

==================  ======================================================
``admit``           admitted (token charged)
``breach-shed``     chain (or engine queue/memory rule) verdict is breach
``warn-shed``       probabilistic shed under a warn verdict
``no-tokens``       per-chain token bucket empty (credit exhausted)
``queue-full``      the chain's bounded admission queue is at capacity
``breaker-open``    the chain's circuit breaker is open (the port has no
                    breakers yet, so it never arises)
``cold-chain``      warm-up required (serve gate) and the chain's shape
                    buckets have not been warmed yet
==================  ======================================================

The JAX package reads its admission knobs from the environment; the port
reads none. Every knob is a field of `AdmissionConfig`, whose defaults
are that package's, applied to the process with `configure` (or an SPU's
``SpuConfig.admission``). The process starts disarmed, as the JAX default
does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AdmissionConfig:
    """Every admission setting, one field each, in place of the JAX
    package's environment variables (named beside each field)."""

    enabled: bool = False  # FLUVIO_ADMISSION: master arm
    refresh_s: float = 1.0  # FLUVIO_ADMISSION_REFRESH_S: verdict cache lifetime
    warn_shed: float = 0.5  # FLUVIO_ADMISSION_WARN_SHED: shed probability on warn
    tokens: float = 64.0  # FLUVIO_ADMISSION_TOKENS: per-chain bucket capacity
    refill: float = 32.0  # FLUVIO_ADMISSION_REFILL: tokens/s at ok health
    queue: int = 64  # FLUVIO_ADMISSION_QUEUE: per-chain queue bound
    batch_rows: int = 4096  # FLUVIO_ADMISSION_BATCH_ROWS: batcher row target
    batch_deadline_ms: float = 25.0  # FLUVIO_ADMISSION_BATCH_DEADLINE_MS
    warmup: bool = False  # FLUVIO_ADMISSION_WARMUP: serve-gate warm-up
    # FLUVIO_WARMUP_WIDTHS / FLUVIO_WARMUP_ROWS: the probe grid (empty: one
    # narrow width and one past the stripe threshold; 8 rows)
    warmup_widths: Tuple[int, ...] = ()
    warmup_rows: Tuple[int, ...] = ()


_CONFIG = AdmissionConfig()
_CONFIG_LOCK = threading.Lock()


def current_config() -> AdmissionConfig:
    """The process's admission settings (`configure` sets them)."""
    return _CONFIG


def set_config(config: AdmissionConfig) -> None:
    global _CONFIG
    with _CONFIG_LOCK:
        _CONFIG = config


@dataclass(frozen=True)
class Decision:
    """One admission decision for one chain's slice."""

    admitted: bool
    chain: str = ""
    reason: str = "admit"
    verdict: str = "ok"  # the health verdict that drove the decision
    retry_after_s: float = 0.0  # backpressure hint (sheds only)

    def __bool__(self) -> bool:
        return self.admitted


@dataclass(frozen=True)
class Rejected(Decision):
    """Typed decline — never an exception into the client. The broker
    holds the slice (offsets do not advance, so nothing is lost or
    duplicated) and retries after ``retry_after_s``."""

    admitted: bool = False


SHED_REASONS = (
    "breach-shed", "warn-shed", "no-tokens", "queue-full",
    "breaker-open", "cold-chain",
)
