"""Resilience layer: fault injection, recovery policy, dead-lettering.

The port's counterpart of ``fluvio_tpu/resilience/``. Three pieces, used
by the executor's, the engine's, the consume path's and the windowed
runtime's seams:

- :mod:`fluvio_tpu_torch.resilience.faults`: the process-global
  fault-point registry (`faults.FAULTS.inject`), whose `faults.maybe_fire`
  calls sit at every failure seam the recovery layer guards;
- :mod:`fluvio_tpu_torch.resilience.policy`: transient / deterministic /
  fatal classification, bounded retry with exponential backoff and
  jitter, the per-segment circuit breaker, and `ResilienceConfig`, their
  budgets;
- :mod:`fluvio_tpu_torch.resilience.deadletter`: the bounded on-disk
  quarantine for batches whose fused attempt and card re-run both fail.

The ladder: a transient failure retries the same kernels from the batch's
starting carries; a batch that still fails (or a deterministic failure,
or an open breaker) is re-run on the card under `RetryPolicy`; a batch
whose re-run fails too is quarantined and the stream advances. A fatal
failure (a sticky CUDA context error) propagates. Nothing gives way to
another execution path.
"""

from fluvio_tpu_torch.resilience.faults import (  # noqa: F401
    FAULT_POINTS,
    FAULTS,
    FaultRegistry,
    InjectedFault,
    maybe_fire,
)
from fluvio_tpu_torch.resilience.policy import (  # noqa: F401
    CLOSED,
    DETERMINISTIC,
    FATAL,
    HALF_OPEN,
    OPEN,
    TRANSIENT,
    CircuitBreaker,
    ResilienceConfig,
    RetryPolicy,
    classify,
)
from fluvio_tpu_torch.resilience.deadletter import (  # noqa: F401
    load_entry,
    quarantine_batch,
)
