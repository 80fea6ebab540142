"""Admission control: the front door between the SPU slice path and the
executor.

The port's counterpart of ``fluvio_tpu/admission/``, module for module and
name for name. Four cooperating pieces:

- `warmup`     — shape-bucket warm-up: the chain's buckets x the kernels
                 its stages launch, paid through the real dispatch path
                 before serving (the serve-time gate);
- `controller` — backpressure/load-shedding keyed on the SLO verdicts:
                 token/credit admission per chain, warn sheds
                 probabilistically, breach sheds hard with a typed
                 `Rejected` decline;
- `fairness`   — weighted round-robin over bounded per-chain queues,
                 with the build-storm detector as the weight-penalty
                 trip signal;
- `batcher`    — adaptive shape-bucket batching: coalesce admitted
                 slices across tenants into the warmed buckets, dispatch
                 at bucket-full or deadline, never a cold bucket, never a
                 premature half-full dispatch.

The port reads no environment variable: the settings are one
`AdmissionConfig` (the JAX package's defaults), applied with
`configure(cfg)` (or an SPU's ``SpuConfig.admission``); `set_gate`
installs a specific controller. Disarmed (the default), the broker seam
resolves to None once and costs nothing.
"""

from fluvio_tpu_torch.admission.batcher import (
    Flush,
    ShapeBucketBatcher,
    coalesce_buffers,
    split_output,
)
from fluvio_tpu_torch.admission.controller import (
    AdmissionController,
    AdmissionPipeline,
    TokenBucket,
    admission_enabled,
    configure,
    gate,
    reset_gate,
    set_gate,
)
from fluvio_tpu_torch.admission.fairness import FairQueue
from fluvio_tpu_torch.admission.types import (
    SHED_REASONS,
    AdmissionConfig,
    Decision,
    Rejected,
)
from fluvio_tpu_torch.admission.warmup import (
    WarmupReport,
    default_rows,
    default_widths,
    probe_like,
    reset_warm_registry,
    warm_buffer,
    warm_entries,
    warm_executor,
    warm_specs,
    warmup_enabled,
    work_list,
)

__all__ = [
    "AdmissionController",
    "AdmissionPipeline",
    "Decision",
    "FairQueue",
    "Flush",
    "Rejected",
    "SHED_REASONS",
    "ShapeBucketBatcher",
    "TokenBucket",
    "WarmupReport",
    "admission_enabled",
    "coalesce_buffers",
    "default_rows",
    "default_widths",
    "gate",
    "probe_like",
    "reset_gate",
    "set_gate",
    "reset_warm_registry",
    "split_output",
    "warm_buffer",
    "warm_entries",
    "warm_executor",
    "warm_specs",
    "warmup_enabled",
    "work_list",
    # the port's own: the settings that replace the environment
    "AdmissionConfig",
    "configure",
]
