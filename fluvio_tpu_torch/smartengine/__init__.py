"""SmartEngine of the GPU port: DSL chains lowered to torch code and
hand-written CUDA kernels over the batched record buffer."""

from fluvio_tpu_torch.smartengine.config import SmartModuleConfig
from fluvio_tpu_torch.smartengine.engine import (
    EngineError,
    SmartEngine,
    SmartModuleChainBuilder,
)
from fluvio_tpu_torch.smartengine.gpu.executor import GpuSpill
from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams

__all__ = [
    "EngineError",
    "GpuSpill",
    "LinkParams",
    "SmartEngine",
    "SmartModuleChainBuilder",
    "SmartModuleConfig",
    "StripeParams",
]
