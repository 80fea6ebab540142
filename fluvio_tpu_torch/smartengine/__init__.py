"""SmartEngine of the GPU port: DSL chains lowered to torch code and
hand-written CUDA kernels over the batched record buffer."""

from fluvio_tpu_torch.smartengine.config import Lookback, SmartModuleConfig
from fluvio_tpu_torch.smartengine.engine import (
    EngineError,
    SmartEngine,
    SmartModuleChainBuilder,
    SmartModuleChainInstance,
    StoreMemoryExceeded,
)
from fluvio_tpu_torch.smartengine.gpu.executor import GpuSpill
from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams
from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics

__all__ = [
    "EngineError",
    "GpuSpill",
    "LinkParams",
    "Lookback",
    "SmartEngine",
    "SmartModuleChainBuilder",
    "SmartModuleChainInstance",
    "SmartModuleChainMetrics",
    "SmartModuleConfig",
    "StoreMemoryExceeded",
    "StripeParams",
]
