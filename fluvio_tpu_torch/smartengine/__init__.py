"""SmartEngine of the GPU port: DSL chains lowered to torch code and
hand-written CUDA kernels over the batched record buffer, and user Python
SmartModule hooks run on the host, metered, beside them."""

from fluvio_tpu_torch.smartengine.config import Lookback, SmartModuleConfig
from fluvio_tpu_torch.smartengine.engine import (
    EngineError,
    SmartEngine,
    SmartModuleChainBuilder,
    SmartModuleChainInitError,
    SmartModuleChainInstance,
    StoreMemoryExceeded,
)
from fluvio_tpu_torch.smartengine.gpu.executor import GpuSpill
from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams
from fluvio_tpu_torch.smartengine.metering import SmartModuleFuelError
from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics

__all__ = [
    "EngineError",
    "GpuSpill",
    "LinkParams",
    "Lookback",
    "SmartEngine",
    "SmartModuleChainBuilder",
    "SmartModuleChainInitError",
    "SmartModuleChainInstance",
    "SmartModuleChainMetrics",
    "SmartModuleConfig",
    "SmartModuleFuelError",
    "StoreMemoryExceeded",
    "StripeParams",
]
