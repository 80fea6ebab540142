"""SPU configuration (the port's copy of ``fluvio_tpu/spu/config.py``;
parity: fluvio-spu/src/config/spu_config.rs).

The SmartEngine runs on the card: ``smart_engine.device`` None means the
CUDA card (the server raises at construction when there is none), and
``"cpu"`` runs the kernels' plain torch versions, which the tests ask
for. The public endpoint is plaintext TCP. With ``sc_addr`` set the SPU
registers with that SC's private endpoint and takes its replicas and
SmartModules from it (`sc_dispatcher.ScDispatcher`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from fluvio_tpu_torch.smartengine.engine import DEFAULT_STORE_MAX_MEMORY
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.types import SPU_PUBLIC_PORT


@dataclass
class SmartEngineConfig:
    device: Optional[str] = None  # None: the CUDA card; "cpu": the plain kernels
    store_max_memory: int = DEFAULT_STORE_MAX_MEMORY


@dataclass
class SpuConfig:
    id: int = 0
    public_addr: str = f"0.0.0.0:{SPU_PUBLIC_PORT}"
    sc_addr: str = ""  # SC private endpoint; "" = standalone broker
    log_base_dir: str = "/tmp/fluvio-tpu"
    replication: ReplicaConfig = field(default_factory=ReplicaConfig)
    smart_engine: SmartEngineConfig = field(default_factory=SmartEngineConfig)

    def __post_init__(self) -> None:
        if self.replication.base_dir in (".", ""):
            self.replication.base_dir = self.log_base_dir
