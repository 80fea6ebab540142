"""SPU configuration (the port's copy of ``fluvio_tpu/spu/config.py``;
parity: fluvio-spu/src/config/spu_config.rs).

The SmartEngine runs on the card: ``smart_engine.device`` None means the
CUDA card (the server raises at construction when there is none), and
``"cpu"`` runs the kernels' plain torch versions, which the tests ask
for. ``tls`` turns on TLS at the public endpoint; the private one stays
plaintext, as in the reference. With ``sc_addr`` set the SPU
registers with that SC's private endpoint and takes its replicas and
SmartModules from it (`sc_dispatcher.ScDispatcher`). ``private_addr`` is
the internal endpoint its followers sync from (empty: no internal
server); ``in_sync_replica`` is the quorum of a replica created without
an SC-pushed replica set; ``cleaner_interval_seconds`` is the retention
sweep's period (0 or less: no sweep). ``monitoring_path`` is the unix
socket of the metrics endpoint (`monitoring.MonitoringServer`; None: no
endpoint, "": its default path) and ``telemetry`` the `TelemetryConfig`
the server applies to the process at construction (None: leave the
process's telemetry settings as they are); ``admission`` likewise the
`AdmissionConfig` (None: leave the process's admission settings as they
are, which start disarmed). The port reads no environment variable:
every setting is a field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from fluvio_tpu_torch.admission.types import AdmissionConfig
from fluvio_tpu_torch.smartengine.engine import DEFAULT_STORE_MAX_MEMORY
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.telemetry.registry import TelemetryConfig
from fluvio_tpu_torch.transport.tls import ServerTlsConfig
from fluvio_tpu_torch.types import SPU_PUBLIC_PORT


@dataclass
class SmartEngineConfig:
    device: Optional[str] = None  # None: the CUDA card; "cpu": the plain kernels
    store_max_memory: int = DEFAULT_STORE_MAX_MEMORY
    # the fuel analog: wall-clock budget of one Python hook call, ms (the
    # broker meters user hooks by default so a hostile module cannot
    # wedge it; 0 turns metering off; see smartengine/metering.py)
    hook_budget_ms: int = 5000


@dataclass
class SpuConfig:
    id: int = 0
    public_addr: str = f"0.0.0.0:{SPU_PUBLIC_PORT}"
    private_addr: str = "127.0.0.1:0"  # internal (peer replication) endpoint
    sc_addr: str = ""  # SC private endpoint; "" = standalone broker
    log_base_dir: str = "/tmp/fluvio-tpu"
    replication: ReplicaConfig = field(default_factory=ReplicaConfig)
    smart_engine: SmartEngineConfig = field(default_factory=SmartEngineConfig)
    # produce-side flush guarantees: 1 means the HW advances on the local write
    in_sync_replica: int = 1
    # metrics unix-socket endpoint (monitoring.rs); None = disabled,
    # "" = monitoring.SPU_MONITORING_UNIX_SOCKET
    monitoring_path: Optional[str] = None
    telemetry: Optional[TelemetryConfig] = None
    # admission control (the shed/hold gate and the chain warm-up); None
    # leaves the process's settings (disarmed unless configured)
    admission: Optional[AdmissionConfig] = None
    # retention cleaner pass period (cleaner.rs:20 `CLEANING_INTERVAL`);
    # <= 0 disables the background task
    cleaner_interval_seconds: float = 30.0
    tls: ServerTlsConfig = field(default_factory=ServerTlsConfig)

    def __post_init__(self) -> None:
        if self.replication.base_dir in (".", ""):
            self.replication.base_dir = self.log_base_dir
