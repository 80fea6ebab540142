"""SPU spec/status (parity: fluvio-controlplane-metadata/src/spu/spec.rs:455).

The port's copy of ``fluvio_tpu/metadata/spu.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, Optional

from fluvio_tpu_torch.stream_model.core import Spec, Status


@dataclass
class Endpoint:
    host: str = "localhost"
    port: int = 0

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    @classmethod
    def from_addr(cls, addr: str) -> "Endpoint":
        host, _, port = addr.rpartition(":")
        return cls(host=host or "localhost", port=int(port))


class SpuType(str, enum.Enum):
    MANAGED = "managed"  # provisioned via SpuGroup
    CUSTOM = "custom"  # registered externally


@dataclass
class SpuSpec(Spec):
    LABEL: ClassVar[str] = "Spu"
    KIND: ClassVar[str] = "spu"

    id: int = 0
    spu_type: SpuType = SpuType.CUSTOM
    public_endpoint: Endpoint = field(default_factory=Endpoint)
    private_endpoint: Endpoint = field(default_factory=Endpoint)
    rack: Optional[str] = None


class SpuResolution(str, enum.Enum):
    INIT = "init"
    ONLINE = "online"
    OFFLINE = "offline"


@dataclass
class SpuStatus(Status):
    resolution: SpuResolution = SpuResolution.INIT

    def is_online(self) -> bool:
        return self.resolution == SpuResolution.ONLINE


SpuSpec.STATUS = SpuStatus
