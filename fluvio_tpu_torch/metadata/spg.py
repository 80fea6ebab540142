"""SPU group spec (parity: fluvio-controlplane-metadata/src/spg/spec.rs).

A group of managed SPUs provisioned together. The port's SC stores the
spec an admin creates; nothing of the port provisions its members yet.

The port's copy of ``fluvio_tpu/metadata/spg.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Optional

from fluvio_tpu_torch.stream_model.core import Spec, Status


@dataclass
class SpuGroupConfig:
    storage_size: Optional[int] = None
    log_base_dir: Optional[str] = None


@dataclass
class SpuGroupSpec(Spec):
    LABEL: ClassVar[str] = "SpuGroup"
    KIND: ClassVar[str] = "spugroup"

    replicas: int = 1
    min_id: int = 0
    spu_config: SpuGroupConfig = field(default_factory=SpuGroupConfig)


@dataclass
class SpuGroupStatus(Status):
    resolution: str = "init"  # init | invalid | reserved
    reason: str = ""


SpuGroupSpec.STATUS = SpuGroupStatus
