"""SmartModule object spec.

Capability parity: fluvio-controlplane-metadata/src/smartmodule/
{spec.rs:18, package.rs} — package metadata (name/group/version, declared
params) + the artifact payload. The reference stores gzipped WASM; here
the artifact is DSL/Python SmartModule source (this framework's portable
transform format), with the format field kept for future kinds.

The port's copy of ``fluvio_tpu/metadata/smartmodule.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, List, Optional

from fluvio_tpu_torch.stream_model.core import Spec, Status


@dataclass
class SmartModuleParam:
    name: str = ""
    optional: bool = True
    description: str = ""


@dataclass
class SmartModulePackage:
    name: str = ""
    group: str = ""
    version: str = "0.1.0"
    api_version: str = "0.1.0"
    description: str = ""
    params: List[SmartModuleParam] = field(default_factory=list)

    def fqdn(self) -> str:
        return f"{self.group}/{self.name}@{self.version}" if self.group else self.name


@dataclass
class SmartModuleArtifact:
    format: str = "python-dsl"  # artifact kind
    payload: bytes = b""  # source bytes (see smartmodule.sdk.load_source)


@dataclass
class SmartModuleSpec(Spec):
    LABEL: ClassVar[str] = "SmartModule"
    KIND: ClassVar[str] = "smartmodule"

    meta: Optional[SmartModulePackage] = None
    summary: str = ""
    artifact: SmartModuleArtifact = field(default_factory=SmartModuleArtifact)

    @classmethod
    def from_source(cls, payload: bytes, name: str = "") -> "SmartModuleSpec":
        return cls(
            meta=SmartModulePackage(name=name) if name else None,
            artifact=SmartModuleArtifact(payload=payload),
        )


@dataclass
class SmartModuleStatus(Status):
    pass


SmartModuleSpec.STATUS = SmartModuleStatus
