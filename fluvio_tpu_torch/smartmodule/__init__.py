"""SmartModule definitions: DSL programs, the transform kinds, the
dataplane types of one invocation and the source loader."""

from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef, load_source, smartmodule
from fluvio_tpu_torch.smartmodule.types import (
    TRANSFORM_KIND_ORDER,
    SmartModuleInput,
    SmartModuleKind,
    SmartModuleOutput,
    SmartModuleRecord,
    SmartModuleTransformRuntimeError,
)

__all__ = [
    "SmartModuleDef",
    "SmartModuleInput",
    "SmartModuleKind",
    "SmartModuleOutput",
    "SmartModuleRecord",
    "SmartModuleTransformRuntimeError",
    "TRANSFORM_KIND_ORDER",
    "load_source",
    "smartmodule",
]
