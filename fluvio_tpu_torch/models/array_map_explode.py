"""array-map-json / array-map-lines: one output record per element of a
record's top-level JSON array (strings unquoted), or per non-empty line.
The key is the input record's. A record that is no JSON array is a
transform error. DSL programs of ``fluvio_tpu/models/array_map_explode.py``."""

from __future__ import annotations

from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import SmartModuleKind


def module() -> SmartModuleDef:
    m = SmartModuleDef(name="array-map-json")
    m.dsl[SmartModuleKind.ARRAY_MAP] = dsl.ArrayMapProgram(mode="json_array")
    return m


def lines_module() -> SmartModuleDef:
    m = SmartModuleDef(name="array-map-lines")
    m.dsl[SmartModuleKind.ARRAY_MAP] = dsl.ArrayMapProgram(mode="split", sep=b"\n")
    return m
