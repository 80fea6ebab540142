"""Per-module chain configuration (the port's copy of
``fluvio_tpu/smartengine/config.py``'s `SmartModuleConfig`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class SmartModuleConfig:
    """Per-module invocation config within a chain: the ``params`` that
    ``@param:`` references resolve against, and an aggregate's accumulator
    seed (``initial_data``, read with `dsl.parse_int_prefix`)."""

    params: Dict[str, str] = field(default_factory=dict)
    initial_data: bytes = b""
