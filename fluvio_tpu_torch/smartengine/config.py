"""Per-module chain configuration (the port's copy of
``fluvio_tpu/smartengine/config.py``'s `SmartModuleConfig` and
`Lookback`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from fluvio_tpu_torch.smartmodule.types import DEFAULT_SMARTENGINE_VERSION


@dataclass
class Lookback:
    """How much stored history a module asks to see at (re)start: the
    last ``last`` records, bounded by ``age_ms`` when set; its
    ``look_back`` hook gets them (`SmartModuleChainInstance.look_back`)."""

    last: int = 0
    age_ms: Optional[int] = None

    @classmethod
    def last_n(cls, n: int) -> "Lookback":
        return cls(last=n)

    @classmethod
    def age(cls, age_ms: int, last: int = 0) -> "Lookback":
        return cls(last=last, age_ms=age_ms)


@dataclass
class SmartModuleConfig:
    """Per-module invocation config within a chain: the ``params`` that
    ``@param:`` references resolve against, an aggregate's accumulator
    seed (``initial_data``, read with `dsl.parse_int_prefix`), the
    SmartModule ABI ``version`` and the module's ``lookback``."""

    params: Dict[str, str] = field(default_factory=dict)
    initial_data: bytes = b""
    version: int = DEFAULT_SMARTENGINE_VERSION
    lookback: Optional[Lookback] = None
