"""SmartModule invocation wire types (the port's copy of
``fluvio_tpu/schema/smartmodule.py``).

Capability parity: fluvio-spu-schema/src/server/smartmodule.rs —
`SmartModuleInvocation{wasm, kind, params}` with `AdHoc(payload)` vs
`Predefined(name)` module sources, aggregate accumulator seeds, and
lookback config. Here the payload is DSL/Python SmartModule source bytes
(this framework's artifact format) instead of gzipped WASM.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version
from fluvio_tpu_torch.smartengine.config import Lookback, SmartModuleConfig


class SmartModuleInvocationKind(enum.IntEnum):
    """Declared transform kind; GENERIC lets the engine probe exports."""

    GENERIC = 0
    FILTER = 1
    MAP = 2
    FILTER_MAP = 3
    ARRAY_MAP = 4
    AGGREGATE = 5


@dataclass
class SmartModuleInvocationWasm:
    """Module source: inline payload (AdHoc) or a named, pre-loaded module."""

    ADHOC = 0
    PREDEFINED = 1

    tag: int = ADHOC
    payload: bytes = b""  # AdHoc: artifact source bytes
    name: str = ""  # Predefined: SmartModule object name

    @classmethod
    def adhoc(cls, payload: bytes) -> "SmartModuleInvocationWasm":
        return cls(tag=cls.ADHOC, payload=payload)

    @classmethod
    def predefined(cls, name: str) -> "SmartModuleInvocationWasm":
        return cls(tag=cls.PREDEFINED, name=name)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u8(self.tag)
        if self.tag == self.ADHOC:
            w.write_bytes(self.payload)
        else:
            w.write_string(self.name)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "SmartModuleInvocationWasm":
        tag = r.read_u8()
        if tag == cls.ADHOC:
            return cls(tag=tag, payload=r.read_bytes() or b"")
        return cls(tag=tag, name=r.read_string())


@dataclass
class SmartModuleInvocation:
    """One chain step as sent by producers/consumers."""

    wasm: SmartModuleInvocationWasm = field(default_factory=SmartModuleInvocationWasm)
    kind: SmartModuleInvocationKind = SmartModuleInvocationKind.GENERIC
    accumulator: bytes = b""  # aggregate seed (kind == AGGREGATE)
    params: Dict[str, str] = field(default_factory=dict)
    lookback_last: int = 0
    lookback_age_ms: int = -1  # -1 = no age bound; (0,0,-1) = no lookback
    name: Optional[str] = None  # display name for errors/metrics

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        self.wasm.encode(w, version)
        w.write_u8(int(self.kind))
        w.write_bytes(self.accumulator)
        w.write_vec(
            sorted(self.params.items()),
            lambda kv: (w.write_string(kv[0]), w.write_string(kv[1])),
        )
        w.write_i64(self.lookback_last)
        w.write_i64(self.lookback_age_ms)
        w.write_option_string(self.name)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "SmartModuleInvocation":
        wasm = SmartModuleInvocationWasm.decode(r, version)
        kind = SmartModuleInvocationKind(r.read_u8())
        accumulator = r.read_bytes() or b""
        params = dict(r.read_vec(lambda: (r.read_string(), r.read_string())))
        lookback_last = r.read_i64()
        lookback_age_ms = r.read_i64()
        name = r.read_option_string()
        return cls(
            wasm=wasm,
            kind=kind,
            accumulator=accumulator,
            params=params,
            lookback_last=lookback_last,
            lookback_age_ms=lookback_age_ms,
            name=name,
        )

    def lookback(self) -> Optional[Lookback]:
        if self.lookback_last == 0 and self.lookback_age_ms < 0:
            return None
        if self.lookback_age_ms >= 0:
            return Lookback.age(self.lookback_age_ms, self.lookback_last)
        return Lookback.last_n(self.lookback_last)

    def to_config(self) -> SmartModuleConfig:
        return SmartModuleConfig(
            params=dict(self.params),
            lookback=self.lookback(),
            initial_data=self.accumulator,
        )
