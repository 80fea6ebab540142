"""SmartEngine and chain builder of the GPU port.

The port's counterpart of ``fluvio_tpu/smartengine/engine.py`` for the
entry point users call (``bench.py:43-50`` has the same shape)::

    chain = (SmartEngine(device="cuda").builder()
             .add_smart_module(SmartModuleConfig(params=...), lookup("json-map"))
             .initialize())
    out = chain.process_buffer(buf)            # or chain.process_stream(bufs)

``SmartEngine(device=..., stripes=StripeParams(...))`` sets the striped
wide-record geometry (default: threshold 65536, stripes of 8192 bytes
overlapping by 128, the JAX package's defaults).
``SmartEngine(device=..., link=LinkParams(compress=True,
result_compress=True))`` turns on the glz link: record bytes cross to the
card compressed, and view descriptors come back compressed when that is
smaller. Both halves are off by default.

The engine runs on the card; ``device="cpu"`` runs the plain torch
versions of the kernels instead, which is what the tests do. With no
device given and no CUDA, construction raises: the engine never drifts to
the CPU on its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from fluvio_tpu_torch.smartengine.config import SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import glz
from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor
from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef


class EngineError(Exception):
    pass


@dataclass
class SmartEngine:
    """Engine factory bound to one torch device (default: the CUDA card)."""

    device: Optional[str] = None
    stripes: StripeParams = field(default_factory=StripeParams)
    link: LinkParams = field(default_factory=LinkParams)

    def __post_init__(self) -> None:
        if self.device is None:
            if not torch.cuda.is_available():
                raise EngineError(
                    "CUDA is not available; pass device='cpu' to run the plain "
                    "torch kernels on the CPU"
                )
            self.device = "cuda"
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise EngineError(f"device {self.device!r} requested but CUDA is not available")
        if dev.type not in ("cuda", "cpu"):
            raise EngineError(f"unsupported device {self.device!r}")

    def builder(self) -> "SmartModuleChainBuilder":
        return SmartModuleChainBuilder(engine=self)


@dataclass
class SmartModuleChainBuilder:
    engine: SmartEngine
    entries: List[tuple] = field(default_factory=list)

    def add_smart_module(
        self, config: SmartModuleConfig, module: SmartModuleDef
    ) -> "SmartModuleChainBuilder":
        self.entries.append((module, config))
        return self

    def initialize(self) -> GpuChainExecutor:
        """Lower the chain for the engine's device and return it (call
        ``process_buffer`` / ``process_stream`` on the result); raises
        :class:`EngineError` when a module has no lowerable DSL program
        (there is no interpreter to fall back to). With the glz link on,
        the host compressor library must build, or this raises
        :class:`EngineError` (no batch ships raw in its place)."""
        device = torch.device(self.engine.device)
        if self.engine.link.any:
            try:
                glz.load()
            except glz.GlzUnavailable as e:
                raise EngineError(f"the glz link is on but the {e}") from e
        executor = GpuChainExecutor.try_build(
            self.entries, device, self.engine.stripes, self.engine.link
        )
        if executor is None:
            raise EngineError(
                "every module in the chain must carry a DSL program the GPU "
                "lowering supports"
            )
        return executor
