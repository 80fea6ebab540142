"""SmartEngine, chain builder and chain instance of the GPU port.

The port's counterpart of ``fluvio_tpu/smartengine/engine.py`` for the
entry points users call (``bench.py:43-50`` has the same shape)::

    chain = (SmartEngine(device="cuda").builder()
             .add_smart_module(SmartModuleConfig(params=...), lookup("json-map"))
             .initialize())
    out = chain.process(SmartModuleInput.from_records(records))   # the broker's seam
    out = chain.gpu_chain.process_buffer(buf)   # or .process_stream(bufs)

``add_smart_module`` also takes SmartModule source (str or bytes), the
payload of an AdHoc invocation (`smartmodule.sdk.load_source`).
``initialize()`` returns a `SmartModuleChainInstance`; its executor,
``gpu_chain``, runs batched record buffers.

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

import base64
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import torch

from fluvio_tpu_torch.smartengine.config import SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import glz
from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor, GpuSpill
from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams
from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef, load_source
from fluvio_tpu_torch.smartmodule.types import SmartModuleInput, SmartModuleOutput
from fluvio_tpu_torch.telemetry import TELEMETRY

DEFAULT_STORE_MAX_MEMORY = 1 << 30  # 1 GB input bound, parity: engine.rs:24


class EngineError(Exception):
    pass


class StoreMemoryExceeded(EngineError):
    """An input slab exceeds the engine's memory bound (parity:
    limiter.rs)."""

    def __init__(self, requested: int, maximum: int):
        super().__init__(
            f"SmartModule input of {requested} bytes exceeds engine memory "
            f"limit of {maximum} bytes"
        )
        self.requested = requested
        self.maximum = maximum


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: the CUDA card when
    ``device`` is None, else ``device``, which must be the card or the
    CPU. Raises :class:`EngineError` when CUDA is asked for, or implied,
    and not available: no entry point drifts to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise EngineError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "torch kernels on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise EngineError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise EngineError(f"unsupported device {device!r}")
    return dev


@dataclass
class SmartEngine:
    """Engine factory bound to one torch device (default: the CUDA card)."""

    device: Optional[str] = None
    stripes: StripeParams = field(default_factory=StripeParams)
    link: LinkParams = field(default_factory=LinkParams)
    store_max_memory: int = DEFAULT_STORE_MAX_MEMORY

    def __post_init__(self) -> None:
        self.device = str(resolve_device(self.device))

    def builder(self) -> "SmartModuleChainBuilder":
        return SmartModuleChainBuilder(engine=self)


@dataclass
class SmartModuleChainBuilder:
    engine: SmartEngine
    entries: List[tuple] = field(default_factory=list)

    def add_smart_module(
        self,
        config: SmartModuleConfig,
        module: Union[SmartModuleDef, str, bytes],
        name: str = "adhoc",
    ) -> "SmartModuleChainBuilder":
        """Append a module: a `SmartModuleDef`, or its source (str or
        bytes), loaded with `load_source` under ``name``."""
        if not isinstance(module, SmartModuleDef):
            module = load_source(module, name=name)
        self.entries.append((module, config))
        return self

    def initialize(self) -> "SmartModuleChainInstance":
        """Lower the chain for the engine's device and return its
        instance (``instance.gpu_chain`` is the executor; an empty chain
        has none and passes records through). Raises
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
        executor = None
        if self.entries:
            executor = GpuChainExecutor.try_build(
                self.entries, device, self.engine.stripes, self.engine.link
            )
            if executor is None:
                raise EngineError(
                    "every module in the chain must carry a DSL program the GPU "
                    "lowering supports"
                )
        chain_spec = []
        for module, config in self.entries:
            spec = {
                "name": module.name,
                "kind": module.transform_kind().value,
                "params": dict(config.params or {}),
            }
            if config.initial_data:
                spec["initial"] = base64.b64encode(bytes(config.initial_data)).decode("ascii")
            chain_spec.append(spec)
        look_back = [module.name for module, _ in self.entries if module.has_look_back()]
        return SmartModuleChainInstance(self.engine, executor, chain_spec, look_back)


class SmartModuleChainInstance:
    """An initialized chain (the reference's instance with its
    ``tpu_chain``): ``process`` runs one input slab through the executor
    ``gpu_chain``. ``chain_spec`` names each module, its kind, params and
    aggregate seed; ``look_back_modules`` the modules that export a
    ``look_back`` hook, which the port never runs."""

    def __init__(self, engine: SmartEngine, gpu_chain: Optional[GpuChainExecutor],
                 chain_spec: Optional[list] = None, look_back_modules: Sequence[str] = ()):
        self.engine = engine
        self.gpu_chain = gpu_chain
        self.chain_spec = chain_spec or []
        self.look_back_modules = list(look_back_modules)

    @property
    def backend_in_use(self) -> str:
        return "gpu" if self.gpu_chain is not None else "passthrough"

    def process(self, inp: SmartModuleInput,
                metrics: Optional[SmartModuleChainMetrics] = None) -> SmartModuleOutput:
        """Run one input through the chain: the outputs are its
        survivors with their offset and timestamp deltas (explode outputs
        are fresh records, deltas 0). An input larger than ``engine.store_max_memory`` raises
        :class:`StoreMemoryExceeded`; a `GpuSpill` from the executor
        propagates (the port reruns nothing in an interpreter), counted
        on the telemetry's ``spills`` family by its reason, and any other
        failure of the chain as ``fused-error``."""
        metrics = metrics if metrics is not None else SmartModuleChainMetrics()
        raw_len = inp.byte_size()
        if raw_len > self.engine.store_max_memory:
            raise StoreMemoryExceeded(raw_len, self.engine.store_max_memory)
        metrics.add_bytes_in(raw_len)
        if self.gpu_chain is None:
            # empty chain: decode and pass through (parity: engine.rs:180-184)
            return SmartModuleOutput.new(inp.into_records())
        try:
            output = self.gpu_chain.process(inp, metrics)
        except GpuSpill as e:
            TELEMETRY.add_spill(e.reason)
            raise
        except Exception:
            TELEMETRY.add_spill("fused-error")
            raise
        metrics.add_records_out(len(output.successes))
        return output
