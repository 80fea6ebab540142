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

Segments. ``initialize()`` runs every module's ``init`` hook (metered)
and cuts the chain into segments, in order: a card segment is one
`GpuChainExecutor` over a maximal run of consecutive modules that carry a
DSL program, a host segment one `hooks.HookInstance` for a module that
carries none (a user Python SmartModule). A module routes by what it
carries, once, at build: a DSL program goes to the card even when the
module also exports Python hooks. An all-DSL chain is one card segment
and is exactly its executor (``gpu_chain``); a chain with a host segment
has no ``gpu_chain``, and ``process`` runs its segments one after the
other as the reference's ``_process_instances`` runs its instances: each
next input is the last output's records at the same base offset and
timestamp, and the first error ends the pass with that segment's
partial output. Host segments run under the engine's wall-clock fuel
budget, ``SmartEngine.hook_budget_ms`` (0: unmetered; the SPU's default
is 5,000 ms, `spu.config.SmartEngineConfig`), scaled by the input's
records (`metering.scale_budget`). A hook thread the metering had to
abandon, or a trapped aggregate hook, poisons the chain: every later
pass returns that error without running a hook. ``look_back(read_fn)``
feeds stored records to the modules' ``look_back`` hooks, off the event
loop and metered. Nothing interprets a DSL program on the host.

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

import asyncio
import base64
from dataclasses import dataclass, field
from typing import Awaitable, Callable, List, Optional, Union

import torch

from fluvio_tpu_torch.smartengine.config import Lookback, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import glz
from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor, GpuSpill
from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams
from fluvio_tpu_torch.smartengine.hooks import HookInstance
from fluvio_tpu_torch.smartengine.metering import SmartModuleFuelError, run_metered, scale_budget
from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef, load_source
from fluvio_tpu_torch.smartmodule.types import (
    SmartModuleInput,
    SmartModuleKind,
    SmartModuleOutput,
    SmartModuleRecord,
    SmartModuleTransformRuntimeError,
)
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


class SmartModuleChainInitError(EngineError):
    """A module's init hook failed during chain build (parity: engine.rs)."""


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
    """Engine factory bound to one torch device (default: the CUDA card).
    ``hook_budget_ms`` is the wall-clock budget of one Python hook call (0:
    unmetered)."""

    device: Optional[str] = None
    stripes: StripeParams = field(default_factory=StripeParams)
    link: LinkParams = field(default_factory=LinkParams)
    store_max_memory: int = DEFAULT_STORE_MAX_MEMORY
    hook_budget_ms: int = 0

    def __post_init__(self) -> None:
        self.device = str(resolve_device(self.device))

    def builder(self) -> "SmartModuleChainBuilder":
        return SmartModuleChainBuilder(engine=self)


def _on_card(module: SmartModuleDef) -> bool:
    """A module's route, fixed at build: the card when its transform
    carries a DSL program, else the host."""
    return module.dsl_program(module.transform_kind()) is not None


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
        """Run every module's ``init`` hook, metered (a failure raises
        :class:`SmartModuleChainInitError`), and build the chain's
        segments for the engine's device (see the module docstring; an
        empty chain has none and passes records through). Raises
        :class:`EngineError` when a run of DSL modules does not lower to
        the card (no host interpreter takes it), and, with the glz link
        on, when the host compressor library does not build (no batch
        ships raw in its place)."""
        engine = self.engine
        device = torch.device(engine.device)
        if engine.link.any:
            try:
                glz.load()
            except glz.GlzUnavailable as e:
                raise EngineError(f"the glz link is on but the {e}") from e
        instances = []
        for module, config in self.entries:
            inst = HookInstance(module, config)
            try:
                # init is user code too: a looping init becomes a typed
                # chain-init error, not a wedged chain build
                run_metered(inst.call_init, engine.hook_budget_ms, module.name,
                            key=module.meter_key)
            except Exception as e:  # noqa: BLE001 — the user code boundary
                raise SmartModuleChainInitError(
                    f"init failed for SmartModule {module.name!r}: {e}") from e
            instances.append(inst)
        segments: List[Union[GpuChainExecutor, HookInstance]] = []
        i, n = 0, len(self.entries)
        while i < n:
            if not _on_card(self.entries[i][0]):
                segments.append(instances[i])
                i += 1
                continue
            j = i
            while j < n and _on_card(self.entries[j][0]):
                j += 1
            executor = GpuChainExecutor.try_build(self.entries[i:j], device, engine.stripes,
                                                  engine.link)
            if executor is None:
                raise EngineError(
                    "the chain's DSL programs must lower to the GPU (modules "
                    f"{[m.name for m, _ in self.entries[i:j]]}): no host interpreter runs them")
            segments.append(executor)
            i = j
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
        return SmartModuleChainInstance(engine, segments, instances, chain_spec)


class SmartModuleChainInstance:
    """An initialized chain: its ``segments`` (card executors and host hook
    instances, in order), one `HookInstance` per module (``instances``,
    whose ``init`` hooks ran at build and whose ``look_back`` hooks
    `look_back` runs) and ``chain_spec``, each module's name, kind, params
    and aggregate seed. ``gpu_chain`` is the executor of an all-DSL chain
    (its one segment), else None: the batched consume path runs only such
    chains, and others go one input at a time through ``process``."""

    def __init__(self, engine: SmartEngine, segments: list, instances: List[HookInstance],
                 chain_spec: Optional[list] = None):
        self.engine = engine
        self.segments = segments
        self.instances = instances
        self.chain_spec = chain_spec or []
        self.gpu_chain: Optional[GpuChainExecutor] = (
            segments[0] if len(segments) == 1 and isinstance(segments[0], GpuChainExecutor)
            else None)
        # chain identity on the telemetry's spans: the executor's signature,
        # else the modules' kinds (the reference's label for its
        # interpreter chains)
        self.chain_label = (self.gpu_chain._chain_sig if self.gpu_chain is not None
                            else "+".join(i.kind.value for i in instances) or "empty")
        # set when a fuel trap abandoned a hook thread (or trapped an
        # aggregate hook): the chain fails fast with this error instead of
        # re-entering user code whose previous call may still run
        self._poisoned: Optional[SmartModuleTransformRuntimeError] = None

    @property
    def backend_in_use(self) -> str:
        """``gpu`` (one card segment), ``host`` (host segments only),
        ``mixed`` or ``passthrough`` (no module)."""
        if self.gpu_chain is not None:
            return "gpu"
        if not self.segments:
            return "passthrough"
        if all(isinstance(s, HookInstance) for s in self.segments):
            return "host"
        return "mixed"

    def process(self, inp: SmartModuleInput,
                metrics: Optional[SmartModuleChainMetrics] = None) -> SmartModuleOutput:
        """Run one input through the chain: the outputs are its survivors
        with their offset and timestamp deltas (explode outputs are fresh
        records, deltas 0); the first transform error ends the pass, and
        the output holds the records before it and the error. An input
        larger than ``engine.store_max_memory`` raises
        :class:`StoreMemoryExceeded`; a `GpuSpill` from a card segment
        propagates (the port reruns nothing in an interpreter), counted on
        the telemetry's ``spills`` family by its reason, and any other
        failure of a card segment as ``fused-error``."""
        metrics = metrics if metrics is not None else SmartModuleChainMetrics()
        raw_len = inp.byte_size()
        if raw_len > self.engine.store_max_memory:
            raise StoreMemoryExceeded(raw_len, self.engine.store_max_memory)
        metrics.add_bytes_in(raw_len)
        if not self.segments:
            # empty chain: decode and pass through (parity: engine.rs:180-184)
            return SmartModuleOutput.new(inp.into_records())
        if self.gpu_chain is not None:
            output = self._card(self.gpu_chain, inp, metrics)
        else:
            output = self._process_segments(inp, metrics)
        if output.error is None:
            metrics.add_records_out(len(output.successes))
        return output

    @staticmethod
    def _card(executor: GpuChainExecutor, inp: SmartModuleInput,
              metrics: SmartModuleChainMetrics) -> SmartModuleOutput:
        try:
            return executor.process(inp, metrics)
        except GpuSpill as e:
            TELEMETRY.add_spill(e.reason)
            raise
        except Exception:
            TELEMETRY.add_spill("fused-error")
            raise

    def _process_segments(self, inp: SmartModuleInput,
                          metrics: SmartModuleChainMetrics) -> SmartModuleOutput:
        """The segments one after the other (the reference's
        ``_process_instances``). Each host segment runs metered, under its
        own ``interpreter`` batch span; a fuel trap becomes a transform
        error at the input's base offset, and poisons the chain when the
        hook thread was abandoned or the hook is an aggregate's (the
        injected exception may have left its accumulator half-written)."""
        if self._poisoned is not None:
            # the rejected pass still records, so an error storm on a
            # poisoned chain stays visible in the interpreter batch counts
            span = TELEMETRY.begin_batch(path="interpreter", chain=self.chain_label)
            if span is not None:
                TELEMETRY.end_batch(span, records=inp.record_count())
            return SmartModuleOutput(error=self._poisoned)
        base_offset, base_timestamp = inp.base_offset, inp.base_timestamp
        budget = scale_budget(self.engine.hook_budget_ms, inp.record_count())
        next_input = inp
        output = SmartModuleOutput()
        for i, seg in enumerate(self.segments):
            if isinstance(seg, GpuChainExecutor):
                output = self._card(seg, next_input, metrics)
            else:
                output = self._run_hook_segment(seg, next_input, metrics, budget, base_offset)
            if output.error is not None:
                break  # the partial output of the failing segment (engine.rs:159-161)
            if i + 1 < len(self.segments):
                next_input = SmartModuleInput.from_records(
                    output.successes, base_offset=base_offset, base_timestamp=base_timestamp)
        return output

    def _run_hook_segment(self, inst: HookInstance, inp: SmartModuleInput,
                          metrics: SmartModuleChainMetrics, budget: int,
                          base_offset: int) -> SmartModuleOutput:
        span = TELEMETRY.begin_batch(path="interpreter", chain=self.chain_label)
        try:
            return run_metered(lambda: inst.process(inp, metrics), budget, inst.module.name,
                               key=inst.module.meter_key)
        except SmartModuleFuelError as e:
            error = SmartModuleTransformRuntimeError(hint=str(e), offset=base_offset,
                                                     kind=inst.kind)
            if e.abandoned or inst.kind is SmartModuleKind.AGGREGATE:
                self._poisoned = error
            return SmartModuleOutput(error=error)
        finally:
            if span is not None:
                TELEMETRY.end_batch(span, records=inp.record_count())

    async def look_back(
        self,
        read_fn: Callable[[Lookback], Awaitable[List[SmartModuleRecord]]],
        metrics: Optional[SmartModuleChainMetrics] = None,
    ) -> None:
        """Feed stored records to each module that exports a ``look_back``
        hook (parity: engine.rs:187-218): ``read_fn(lookback)`` returns the
        records the module's `Lookback` asks for (none asked: the last 0).
        The hooks run in a worker thread, so a looping one stalls only
        this call, under the engine's budget scaled by the records. A
        hook that raises raises `SmartModuleLookbackError` (the record's
        offset); a fuel trap raises `SmartModuleFuelError`, and poisons the
        chain when its thread was abandoned."""
        for inst in self.instances:
            if not inst.module.has_look_back():
                continue
            records = await read_fn(inst.config.lookback or Lookback.last_n(0))
            if metrics is not None:
                metrics.add_bytes_in(sum(len(r.value) for r in records))
            try:
                await asyncio.to_thread(
                    run_metered,
                    lambda: inst.call_look_back(records),
                    scale_budget(self.engine.hook_budget_ms, len(records)),
                    inst.module.name,
                    inst.module.meter_key,
                )
            except SmartModuleFuelError as e:
                if e.abandoned:
                    self._poisoned = SmartModuleTransformRuntimeError(hint=str(e),
                                                                      kind=inst.kind)
                raise
