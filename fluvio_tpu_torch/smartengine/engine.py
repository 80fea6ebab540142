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
module also exports Python hooks. A run of DSL modules that does not lower
as a whole (two explodes, a windowed aggregate after an explode) is cut
into maximal runs that do, greedily from the left, each its own card
segment (`cut_card_runs`); only a module that does not lower alone is
refused. A chain that is one card segment is exactly its executor
(``gpu_chain``); any other chain has no ``gpu_chain``, and ``process``
runs its segments one after the other as the reference's
``_process_instances`` runs its instances: each
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

Resilience (`fluvio_tpu_torch.resilience`, the reference's ladder with
the card in place of its interpreter). The executor retries a transient
failure itself, from the batch's starting carries. A failure its retries
did not clear counts ``fused-error`` and a failure on the segment's
`CircuitBreaker`, and the segment runs again on the card (`_spill_rerun`:
the ``spill_rerun`` seam, the state of that segment and the ones after
it restored before each attempt, transient failures retried under the
engine's
`ResilienceConfig`); an open breaker skips the first attempt and goes
straight there. A batch whose re-run fails too is quarantined into the
dead-letter directory, every carry back where the batch found it, and
``process`` returns an empty output. A `GpuSpill` and a fatal failure (a
sticky CUDA error) propagate; a transform error is an output with
``error`` set.

``SmartEngine(device=..., resilience=ResilienceConfig(...))`` sets the
retry, breaker and dead-letter budgets (default: the reference's).
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
import logging
from dataclasses import dataclass, field
from typing import Awaitable, Callable, List, Optional, Union

import torch

from fluvio_tpu_torch.resilience import faults
from fluvio_tpu_torch.resilience.deadletter import quarantine_batch
from fluvio_tpu_torch.resilience.policy import (
    CircuitBreaker,
    ResilienceConfig,
    RetryPolicy,
    is_fatal,
)
from fluvio_tpu_torch.smartengine.config import Lookback, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import glz
from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor, GpuSpill, lower_chain
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

logger = logging.getLogger(__name__)

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
    unmetered); ``resilience`` the retry, breaker and dead-letter budgets
    of its chains."""

    device: Optional[str] = None
    stripes: StripeParams = field(default_factory=StripeParams)
    link: LinkParams = field(default_factory=LinkParams)
    store_max_memory: int = DEFAULT_STORE_MAX_MEMORY
    hook_budget_ms: int = 0
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)

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
            for lo, hi in cut_card_runs(self.entries, i, j):
                segments.append(GpuChainExecutor.try_build(
                    self.entries[lo:hi], device, engine.stripes, engine.link, engine.resilience))
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


def cut_card_runs(entries, i: int, j: int) -> List[tuple]:
    """The card segments of the DSL run ``entries[i:j]``: the whole run
    when it lowers (`lower_chain`), else maximal runs that do, greedily
    from the left (two explodes, a windowed aggregate after an explode).
    Returns ``[(lo, hi), ...]``. Raises :class:`EngineError` for a module
    that does not lower alone: no host interpreter runs it."""
    out = []
    lo = i
    while lo < j:
        hi = j
        while hi > lo and lower_chain(entries[lo:hi]) is None:
            hi -= 1
        if hi == lo:
            raise EngineError(
                "the chain's DSL programs must lower to the GPU (module "
                f"{entries[lo][0].name!r} does not): no host interpreter runs it")
        out.append((lo, hi))
        lo = hi
    return out


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
        # the resilience ladder: a circuit breaker for each card segment
        # (None beside a host segment) and the card re-run's retry policy
        cfg = engine.resilience
        self.breakers: List[Optional[CircuitBreaker]] = [
            CircuitBreaker(cfg) if isinstance(seg, GpuChainExecutor) else None
            for seg in segments
        ]
        self._rerun_retry = RetryPolicy(cfg)

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        """The first card segment's breaker (an all-DSL chain's only one)."""
        return next((b for b in self.breakers if b is not None), None)

    @property
    def backend_in_use(self) -> str:
        """``gpu`` (card segments only), ``host`` (host segments only),
        ``mixed`` or ``passthrough`` (no module)."""
        if not self.segments:
            return "passthrough"
        if all(isinstance(s, GpuChainExecutor) for s in self.segments):
            return "gpu"
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
        the telemetry's ``spills`` family by its reason. Any other failure
        of a card segment takes the resilience ladder (`_card`); a batch
        it quarantines gives an empty output, no error, with every
        segment's state where the batch found it."""
        metrics = metrics if metrics is not None else SmartModuleChainMetrics()
        raw_len = inp.byte_size()
        if raw_len > self.engine.store_max_memory:
            raise StoreMemoryExceeded(raw_len, self.engine.store_max_memory)
        metrics.add_bytes_in(raw_len)
        if not self.segments:
            # empty chain: decode and pass through (parity: engine.rs:180-184)
            return SmartModuleOutput.new(inp.into_records())
        ladder = (inp, self._snapshot())
        if self.gpu_chain is not None:
            output = self._card(0, inp, metrics, ladder)
        else:
            output = self._process_segments(inp, metrics, ladder)
        if output is None:
            return SmartModuleOutput()  # quarantined: the stream advances
        if output.error is None:
            metrics.add_records_out(len(output.successes))
        return output

    def _snapshot(self) -> list:
        """Every segment's state: a card executor's carries (on the card
        and on the host), a host segment's accumulator."""
        return [(seg._device_carries, list(seg.carries)) if isinstance(seg, GpuChainExecutor)
                else seg.accumulator for seg in self.segments]

    def _restore(self, snapshot: list, start: int = 0) -> None:
        for seg, state in zip(self.segments[start:], snapshot[start:]):
            if isinstance(seg, GpuChainExecutor):
                seg._device_carries, carries = state
                seg.carries = list(carries)
            else:
                seg.accumulator = state

    def _card(self, i: int, inp: SmartModuleInput, metrics: SmartModuleChainMetrics,
              ladder: tuple) -> Optional[SmartModuleOutput]:
        """Card segment ``i`` over ``inp``, under the resilience ladder
        (the reference's fused attempt, `fluvio_tpu/smartengine/engine.py`
        ``process``): its breaker gates the fused attempt (an open one
        counts a short circuit and skips it); a failure the executor's
        retries did not clear counts ``fused-error`` and a breaker failure
        and goes to `_spill_rerun`; a fatal one (a sticky CUDA error)
        propagates. ``ladder`` is the chain's input and the pass's starting
        state. Returns None when the batch was quarantined."""
        executor, breaker = self.segments[i], self.breakers[i]
        if not breaker.allow_fused():
            TELEMETRY.add_breaker_short_circuit()
            return self._spill_rerun(i, inp, metrics, ladder,
                                     RuntimeError("fused path skipped: breaker open"))
        try:
            output = executor.process(inp, metrics)
        except GpuSpill as e:
            TELEMETRY.add_spill(e.reason)
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            TELEMETRY.add_spill("fused-error")
            if is_fatal(e):
                raise
            logger.warning("fused attempt failed (%s: %s); card re-run", type(e).__name__, e)
            breaker.record_failure()
            return self._spill_rerun(i, inp, metrics, ladder, e)
        if output.error is None:
            breaker.record_success()
        return output

    def _spill_rerun(self, i: int, inp: SmartModuleInput, metrics: SmartModuleChainMetrics,
                     ladder: tuple, fused_error: BaseException) -> Optional[SmartModuleOutput]:
        """The re-run every failed or skipped fused attempt takes (the
        reference's interpreter rerun ladder, on the card: the same
        kernels again): the ``spill_rerun`` seam, then segment ``i`` runs
        again over ``inp`` from the state the pass gave it, every segment
        from ``i`` on restored before each attempt, with bounded retry of
        transient failures. A batch whose re-run fails too is quarantined
        (`_quarantine`); a fatal failure propagates."""
        executor = self.segments[i]
        chain_inp, snapshot = ladder
        attempt = 0
        while True:
            self._restore(snapshot, i)
            try:
                faults.maybe_fire("spill_rerun")
                return executor.process(inp, metrics)
            except GpuSpill as e:
                TELEMETRY.add_spill(e.reason)
                raise
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as rerun_error:
                if is_fatal(rerun_error):
                    raise
                if self._rerun_retry.should_retry(rerun_error, attempt):
                    TELEMETRY.add_retry("spill_rerun")
                    self._rerun_retry.sleep(attempt)
                    attempt += 1
                    continue
                return self._quarantine(chain_inp, snapshot, fused_error, rerun_error)

    def _quarantine(self, inp: SmartModuleInput, snapshot: list, fused_error: BaseException,
                    rerun_error: BaseException) -> None:
        """Poison: the fused attempt and the card re-run both failed. Every
        segment's state goes back to where the batch found it, so the batch
        contributes nothing to a carry (replaying its entry later cannot
        count twice); the chain's input, its spec and both errors go to the
        dead-letter directory (`resilience.deadletter`), the ``quarantined``
        counter ticks, and the stream advances."""
        self._restore(snapshot)
        path = quarantine_batch(self.chain_spec, inp, fused_error, rerun_error,
                                self.engine.resilience)
        TELEMETRY.add_quarantine()
        logger.error("poison batch quarantined to %s (fused: %s; re-run: %s)",
                     path or "<dead-letter dir unwritable>", fused_error, rerun_error)
        return None

    def _process_segments(self, inp: SmartModuleInput, metrics: SmartModuleChainMetrics,
                          ladder: tuple) -> Optional[SmartModuleOutput]:
        """The segments one after the other (the reference's
        ``_process_instances``). Each host segment runs metered, under its
        own ``interpreter`` batch span; a fuel trap becomes a transform
        error at the input's base offset, and poisons the chain when the
        hook thread was abandoned or the hook is an aggregate's (the
        injected exception may have left its accumulator half-written).
        Returns None when a card segment quarantined the batch."""
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
                output = self._card(i, next_input, metrics, ladder)
                if output is None:
                    return None
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
