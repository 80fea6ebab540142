"""Host hook instances: one user Python SmartModule in a chain.

The port's copy of the hook half of ``fluvio_tpu/smartengine/
python_backend.py``'s ``PythonInstance`` (the architectural slot of the
reference's wasmtime instance). A `HookInstance` runs its module's
transform hook record by record over one `SmartModuleInput`, with the
per-kind semantics of the reference's generated guest loops
(fluvio-smartmodule-derive/src/generator/{filter,map,filter_map,
array_map,aggregate}.rs):

- filter:      keep the record unchanged when the hook returns true;
- map:         rewrite the value (and the key, when a pair is returned)
               in place, offset and timestamp deltas kept;
- filter_map:  None drops the record, else as map;
- array_map:   fresh records (deltas 0) for each element returned;
- aggregate:   ``acc = hook(acc, record)``; each output record's value is
               the accumulator after it, and the instance keeps it
               (``accumulator``, seeded by ``initial_data``) from input
               to input;
- a hook that raises: a `SmartModuleTransformRuntimeError` at that
  record, and the output so far (partial output).

The engine makes one `HookInstance` for every module of a chain: it
runs the ``init`` hook at build and the ``look_back`` hook at a
look-back for all of them, and the transform hook for the modules that
carry no DSL program (DSL transforms run on the card). Hooks have no
device form: they run on the host, under the engine's metering
(`metering.run_metered`), as the JAX package runs them. Nothing here
interprets a DSL program.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

from fluvio_tpu_torch.protocol.record import Record
from fluvio_tpu_torch.smartengine.config import SmartModuleConfig
from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import (
    SmartModuleInput,
    SmartModuleKind,
    SmartModuleLookbackError,
    SmartModuleOutput,
    SmartModuleRecord,
    SmartModuleTransformRuntimeError,
)
from fluvio_tpu_torch.telemetry import TELEMETRY


def _normalize_map_result(result, record: Record) -> Tuple[Optional[bytes], bytes]:
    """A map hook's result as (key, value): bare bytes keep the input's key."""
    if isinstance(result, tuple):
        key, value = result
        key = key if key is None else bytes(key)
        return key, bytes(value)
    return record.key, bytes(result)


class HookInstance:
    """One module of a chain on the host: its config, its hooks and, for an
    aggregate hook, its accumulator."""

    def __init__(self, module: SmartModuleDef, config: SmartModuleConfig):
        self.module = module
        self.config = config
        self.kind = module.transform_kind()
        self.accumulator: bytes = config.initial_data

    # -- init / look_back -----------------------------------------------------

    def call_init(self) -> None:
        hook = self.module.hook(SmartModuleKind.INIT)
        if hook is not None:
            hook(dict(self.config.params))

    def call_look_back(self, records: List[SmartModuleRecord]) -> None:
        """Feed stored records to the ``look_back`` hook; a record it
        raises on raises `SmartModuleLookbackError` with its offset."""
        hook = self.module.hook(SmartModuleKind.LOOK_BACK)
        if hook is None:
            return
        for rec in records:
            try:
                hook(rec)
            except Exception as e:  # noqa: BLE001 — the user code boundary
                raise SmartModuleLookbackError(str(e), rec.offset) from e

    # -- transform ------------------------------------------------------------

    def process(self, inp: SmartModuleInput,
                metrics: Optional[SmartModuleChainMetrics] = None) -> SmartModuleOutput:
        """Run the transform hook over one input."""
        records = inp.into_records(self.config.version)
        if inp.records is not None:
            # from_records inputs alias the caller's objects, and the map
            # kinds rewrite records in place: the reference's guest copies
            # (input.rs:83) rule that out, so work on copies
            records = [dataclasses.replace(r) for r in records]
        sm_records = [SmartModuleRecord(r, inp.base_offset, inp.base_timestamp) for r in records]
        hook = self.module.hook(self.kind)
        if hook is None:
            raise TypeError(f"SmartModule {self.module.name!r} has no {self.kind.value} hook")
        # one clock pair an instance a call; counted whether capture is on
        # or off, as the reference counts it
        t0 = time.perf_counter()
        out = self._run_hook(hook, sm_records)
        TELEMETRY.add_interp_instance(time.perf_counter() - t0, len(sm_records))
        if metrics is not None:
            metrics.add_fuel_used(len(sm_records))
        return out

    def _error(self, exc: Exception, rec: SmartModuleRecord) -> SmartModuleTransformRuntimeError:
        return SmartModuleTransformRuntimeError(
            hint=str(exc),
            offset=rec.offset,
            kind=self.kind,
            record_key=rec.key,
            record_value=rec.value,
        )

    def _run_hook(self, hook: Callable, sm_records: List[SmartModuleRecord]) -> SmartModuleOutput:
        out = SmartModuleOutput()
        kind = self.kind
        if kind == SmartModuleKind.FILTER:
            for rec in sm_records:
                try:
                    keep = hook(rec)
                except Exception as e:  # noqa: BLE001
                    out.error = self._error(e, rec)
                    break
                if keep:
                    out.successes.append(rec.record)
        elif kind == SmartModuleKind.MAP:
            for rec in sm_records:
                try:
                    key, value = _normalize_map_result(hook(rec), rec.record)
                except Exception as e:  # noqa: BLE001
                    out.error = self._error(e, rec)
                    break
                rec.record.key = key
                rec.record.value = value
                out.successes.append(rec.record)
        elif kind == SmartModuleKind.FILTER_MAP:
            for rec in sm_records:
                try:
                    result = hook(rec)
                except Exception as e:  # noqa: BLE001
                    out.error = self._error(e, rec)
                    break
                if result is None:
                    continue
                key, value = _normalize_map_result(result, rec.record)
                rec.record.key = key
                rec.record.value = value
                out.successes.append(rec.record)
        elif kind == SmartModuleKind.ARRAY_MAP:
            for rec in sm_records:
                try:
                    results = hook(rec)
                except Exception as e:  # noqa: BLE001
                    out.error = self._error(e, rec)
                    break
                for item in results:
                    if isinstance(item, tuple):
                        k, v = item
                        k = k if k is None else bytes(k)
                    else:
                        k, v = None, item
                    out.successes.append(Record(value=bytes(v), key=k))
        elif kind == SmartModuleKind.AGGREGATE:
            acc = self.accumulator
            for rec in sm_records:
                try:
                    acc = bytes(hook(acc, rec))
                except Exception as e:  # noqa: BLE001
                    out.error = self._error(e, rec)
                    break
                rec.record.value = acc
                out.successes.append(rec.record)
            self.accumulator = acc
        else:  # pragma: no cover
            raise TypeError(f"not a transform kind: {kind}")
        return out
