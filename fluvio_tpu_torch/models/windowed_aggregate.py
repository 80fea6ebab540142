"""windowed-sum: a time-windowed running aggregate, materialized-view
style (the DSL program of ``fluvio_tpu/models/windowed_aggregate.py``).
The accumulator restarts at each ``window_ms`` timestamp bucket; each
output record's key is the window start (ASCII ms) and its value the
running in-window accumulator."""

from __future__ import annotations

from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import SmartModuleKind


def module() -> SmartModuleDef:
    m = SmartModuleDef(name="windowed-sum")
    m.dsl[SmartModuleKind.AGGREGATE] = dsl.AggregateProgram(
        kind="@param:kind=sum_int", window_ms="@param:window_ms=1000"
    )
    return m
