"""aggregate-sum / -count / -max / -min, word-count and aggregate-field:
running reductions whose output value is the accumulator after each
record, in decimal. DSL programs of ``fluvio_tpu/models/aggregate_sum.py``;
the port lowers them to a segmented scan whose carry stays on the card."""

from __future__ import annotations

from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef
from fluvio_tpu_torch.smartmodule.types import SmartModuleKind


def canned(kind: str):
    """Factory of the canned reduction ``kind`` (``sum_int``, ``count``,
    ``word_count``, ``max_int``, ``min_int``)."""

    def factory() -> SmartModuleDef:
        m = SmartModuleDef(name=f"aggregate-{kind}")
        m.dsl[SmartModuleKind.AGGREGATE] = dsl.AggregateProgram(kind=kind)
        return m

    return factory


def field_module() -> SmartModuleDef:
    """General form: reduce the integer prefix of the top-level JSON field
    ``field`` (default ``n``) with the monoid ``combine`` (``add``, ``max``
    or ``min``; default ``add``), in tumbling windows of ``window_ms``
    when it is not 0."""
    m = SmartModuleDef(name="aggregate-field")
    m.dsl[SmartModuleKind.AGGREGATE] = dsl.AggregateProgram(
        contribution=dsl.ParseInt(arg=dsl.JsonGet(arg=dsl.Value(), key="@param:field=n")),
        combine="@param:combine=add",
        window_ms="@param:window_ms=0",
    )
    return m
