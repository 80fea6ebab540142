"""Built-in SmartModules of the port: DSL programs only.

Name-based resolution (``lookup``) mirrors ``fluvio_tpu.models.lookup``
for the modules the port runs.
"""

from __future__ import annotations

from fluvio_tpu_torch.models import (
    aggregate_sum,
    array_map_explode,
    json_map,
    json_regex_filter,
    regex_filter,
    windowed_aggregate,
)
from fluvio_tpu_torch.smartmodule.sdk import SmartModuleDef

_REGISTRY = {
    "aggregate-sum": aggregate_sum.canned("sum_int"),
    "aggregate-count": aggregate_sum.canned("count"),
    "aggregate-max": aggregate_sum.canned("max_int"),
    "aggregate-min": aggregate_sum.canned("min_int"),
    "word-count": aggregate_sum.canned("word_count"),
    "aggregate-field": aggregate_sum.field_module,
    "array-map-json": array_map_explode.module,
    "array-map-lines": array_map_explode.lines_module,
    "json-map": json_map.module,
    "json-regex-filter": json_regex_filter.module,
    "regex-filter": regex_filter.module,
    "windowed-sum": windowed_aggregate.module,
}


def lookup(name: str) -> SmartModuleDef:
    """Instantiate a built-in module by registry name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown built-in SmartModule {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
