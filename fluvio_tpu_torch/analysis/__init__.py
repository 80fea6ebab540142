"""Chain preflight static analysis for the port.

The port's counterpart of ``fluvio_tpu/analysis/``'s spec pass
(`analysis.spec`): walk a SmartModule chain spec and predict, per
record-width bucket, the path the port's executor takes — fused, striped,
or a raise with its `GpuSpill` reason — using the same reason strings as
the runtime's decline and spill counters, against the engine's settings
(`resolve_gates`). The JAX package's jaxpr pass and its repo linters have
no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from fluvio_tpu_torch.analysis.spec import (
    ERROR,
    INFO,
    WARN,
    ChainReport,
    Hazard,
    PathPrediction,
    analyze_entries,
    analyze_named,
    predict_link_variant,
    resolve_gates,
)

__all__ = [
    "ERROR", "INFO", "WARN",
    "ChainReport", "Hazard", "PathPrediction",
    "analyze_entries", "analyze_named", "resolve_gates", "predict_link_variant",
    "preflight_for_specs",
]


def preflight_for_specs(specs: Sequence[Tuple[str, Optional[dict]]], width: int,
                        engine=None) -> dict:
    """Compact preflight record for one chain spec at one record width:
    the predicted path and its reason strings. ``specs`` is the bench's
    format, ``[(model name, params)]``."""
    report = analyze_named(specs, widths=(width,), engine=engine)
    pred = report.predictions[0]
    out = {"path": pred.path, "link_variant": pred.link_variant}
    if pred.spill_reasons:
        out["spill_reasons"] = list(pred.spill_reasons)
    if pred.declines:
        out["declines"] = list(pred.declines)
    if pred.causes:
        out["causes"] = list(pred.causes)
    errors = report.errors()
    if errors:
        out["errors"] = len(errors)
    return out
