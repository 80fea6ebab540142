"""Level-1 preflight: predict the port executor's path from a chain's spec.

The port's counterpart of ``fluvio_tpu/analysis/spec.py``. It walks a
SmartModule chain's resolved DSL programs and predicts, per record-width
bucket, which path the port's executor takes. The port has no
interpreter, so a batch runs one of two paths or raises:

- ``fused``    — the narrow layout (bucket at or below the stripe
                 threshold);
- ``striped``  — a wider bucket of a chain with a striped lowering;
- ``raise``    — the dispatch raises `GpuSpill` with the reason in
                 ``spill_reasons``: ``record-too-wide-unstripeable`` (a
                 wider bucket, no striped lowering) or
                 ``record-too-wide`` (past ``MAX_RECORD_WIDTH``), the
                 reason strings the runtime's spill and decline counters
                 use. A chain that does not lower as a whole is predicted
                 ``raise`` (``unlowerable``): a DSL program outside the
                 lowerable subset is refused at ``initialize``
                 (``EngineError``); a module with no DSL program runs as a
                 host hook segment, whose path this level does not
                 predict.

The prediction walks the port's own rules, not a mirror of them:
`executor.lower_chain` (what `GpuChainExecutor.try_build` lowers, with no
device and no telemetry touched), `stripes.try_build_striped` (the
striped lowering) and the dispatch-time width ladder
(`GpuChainExecutor.dispatch_buffer`). A preflight never moves the
counters it predicts. ``link_variant`` is the configured up-link form of
a batch in the bucket (``raw``, or ``glz-cuda`` / ``glz-plain`` by route
with the glz link on); a batch the compressor declines ships raw with its
reason on the decline counter.

The JAX package's jaxpr pass (``analysis/jaxpr_lint.py``) has no
counterpart here yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ERROR = "error"
WARN = "warn"
INFO = "info"

_SEVERITY_RANK = {ERROR: 0, WARN: 1, INFO: 2}


@dataclass
class Hazard:
    """One preflight finding. ``level`` is error/warn/info; ``code`` a
    short stable slug; ``source`` names the pass that found it."""

    level: str
    code: str
    message: str
    source: str = "spec"

    def to_dict(self) -> dict:
        return {"level": self.level, "code": self.code, "message": self.message,
                "source": self.source}


@dataclass
class PathPrediction:
    """Predicted executed path for one record-width bucket."""

    width: int  # probed max record value width (pre-bucket)
    width_bucket: int
    path: str  # fused | striped | raise
    spill_reasons: Tuple[str, ...] = ()  # the GpuSpill reason a raise carries
    declines: Tuple[str, ...] = ()
    causes: Tuple[str, ...] = ()
    link_variant: str = "raw"  # the configured up-link form (TELEMETRY.link_variants)

    def to_dict(self) -> dict:
        return {
            "width": self.width,
            "width_bucket": self.width_bucket,
            "path": self.path,
            "spill_reasons": list(self.spill_reasons),
            "declines": list(self.declines),
            "causes": list(self.causes),
            "link_variant": self.link_variant,
        }


@dataclass
class ChainReport:
    """Full preflight report for one chain."""

    chain_sig: str
    gates: Dict
    predictions: List[PathPrediction] = field(default_factory=list)
    hazards: List[Hazard] = field(default_factory=list)

    def errors(self) -> List[Hazard]:
        return [h for h in self.hazards if h.level == ERROR]

    def prediction_for(self, width: int) -> Optional[PathPrediction]:
        for p in self.predictions:
            if p.width == width:
                return p
        return None

    def to_dict(self) -> dict:
        return {
            "chain": self.chain_sig,
            "gates": dict(self.gates),
            "predictions": [p.to_dict() for p in self.predictions],
            "hazards": [h.to_dict() for h in sorted(self.hazards,
                                                    key=lambda h: _SEVERITY_RANK[h.level])],
        }


def resolve_gates(engine=None) -> dict:
    """Every setting the path decision reads, as an engine resolves them
    (``engine``: a `SmartEngine`; None: an engine's defaults on the
    card): whether CUDA is there, the device, the stripe geometry, the
    hard width ceiling, the glz link settings and the windowed state's
    emission mode."""
    import torch

    from fluvio_tpu_torch.smartengine.gpu.buffer import MAX_RECORD_WIDTH
    from fluvio_tpu_torch.smartengine.gpu.glz import LinkParams
    from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams
    from fluvio_tpu_torch.windows.spec import delta_enabled

    stripes = engine.stripes if engine is not None else StripeParams()
    link = engine.link if engine is not None else LinkParams()
    return {
        "cuda_available": torch.cuda.is_available(),
        "device": engine.device if engine is not None else "cuda",
        "stripe_threshold": stripes.threshold,
        "stripe_width": stripes.width,
        "stripe_overlap": stripes.overlap,
        "max_record_width": MAX_RECORD_WIDTH,
        "link_compress": link.compress,
        "result_compress": link.result_compress,
        "link_chunk": link.chunk,
        "window_delta": delta_enabled(),
    }


def chain_sig(stages) -> str:
    """The executor's chain signature for lowered stages (the name
    `GpuChainExecutor._chain_sig` renders)."""
    return "+".join(
        type(s).__name__.lstrip("_").replace("Stage", "").lower() for s in stages
    ) or "empty"


def _bucketed(width: int) -> int:
    from fluvio_tpu_torch.smartengine.gpu.buffer import bucket_width

    return bucket_width(max(width, 1))


def predict_path(width: int, gates: dict, lowerable: bool, striped_ok: bool) -> PathPrediction:
    """The dispatch-time width ladder, as one pure function."""
    bucket = _bucketed(width)
    if not lowerable:
        return PathPrediction(width, bucket, "raise",
                              causes=("chain is not GPU-lowerable: the engine refuses it at "
                                      "initialize",))
    if bucket > gates["max_record_width"]:
        return PathPrediction(width, bucket, "raise", spill_reasons=("record-too-wide",),
                              causes=(f"record bucket {bucket} exceeds the hard ceiling "
                                      f"({gates['max_record_width']})",))
    if bucket > gates["stripe_threshold"]:
        if striped_ok:
            return PathPrediction(width, bucket, "striped")
        return PathPrediction(width, bucket, "raise",
                              spill_reasons=("record-too-wide-unstripeable",),
                              causes=(f"record bucket {bucket} exceeds the narrow layout "
                                      f"({gates['stripe_threshold']}) and the chain has no "
                                      "striped lowering",))
    return PathPrediction(width, bucket, "fused")


def predict_link_variant(gates: dict, path: str) -> str:
    """The configured up-link form of a batch on ``path``."""
    if path == "raise" or not gates["link_compress"]:
        return "raw"
    return "glz-plain" if gates["device"] == "cpu" else "glz-cuda"


def analyze_entries(entries, widths: Optional[Sequence[int]] = None, engine=None) -> ChainReport:
    """Level-1 report for a chain of (SmartModuleDef, SmartModuleConfig)
    entries on ``engine``'s settings (None: the defaults). ``widths`` are
    the max record value widths to probe (default: one narrow width and
    one past the stripe threshold, so the report covers both regimes)."""
    from fluvio_tpu_torch.smartengine.gpu import stripes as stripes_mod
    from fluvio_tpu_torch.smartengine.gpu.executor import lower_chain
    from fluvio_tpu_torch.smartmodule import dsl

    gates = resolve_gates(engine)
    if widths is None:
        widths = (1024, gates["stripe_threshold"] + 1)
    lowered = lower_chain(list(entries))
    if lowered is None:
        report = ChainReport("unlowerable", gates)
        report.hazards.append(Hazard(
            ERROR, "unlowerable",
            "a module carries no DSL program the GPU lowering supports: a DSL program "
            "outside it is refused at initialize, and a Python hook runs on the host, "
            "which this prediction does not cover"))
        report.predictions = [predict_path(w, gates, False, False) for w in widths]
        return report
    stages, programs, _agg = lowered
    striped_ok = stripes_mod.try_build_striped(
        programs, stages, gates["stripe_width"], gates["stripe_overlap"]) is not None
    report = ChainReport(chain_sig(stages), gates)
    for prog in programs:
        if isinstance(prog, dsl.ArrayMapProgram) and prog.mode == "json_array":
            report.hazards.append(Hazard(
                INFO, "data-dependent-spill",
                "json_array explode: a record that is no JSON array ends its batch with a "
                "transform error (the stages up to the explode run again on the card)"))
    for w in widths:
        pred = predict_path(w, gates, True, striped_ok)
        pred.link_variant = predict_link_variant(gates, pred.path)
        report.predictions.append(pred)
        if pred.path == "raise":
            report.hazards.append(Hazard(
                ERROR, "spill:" + pred.spill_reasons[0],
                f"records of width {w} raise GpuSpill: " + "; ".join(pred.causes)))
    return report


def analyze_named(specs: Sequence[Tuple[str, Optional[dict]]],
                  widths: Optional[Sequence[int]] = None, engine=None) -> ChainReport:
    """`analyze_entries` over built-in model registry names (the bench's
    spec format): ``[(name, params), ...]``."""
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine.config import SmartModuleConfig

    entries = [(lookup(name), SmartModuleConfig(params=dict(params or {})))
               for name, params in specs]
    return analyze_entries(entries, widths=widths, engine=engine)
