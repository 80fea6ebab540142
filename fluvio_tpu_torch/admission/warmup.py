"""Shape-bucket warm-up: pay a chain's first-dispatch costs before the
server admits its traffic.

The port's counterpart of ``fluvio_tpu/admission/warmup.py``. On the TPU
"warm" means XLA has compiled the chain's jit entry points for each shape
bucket. The port compiles no jit; what the first dispatch of a chain at a
shape pays on the card is:

- the native libraries' build at first use: the CUDA kernels (one
  ``nvcc`` a source, `gpu/native.py` ``KERNELS``) and the host record
  codec (`native/records.py`), each booked as a build event
  (`telemetry.compiles`);
- the lazy load of each kernel's module into the context at its first
  launch;
- the caching allocator's growth for the bucket's tensors (rows x width).

The pieces:

- `work_list(executor, widths)` — the chain's own shape buckets (the
  value-matrix width `buffer.bucket_width` and the row bucket
  `executor._bucket_rows` of each probe) x the kernels its stages can
  launch at that width (narrow or striped), read from the chain's DSL
  programs;
- `warm_executor(executor, widths, rows)` — dispatches a synthetic probe
  batch per (width, rows) through the REAL `process_buffer` path, so
  every one of those costs is paid as serving would pay it. Widths the
  chain cannot stage (past the stripe threshold with no striped
  lowering, or past the hard ceiling) are skipped and listed, not
  probed. Aggregate chains warm safely: the host and card carries are
  saved before the probes and put back after, so probe records never
  reach production aggregates;
- `warm_buffer(executor, buf)` — the exact-coverage warm: a shape twin of
  a real buffer (`probe_like`);
- `warm_entries` / `warm_specs` — build a chain from registry specs and
  warm it.

A probe that fails lands in ``report.errors`` (the rest still warm), is
logged at warning level and booked as a ``warmup-error`` telemetry event.
The serve-time gate (`spu/public_service._schedule_chain_warmup`) runs
this pass when ``AdmissionConfig.warmup`` is on and registers the warmed
buckets with the admission controller; the batcher pads coalesces into
them and counts any uncovered dispatch.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fluvio_tpu_torch.admission.types import AdmissionConfig, current_config
from fluvio_tpu_torch.smartengine.gpu.buffer import MAX_RECORD_WIDTH, RecordBuffer, bucket_width
from fluvio_tpu_torch.telemetry import TELEMETRY

logger = logging.getLogger(__name__)


@dataclass
class WarmupReport:
    """What one warm-up pass did (the deploy-gate evidence)."""

    chain: str
    widths: Tuple[int, ...] = ()
    buckets: Tuple[int, ...] = ()  # warmed value-matrix width buckets
    entry_points: List[dict] = field(default_factory=list)  # work list
    compiles: int = 0  # build events booked during the pass
    compile_s: float = 0.0
    persistent_hits: int = 0  # libraries found built (loaded)
    persistent_misses: int = 0  # libraries built
    jit_cache_hits: int = 0  # the port has no jit: stays 0
    launches: Dict[str, int] = field(default_factory=dict)  # kernel launches during the pass
    reserved_bytes: int = 0  # growth of the card's caching allocator during the pass
    skipped: List[str] = field(default_factory=list)  # widths the chain cannot stage
    wall_s: float = 0.0
    errors: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "chain": self.chain,
            "widths": list(self.widths),
            "buckets": list(self.buckets),
            "entry_points": self.entry_points,
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 3),
            "persistent_hits": self.persistent_hits,
            "persistent_misses": self.persistent_misses,
            "jit_cache_hits": self.jit_cache_hits,
            "launches": dict(self.launches),
            "reserved_bytes": self.reserved_bytes,
            "skipped": list(self.skipped),
            "wall_s": round(self.wall_s, 3),
            "errors": list(self.errors),
        }


def default_widths(threshold: Optional[int] = None, config: Optional[AdmissionConfig] = None):
    """``AdmissionConfig.warmup_widths`` or one narrow width and one past
    the stripe ``threshold`` (default: the engine's, 65,536), so both the
    narrow and the striped program warm."""
    cfg = config if config is not None else current_config()
    if cfg.warmup_widths:
        return tuple(int(w) for w in cfg.warmup_widths)
    if threshold is None:
        from fluvio_tpu_torch.smartengine.gpu.stripes import StripeParams

        threshold = StripeParams().threshold
    return (1024, int(threshold) + 1)


def default_rows(config: Optional[AdmissionConfig] = None) -> Tuple[int, ...]:
    """Row counts to probe per width (``AdmissionConfig.warmup_rows``,
    default 8). Rows bucket like width does (`executor._bucket_rows`),
    and each bucket grows the allocator anew, so synthetic probes cover
    the fixed per-chain cost plus the probed (rows, width) buckets, not
    every shape production traffic can arrive in; for exact corpus shapes
    use `warm_buffer` with a representative buffer."""
    cfg = config if config is not None else current_config()
    if cfg.warmup_rows:
        return tuple(int(r) for r in cfg.warmup_rows)
    return (8,)


def warmup_enabled(config: Optional[AdmissionConfig] = None) -> bool:
    return (config if config is not None else current_config()).warmup


def _walk(node):
    """Every DSL node under ``node`` (the program's dataclass tree)."""
    from fluvio_tpu_torch.smartmodule import dsl

    if isinstance(node, dsl.Expr):
        yield node
        for f in dataclasses.fields(node):
            yield from _walk(getattr(node, f.name))
    elif isinstance(node, (list, tuple)):
        for item in node:
            yield from _walk(item)


def stage_kernels(executor, striped: bool) -> Tuple[str, ...]:
    """The kernels (`cuda_kernels.LAUNCHES` names) the chain's stages can
    launch at a narrow (``striped`` False) or striped width: a JsonGet's
    span and extract, a regex that is no literal's DFA scan (narrow) or
    column composition (striped), and the glz link's decode / encode when
    the executor's `LinkParams` turn them on."""
    from fluvio_tpu_torch.ops.regex_dfa import literal_of
    from fluvio_tpu_torch.smartmodule import dsl

    names = set()
    for node in _walk(list(executor._programs)):
        if isinstance(node, dsl.JsonGet):
            names.update(("json_span_striped",) if striped else ("json_span", "extract"))
        elif isinstance(node, dsl.RegexMatch) and literal_of(node.pattern) is None:
            names.add("dfa_compose" if striped else "dfa_scan")
    if executor.link.compress:
        names.add("glz_decode")
    if executor.link.result_compress:
        names.add("glz_enc_match")
    return tuple(sorted(names))


def _stageable(executor, width: int) -> Optional[str]:
    """None when the executor stages records of ``width`` bytes, else the
    `GpuSpill` reason its dispatch would raise (the width ladder)."""
    bucket = bucket_width(max(width, 1))
    if bucket > MAX_RECORD_WIDTH:
        return "record-too-wide"
    if bucket > executor.stripe_params.threshold and executor._striped_chain() is None:
        return "record-too-wide-unstripeable"
    return None


def work_list(executor, widths: Sequence[int], rows: int = 8) -> List[dict]:
    """The chain's shape-bucket work list at these widths: one entry per
    (kernel, bucket) with its signature ``"<rows> x <width bucket>
    <narrow|striped>"`` — what `warm_executor` is about to pay for. A
    bucket whose stages launch no kernel (a literal filter, an aggregate
    over the record's digits) lists the chain's torch code as ``torch``."""
    from fluvio_tpu_torch.smartengine.gpu.executor import _bucket_rows

    out = []
    r = _bucket_rows(max(int(rows), 1))
    for width in widths:
        if _stageable(executor, width) is not None:
            continue
        bucket = bucket_width(max(int(width), 1))
        striped = bucket > executor.stripe_params.threshold
        sig = f"{r} x {bucket} {'striped' if striped else 'narrow'}"
        for kind in stage_kernels(executor, striped) or ("torch",):
            out.append({"kind": kind, "signature": sig})
    return out


def _probe_buffer(width: int, rows: int = 8):
    """Synthetic records at ``width`` bytes — benign JSON-ish bytes so
    structural kernels walk real work; values are never served."""
    width = max(width, 1)
    body = b'{"warmup":"' + b"x" * max(width - 16, 1) + b'"}'
    body = body[:width] if len(body) > width else body
    w = bucket_width(width)  # the value matrix stages at bucket widths
    values = np.zeros((rows, w), dtype=np.uint8)
    values[:, : len(body)] = np.frombuffer(body, dtype=np.uint8)
    lengths = np.full(rows, len(body), dtype=np.int32)
    return RecordBuffer.from_arrays(values, lengths, count=rows)


def probe_like(buf):
    """A shape twin of a real buffer: identical rows / width / lengths /
    key and timestamp columns, synthetic value bytes. Dispatching it pays
    EXACTLY what the real buffer's dispatch would pay (the same row and
    width buckets, the same flat size) without serving any production
    data."""
    dense = buf.dense_values()
    values = np.zeros_like(dense)
    mask = np.arange(dense.shape[1], dtype=np.int32)[None, :] < buf.lengths[:, None]
    values[mask] = ord("x")
    return RecordBuffer.from_arrays(
        values,
        buf.lengths.copy(),
        count=buf.count,
        keys=np.zeros_like(buf.keys),
        key_lengths=buf.key_lengths.copy(),
        offset_deltas=buf.offset_deltas.copy(),
        timestamp_deltas=buf.timestamp_deltas.copy(),
        base_offset=buf.base_offset,
        base_timestamp=buf.base_timestamp,
    )


# process-wide registry of distinct (chain sig, width bucket) pairs
# already warmed: the warmed_buckets gauge reads the DISTINCT total, so
# re-warming a chain (reconnects, configs sharing a sig) cannot inflate it
_WARMED_LOCK = threading.Lock()
_WARMED: dict = {}
# the last reports, newest last (the smoke and operators read them)
_RECENT: deque = deque(maxlen=64)


def _register_warmed(chain_sig: str, buckets) -> int:
    """Record warmed buckets; returns the process-wide distinct total
    (the gauge value)."""
    with _WARMED_LOCK:
        _WARMED.setdefault(chain_sig, set()).update(buckets)
        return sum(len(s) for s in _WARMED.values())


def reset_warm_registry() -> None:
    """Test isolation helper — pairs with TELEMETRY.reset()."""
    with _WARMED_LOCK:
        _WARMED.clear()
        _RECENT.clear()


def recent_reports() -> List[WarmupReport]:
    """The process's last warm-up reports, oldest first."""
    with _WARMED_LOCK:
        return list(_RECENT)


def _fail(report: WarmupReport, label: str, e: BaseException) -> None:
    """One failed step: into the report, the log and the flight recorder."""
    msg = f"{label}: {type(e).__name__}: {e}"
    report.errors.append(msg)
    logger.warning("warm-up of %s: %s", report.chain, msg)
    TELEMETRY._event("warmup-error", f"{report.chain} {msg}")


def _load_libraries(executor, report: WarmupReport) -> None:
    """Build (or load) what a first dispatch on this executor's device
    would: the record codec the consume path decodes with and, on the
    card, every CUDA kernel library."""
    from fluvio_tpu_torch.native import records as native_records

    try:
        native_records.load()
    except Exception as e:  # noqa: BLE001 — warm what we can
        _fail(report, "record codec", e)
    if executor.device.type == "cuda":
        from fluvio_tpu_torch.smartengine.gpu.native import KERNELS

        try:
            KERNELS.build()
        except Exception as e:  # noqa: BLE001
            _fail(report, "kernels", e)


def _warm_probes(executor, probes, report: WarmupReport) -> None:
    """Dispatch probe buffers through the real path; shared by the
    width-grid and shape-twin entry points. Stateful chains warm safely:
    host and card carries are saved before and put back after, so probes
    never leak into production aggregates."""
    import torch

    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    c0 = TELEMETRY.compile_totals()
    l0 = dict(cuda_kernels.LAUNCHES)
    on_card = executor.device.type == "cuda"
    r0 = torch.cuda.memory_reserved(executor.device) if on_card else 0
    t0 = time.perf_counter()
    _load_libraries(executor, report)
    carries0 = [tuple(c) for c in executor.carries]
    device_carries0 = executor._device_carries
    buckets = []
    for label, buf in probes:
        try:
            executor.process_buffer(buf)
            buckets.append(buf.width)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — warm what we can
            _fail(report, label, e)
    if executor.agg_configs:
        executor.carries = [tuple(c) for c in carries0]
        executor._device_carries = device_carries0
    report.buckets = tuple(dict.fromkeys(buckets))
    report.wall_s = time.perf_counter() - t0
    c1 = TELEMETRY.compile_totals()
    report.compiles = c1["compiles"] - c0["compiles"]
    report.compile_s = c1["seconds"] - c0["seconds"]
    report.persistent_hits = c1["persistent_hits"] - c0["persistent_hits"]
    report.persistent_misses = c1["persistent_misses"] - c0["persistent_misses"]
    report.launches = {
        k: v - l0.get(k, 0) for k, v in cuda_kernels.LAUNCHES.items() if v - l0.get(k, 0)
    }
    if on_card:
        report.reserved_bytes = torch.cuda.memory_reserved(executor.device) - r0
    total = _register_warmed(executor._chain_sig, report.buckets)
    with _WARMED_LOCK:
        _RECENT.append(report)
    TELEMETRY.gauge_set("warmed_buckets", total)


def warm_executor(executor, widths: Optional[Sequence[int]] = None, rows=None) -> WarmupReport:
    """Warm the shape buckets this executor would hit at the given
    record widths x row counts (``rows``: int or iterable; default
    `default_rows`), via the real dispatch path. Never raises: a probe
    that fails lands in ``report.errors`` and the rest still warm. A
    width the chain cannot stage is listed in ``report.skipped`` with the
    reason its dispatch would raise. Width/rows grids approximate real
    traffic shapes — `warm_buffer` covers a corpus exactly."""
    widths = tuple(widths) if widths else default_widths(executor.stripe_params.threshold)
    if rows is None:
        rows_list = default_rows()
    elif isinstance(rows, int):
        rows_list = (rows,)
    else:
        rows_list = tuple(rows)
    report = WarmupReport(chain=executor._chain_sig, widths=widths)
    try:
        report.entry_points = work_list(executor, widths, rows=rows_list[0])
    except Exception as e:  # noqa: BLE001 — the list is advisory
        _fail(report, "work-list", e)
    probes = []
    for width in widths:
        reason = _stageable(executor, width)
        if reason is not None:
            report.skipped.append(f"width {width}: {reason}")
            continue
        for r in rows_list:
            try:
                probes.append((f"width {width} rows {r}", _probe_buffer(width, rows=r)))
            except Exception as e:  # noqa: BLE001 — warm what we can
                _fail(report, f"width {width} rows {r}", e)
    _warm_probes(executor, probes, report)
    return report


def warm_buffer(executor, buf) -> WarmupReport:
    """Warm EXACTLY what a real buffer's dispatch would pay, by
    dispatching its shape twin (`probe_like`) — rows, width and flat size
    all match, so a later dispatch of the real buffer books no build and
    grows no allocator pool for its shape."""
    report = WarmupReport(chain=executor._chain_sig, widths=(int(buf.width),))
    try:
        probes = [(f"shape-twin {buf.rows}x{buf.width}", probe_like(buf))]
    except Exception as e:  # noqa: BLE001
        _fail(report, "probe-like", e)
        return report
    _warm_probes(executor, probes, report)
    return report


def warm_entries(entries, widths: Optional[Sequence[int]] = None, rows: int = 8, device=None):
    """Build the chain executor for registry entries on ``device`` (None:
    the card) and warm it. Returns (executor, report); (None,
    report-with-error) when the chain does not lower (the engine would
    refuse it at ``initialize``)."""
    from fluvio_tpu_torch.smartengine.engine import resolve_device
    from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor

    executor = GpuChainExecutor.try_build(list(entries), resolve_device(device))
    if executor is None:
        report = WarmupReport(chain="unlowerable", widths=tuple(widths or ()))
        report.errors.append(
            "chain does not lower to the GPU executor: nothing to warm "
            "(the engine refuses it at initialize)"
        )
        return None, report
    return executor, warm_executor(executor, widths, rows=rows)


def warm_specs(
    specs: Sequence[Tuple[str, Optional[dict]]],
    widths: Optional[Sequence[int]] = None,
    rows: int = 8,
    device=None,
):
    """`warm_entries` over built-in model registry names (the bench's
    spec format ``[(name, params), ...]``)."""
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine.config import SmartModuleConfig

    entries = [
        (lookup(name), SmartModuleConfig(params=dict(params or {}))) for name, params in specs
    ]
    return warm_entries(entries, widths=widths, rows=rows, device=device)
