"""Pipeline telemetry of the port: per-batch phase spans, latency
histograms, and a scrapeable metrics surface.

The port's counterpart of ``fluvio_tpu/telemetry/``, module for module and
name for name, with three differences:

- the port reads no environment variable: every setting is a field of
  `TelemetryConfig` (defaults: the JAX package's), applied with
  ``configure(cfg)`` — the SPU server applies ``SpuConfig.telemetry``;
  nothing is armed at import (the trace sink's ``install_env_sink`` is
  `install_sink`, called by `configure`);
- the compile events are the builds of the port's native libraries
  (``compiles.note_build``); the JAX package's jit wrapper has no
  counterpart;
- the memory ledger reconciles against the card's allocator
  (``torch.cuda.memory_stats``) and the SLO breach capture is a
  ``torch.profiler`` capture.

Modules:

- `spans`     — per-batch pipeline spans with FIXED phase labels,
                captured in a bounded ring buffer (plus the instant-
                event ring the flight recorder draws markers from),
- `flow`      — per-slice causal flow records,
- `histogram` — log-bucketed (HDR-style) latency histograms: fixed
                bucket array, mergeable, percentile interpolation,
- `registry`  — the process-wide `TELEMETRY` singleton the hot paths
                record into and the export surfaces snapshot from, and
                `TelemetryConfig`,
- `prometheus`— text-format exposition of a snapshot,
- `compiles`  — build events of the native libraries (count, seconds,
                built or cached),
- `trace`     — Chrome-trace/Perfetto export: continuous bounded file
                sink (``trace_path``) plus the on-demand renderer behind
                the monitoring socket,
- `timeseries`— rolling-window layer: bounded ring of cumulative
                snapshots; windowed rate/p50/p99/error-ratio per chain
                and per path family by mergeable-histogram delta,
- `slo`       — declarative SLO targets evaluated with multi-window
                burn-rate logic into per-chain ok|warn|breach verdicts;
                breaches emit flight-recorder instant events and
                (``slo_profile_dir``) bounded torch.profiler captures,
- `memory`    — the per-owner device-memory ledger: typed
                acquire/release on every allocation seam, TTL leak
                detection, allocator reconciliation, and the
                ``hbm_headroom`` budget,
- `lag`       — consumer lag and record age per chain@topic/partition.

Always-on contract: one monotonic clock pair per phase per batch, no
per-record work; ``TelemetryConfig(enabled=False)`` disables span and
histogram capture entirely (event counters stay on — they are as cheap
as the existing `SmartModuleChainMetrics` adds).
"""

from fluvio_tpu_torch.telemetry.histogram import LatencyHistogram
from fluvio_tpu_torch.telemetry.flow import SLICE_PHASES, FlowRing, SliceFlow
from fluvio_tpu_torch.telemetry.spans import (
    PHASES,
    BatchSpan,
    EventRing,
    InstantEvent,
    SpanRing,
)
from fluvio_tpu_torch.telemetry.registry import (
    TELEMETRY,
    PipelineTelemetry,
    TelemetryConfig,
)
from fluvio_tpu_torch.telemetry.prometheus import render_prometheus
from fluvio_tpu_torch.telemetry.compiles import note_build
from fluvio_tpu_torch.telemetry.trace import (
    TraceFileSink,
    install_sink,
    render_trace,
    trace_json,
)
from fluvio_tpu_torch.telemetry.timeseries import TimeSeries, WindowDelta
from fluvio_tpu_torch.telemetry import slo as _slo
from fluvio_tpu_torch.telemetry.slo import SloEngine, health_snapshot
from fluvio_tpu_torch.telemetry.memory import (
    MemoryLedger,
    memory_snapshot,
)


def configure(config: TelemetryConfig) -> None:
    """Apply ``config`` to the process: the registry's switches, the
    continuous trace sink (armed, moved or disarmed), and a fresh SLO
    engine on the next read (its rules, windows and profile settings
    come from the config). Counters and rings keep what they hold."""
    TELEMETRY.apply_config(config)
    install_sink()
    _slo.reset_engine()


__all__ = [
    "LatencyHistogram",
    "SLICE_PHASES",
    "FlowRing",
    "SliceFlow",
    "PHASES",
    "BatchSpan",
    "EventRing",
    "InstantEvent",
    "SpanRing",
    "TELEMETRY",
    "PipelineTelemetry",
    "TelemetryConfig",
    "configure",
    "render_prometheus",
    "note_build",
    "TraceFileSink",
    "install_sink",
    "render_trace",
    "trace_json",
    "TimeSeries",
    "WindowDelta",
    "SloEngine",
    "health_snapshot",
    "MemoryLedger",
    "memory_snapshot",
]
