"""Chain-level SLO engine: declarative targets, multi-window burn-rate
verdicts, and breach-triggered deep evidence capture.

The port's copy of ``fluvio_tpu/telemetry/slo.py``. The rule spec, the
profile directory, its dwell and cooldown and the memory budget are
``TelemetryConfig`` fields; the breach capture is a ``torch.profiler``
capture (CPU and CUDA activity on the card, CPU only on a CPU engine)
exported as a Chrome trace, where the JAX package takes a
``jax.profiler`` trace.

Diba (arXiv:2304.01659) argues a stream processor must budget its
reconfiguration cliffs explicitly; for this engine those cliffs are
first-call kernel builds (metered by the build telemetry),
failed batches, and unbounded queue growth. This module turns the
raw cumulative telemetry into evaluated SLOs over rolling windows
(telemetry/timeseries.py) — the machine-readable health signal the
ROADMAP's admission-control/backpressure work keys on.

Rules (defaults overridable via the ``TelemetryConfig.slo`` grammar):

==================  =====================================================
``e2e_p99``         per-chain end-to-end p99 over the short window
``spill_ratio``     (spills + interpreter batches) / batches
``error_rate``      (retries + quarantined) / batches
``compile_budget``  compile wall seconds per wall second of window
``recompile_rate``  compiles per minute (the storm signal, windowed)
``queue_depth``     ``inflight_queue_depth`` gauge ceiling
``hbm_staged``      ``hbm_staged_bytes`` gauge ceiling
``consumer_lag``    records behind the replica high watermark, per
                    ``chain@topic/partition`` (telemetry/lag.py join)
``record_age_p99``  end-to-end append-wall-time -> served p99, per
                    ``chain@topic/partition``
==================  =====================================================

Grammar — ``;``-separated entries, ``rule:field=value[,field=value]``::

    TelemetryConfig(slo="e2e_p99:target_ms=250;queue_depth:target=16;spill_ratio:off=1")

Fields: ``target`` (rule units), ``target_ms`` (latency rules),
``warn`` (warn fraction of target, default 0.75), ``off=1`` (disable).

Burn-rate verdicts: each rule evaluates over the SHORT window (the most
recent one) and the LONG window (everything retained). ``breach`` means
the budget is being burned NOW (short over target, and long over target
when long history exists); ``warn`` means the budget is consumed but
burning has stopped (long over target, short clean) or observed is
within the warn fraction of the target. Windows age out
deterministically (injectable clock), so a verdict recovers to ``ok``
without process restarts.

Breach hook: every verdict TRANSITION into ``breach`` (per chain+rule)
emits a flight-recorder instant event (Perfetto-visible next to the
batch spans it indicts) and, when ``slo_profile_dir`` names a directory,
captures one bounded ``torch.profiler`` window into it
(``slo_breach_NNN/trace.json``) — device-level truth for the offending
interval, at most one capture per ``slo_profile_cooldown_s`` (default
60). One profiler runs at a time: with another already active the
capture is refused and the refusal lands in the flight recorder. On the
card a capture that fails raises from `SloEngine.join_profile_capture`.

Zero-cost contract: nothing here runs per batch. Evaluation is pulled
by readers (monitoring socket, Prometheus scrape); with capture off
the evaluator returns a disabled verdict without
touching the time-series layer.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from fluvio_tpu_torch.telemetry.registry import (
    TELEMETRY,
    PipelineTelemetry,
    TelemetryConfig,
)
from fluvio_tpu_torch.telemetry.timeseries import TimeSeries, WindowDelta

logger = logging.getLogger(__name__)

#: the file a breach capture writes inside its ``slo_breach_NNN`` dir
PROFILE_TRACE = "trace.json"

#: captures a breach takes on a card before it fails: the profiler now
#: and then records no device activity at all, so a capture holding no
#: CUDA kernel is taken again, and only one that holds some is kept
CAPTURE_ATTEMPTS = 3


def trace_kernel_events(path: str) -> int:
    """The CUDA kernel events (``"cat": "kernel"``) of a Chrome trace."""
    import json

    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return sum(1 for e in events if e.get("cat") == "kernel")


def _probe(device) -> None:
    """The small op that guarantees activity inside a capture's window:
    on a card it runs on a stream of its own and waits on its own event,
    so the capture never waits for the engine's work in flight."""
    import torch

    if device is None:
        torch.ones(1024).add_(1)
        return
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        x = torch.ones(1024, device=device)
        x.add_(1)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()

# the engine-wide pseudo-chain the non-per-chain rules report under
ENGINE_CHAIN = "_engine"

VERDICTS = ("ok", "warn", "breach")
_RANK = {v: i for i, v in enumerate(VERDICTS)}


@dataclass(frozen=True)
class SloRule:
    """One declarative target. ``latency`` rules accept ``target_ms``
    in the grammar; every rule accepts ``target``/``warn``/``off``."""

    name: str
    target: float
    unit: str
    per_chain: bool = False
    latency: bool = False
    warn_ratio: float = 0.75
    enabled: bool = True


DEFAULT_RULES: Tuple[SloRule, ...] = (
    SloRule("e2e_p99", 2.0, "s", per_chain=True, latency=True),
    SloRule("spill_ratio", 0.05, "ratio"),
    SloRule("error_rate", 0.02, "ratio"),
    SloRule("compile_budget", 0.25, "s/s"),
    SloRule("recompile_rate", 8.0, "compiles/min"),
    SloRule("queue_depth", 128.0, "chunks"),
    SloRule("hbm_staged", 2e9, "bytes"),
    # streaming-lag rules: the canonical Kafka-class health
    # signals, keyed per chain@topic/partition by the lag engine's
    # offset/high-watermark join — so a hot partition breaches (and the
    # admission controller sheds it) without touching its siblings
    SloRule("consumer_lag", 65536.0, "records", per_chain=True),
    SloRule("record_age_p99", 60.0, "s", per_chain=True, latency=True),
    # device-memory headroom: the ledger total against the mem_budget
    # ceiling. Disabled until a budget is set — rules_from_config
    # arms it with target=budget so a runaway window
    # bank sheds admission BEFORE the allocator fails
    SloRule("hbm_headroom", 4e9, "bytes", enabled=False),
)


def parse_slo_spec(
    spec: str, base: Tuple[SloRule, ...] = DEFAULT_RULES
) -> Tuple[SloRule, ...]:
    """Apply a ``TelemetryConfig.slo`` spec string to the default rule
    set. Raises ValueError on malformed input (the config loader catches
    and falls back to defaults; programmatic callers get the error)."""
    rules = {r.name: r for r in base}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, fields = entry.partition(":")
        name = name.strip()
        if not sep or name not in rules:
            raise ValueError(
                f"unknown SLO rule {name!r} (known: {sorted(rules)})"
            )
        rule = rules[name]
        for field in fields.split(","):
            key, sep, value = field.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(f"SLO field needs key=value, got {field!r}")
            if key == "target":
                rule = replace(rule, target=float(value))
            elif key == "target_ms" and rule.latency:
                rule = replace(rule, target=float(value) / 1000.0)
            elif key == "warn":
                rule = replace(rule, warn_ratio=float(value))
            elif key == "off":
                rule = replace(
                    rule, enabled=value.strip().lower() in ("0", "false", "")
                )
            else:
                raise ValueError(
                    f"unknown SLO field {key!r} for rule {name!r}"
                )
        rules[name] = rule
    return tuple(rules.values())


def _apply_mem_budget(
    rules: Tuple[SloRule, ...], budget: int
) -> Tuple[SloRule, ...]:
    """Arm ``hbm_headroom`` with the ledger budget as its target when a
    budget is set. An ``slo`` entry for the rule wins — the explicit spec
    is the operator overriding the ambient budget."""
    if budget <= 0:
        return rules
    return tuple(
        replace(r, target=float(budget), enabled=True)
        if r.name == "hbm_headroom"
        else r
        for r in rules
    )


def rules_from_config(
    config: Optional[TelemetryConfig] = None,
) -> Tuple[SloRule, ...]:
    cfg = config if config is not None else TELEMETRY.config
    spec = cfg.slo
    budget = int(cfg.mem_budget or 0)
    explicit = spec and "hbm_headroom" in spec
    if not spec:
        return _apply_mem_budget(DEFAULT_RULES, budget)
    try:
        rules = parse_slo_spec(spec)
    except ValueError as e:
        logger.error("ignoring malformed slo spec %r: %s", spec, e)
        return _apply_mem_budget(DEFAULT_RULES, budget)
    return rules if explicit else _apply_mem_budget(rules, budget)


def _observe(rule: SloRule, delta: WindowDelta) -> Dict[str, float]:
    """{chain: observed} for one rule over one window delta. A chain
    (or the engine) with nothing to observe is simply absent."""
    if rule.name == "e2e_p99":
        return {
            chain: h.percentile(99)
            for chain, h in delta.chain_hists().items()
        }
    if rule.name == "consumer_lag":
        # point-in-time join from the NEW snapshot (a level, like the
        # gauge ceilings): short and long windows agree by construction,
        # so a backlog injected NOW breaches on the next evaluation and
        # ages out the moment the join reads a drained partition
        return dict(delta.lag)
    if rule.name == "record_age_p99":
        return {
            key: h.percentile(99)
            for key, h in delta.record_age_hists().items()
        }
    if rule.name in ("queue_depth", "hbm_staged", "hbm_headroom"):
        gauge = {
            "queue_depth": "inflight_queue_depth",
            "hbm_staged": "hbm_staged_bytes",
            # the full ledger total (all owners), not just staging —
            # headroom is a property of the whole device
            "hbm_headroom": "device_memory_bytes",
        }[rule.name]
        return {ENGINE_CHAIN: float(delta.gauges.get(gauge, 0.0))}
    counters = delta.counters()
    batches = delta.batches()
    if rule.name == "spill_ratio":
        if not batches:
            return {}
        paths = delta.path_hists()
        interp = paths.get("interpreter")
        spilled = counters.get("spills", 0) + (interp.count if interp else 0)
        return {ENGINE_CHAIN: spilled / batches}
    if rule.name == "error_rate":
        if not batches:
            return {}
        errs = counters.get("retries", 0) + counters.get("quarantined", 0)
        return {ENGINE_CHAIN: errs / batches}
    if rule.name == "compile_budget":
        return {
            ENGINE_CHAIN: counters.get("compile_seconds", 0.0)
            / delta.duration_s
        }
    if rule.name == "recompile_rate":
        return {
            ENGINE_CHAIN: counters.get("compiles", 0)
            * 60.0
            / delta.duration_s
        }
    return {}  # pragma: no cover — fixed rule vocabulary


def _decide(
    rule: SloRule, short: Optional[float], long: Optional[float]
) -> str:
    """Multi-window burn-rate verdict. ``breach`` = burning NOW (short
    over target, long confirming when it exists); ``warn`` = budget
    consumed but no longer burning, or observed inside the warn band."""
    if short is None and long is None:
        return "ok"
    s_bad = short is not None and short > rule.target
    l_bad = long is not None and long > rule.target
    if s_bad and (long is None or l_bad):
        return "breach"
    warn_at = rule.warn_ratio * rule.target
    if s_bad or l_bad:
        return "warn"
    if (short is not None and short > warn_at) or (
        long is not None and long > warn_at
    ):
        return "warn"
    return "ok"


def worst(verdicts) -> str:
    v = "ok"
    for x in verdicts:
        if _RANK.get(x, 0) > _RANK[v]:
            v = x
    return v


class SloEngine:
    """Evaluates the rule set against the time-series layer and owns
    the breach hooks (instant event + bounded profiler capture)."""

    def __init__(
        self,
        telemetry: Optional[PipelineTelemetry] = None,
        timeseries: Optional[TimeSeries] = None,
        rules: Optional[Tuple[SloRule, ...]] = None,
        clock=time.monotonic,
        profile_dir: Optional[str] = None,
        profile_cooldown_s: Optional[float] = None,
    ) -> None:
        self.telemetry = telemetry if telemetry is not None else TELEMETRY
        self.clock = clock
        self.timeseries = (
            timeseries
            if timeseries is not None
            else TimeSeries(self.telemetry, clock=clock)
        )
        cfg = self.telemetry.config
        self.rules = (
            rules if rules is not None else rules_from_config(cfg)
        )
        self.profile_dir = (
            profile_dir if profile_dir is not None else cfg.slo_profile_dir
        )
        self.profile_cooldown_s = (
            profile_cooldown_s
            if profile_cooldown_s is not None
            else float(cfg.slo_profile_cooldown_s)
        )
        self.profile_dwell_ms = float(cfg.slo_profile_ms)
        self._lock = threading.Lock()
        self._verdicts: Dict[Tuple[str, str], str] = {}
        self._last_profile_t: Optional[float] = None
        self._profile_seq = 0
        self._profile_thread: Optional[threading.Thread] = None
        self._profile_error: Optional[BaseException] = None
        self.profile_captures: List[str] = []
        # captures refused because another profiler was already active
        self.profile_refused: List[str] = []

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, tick: bool = True) -> dict:
        """The verdict document every health surface renders from (CLI
        table, socket ``health`` mode, Prometheus verdict states, bench
        ``slo`` block). Pull-based: ticks the window ring, computes
        short/long observations, applies burn-rate logic, fires breach
        hooks on transitions."""
        if not self.telemetry.enabled:
            return {"enabled": False, "verdict": "disabled", "chains": {}}
        ts = self.timeseries
        if tick:
            ts.maybe_tick()
        short = ts.delta(1)
        long = ts.delta(ts.capacity)
        chains: Dict[str, dict] = {}
        transitions: List[Tuple[str, str, str]] = []
        for rule in self.rules:
            if not rule.enabled:
                continue
            s_obs = _observe(rule, short) if short is not None else {}
            l_obs = _observe(rule, long) if long is not None else {}
            names = set(s_obs) | set(l_obs)
            if not rule.per_chain:
                names.add(ENGINE_CHAIN)
            with self._lock:
                # a chain absent from BOTH windows has aged out of the
                # retained history: drop its verdict memory so a future
                # breach counts as a fresh transition (event + capture)
                for key in [
                    k
                    for k in self._verdicts
                    if k[1] == rule.name and k[0] not in names
                ]:
                    self._verdicts.pop(key)
            for chain in names:
                s = s_obs.get(chain)
                l = l_obs.get(chain)
                verdict = _decide(rule, s, l)
                evidence = {
                    "verdict": verdict,
                    "target": rule.target,
                    "unit": rule.unit,
                    "observed": None if s is None else round(s, 6),
                    "window_s": (
                        round(short.duration_s, 3) if short else None
                    ),
                    "long_observed": None if l is None else round(l, 6),
                    "long_window_s": (
                        round(long.duration_s, 3) if long else None
                    ),
                }
                entry = chains.setdefault(chain, {"rules": {}})
                entry["rules"][rule.name] = evidence
                key = (chain, rule.name)
                with self._lock:
                    prev = self._verdicts.get(key, "ok")
                    self._verdicts[key] = verdict
                    # bounded like the registry's breaker map: chains
                    # age out of verdict memory with their histograms
                    while len(self._verdicts) > 512:
                        self._verdicts.pop(next(iter(self._verdicts)))
                if verdict == "breach" and prev != "breach":
                    transitions.append((chain, rule.name, _fmt_breach(
                        chain, rule, s, l
                    )))
        for entry in chains.values():
            entry["verdict"] = worst(
                e["verdict"] for e in entry["rules"].values()
            )
        doc = {
            "enabled": True,
            "verdict": worst(e["verdict"] for e in chains.values()),
            "window_s": ts.window_s,
            "windows": ts.capacity,
            "retained_windows": ts.retained_windows(),
            "chains": chains,
            "targets": {
                r.name: {"target": r.target, "unit": r.unit}
                for r in self.rules
                if r.enabled
            },
        }
        if short is not None:
            doc["window"] = short.summary()
        # hooks AFTER the document is assembled and all locks released;
        # the profiler capture itself runs on a worker thread so a
        # scrape-driven evaluation never stalls its caller
        for chain, rule_name, detail in transitions:
            self.telemetry.add_slo_breach(f"{chain}/{rule_name}", detail)
            path = self._maybe_profile(detail)
            if path:
                doc.setdefault("profile_captures", []).append(path)
        return doc

    # -- breach-triggered profiler capture -----------------------------------

    def _maybe_profile(self, detail: str) -> Optional[str]:
        """Start a bounded ``torch.profiler`` capture into the configured
        dir, at most one per cooldown. The capture itself (one small op
        on the engine's device + the optional dwell) runs on a WORKER
        thread: evaluate() is called from the monitoring socket's
        asyncio handler and the Prometheus scrape path, and a breach is
        exactly the moment those surfaces must stay live. Returns the
        capture dir (filling asynchronously) or None."""
        if not self.profile_dir:
            return None
        now = self.clock()
        with self._lock:
            if (
                self._last_profile_t is not None
                and now - self._last_profile_t < self.profile_cooldown_s
            ):
                return None
            self._last_profile_t = now
            self._profile_seq += 1
            seq = self._profile_seq
        path = os.path.join(self.profile_dir, f"slo_breach_{seq:03d}")
        t = threading.Thread(
            target=self._capture_profile, args=(path, detail), daemon=True,
            name="slo-profile-capture",
        )
        self._profile_thread = t
        t.start()
        return path

    def _capture_profile(self, path: str, detail: str) -> None:
        """Worker-thread body. On the card a failed capture is kept and
        re-raised by `join_profile_capture`; on a CPU engine it is
        logged (the capture is evidence, not the engine's work)."""
        import torch

        device = self.telemetry.device
        on_card = device is not None and torch.device(device).type == "cuda"
        try:
            done = self._capture(path, detail, torch.device(device) if on_card else None)
        except Exception as e:  # noqa: BLE001 — kept for the joiner on the card
            if on_card:
                with self._lock:
                    self._profile_error = e
                return
            logger.warning("SLO breach profiler capture failed: %s", e)
            return
        if not done:
            return
        logger.warning("SLO breach (%s): device profile -> %s", detail, path)
        with self._lock:
            self.profile_captures.append(path)

    def _capture(self, path: str, detail: str, device) -> bool:
        """One bounded capture into ``path``/trace.json: CPU activity,
        and CUDA activity when ``device`` is a card, around `_probe` and
        the dwell. On a card the trace must hold a CUDA kernel: one that
        holds none is taken again, up to ``CAPTURE_ATTEMPTS`` captures,
        and then the capture fails (raises). Refused (False, with a
        flight-recorder event) when another profiler is active."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.autograd.profiler._is_profiler_enabled:
            with self._lock:
                self.profile_refused.append(path)
            self.telemetry._event("slo-profile-refused", detail)
            return False
        activities = [ProfilerActivity.CPU]
        if device is not None:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(path, exist_ok=True)
        trace = os.path.join(path, PROFILE_TRACE)
        dwell_s = min(max(self.profile_dwell_ms, 0.0), 1000.0) / 1000.0
        attempts = CAPTURE_ATTEMPTS if device is not None else 1
        for _ in range(attempts):
            with profile(activities=activities) as prof:
                _probe(device)
                if dwell_s > 0:
                    # the dwell widens the window so batches in flight land in it
                    time.sleep(dwell_s)
            prof.export_chrome_trace(trace)
            if device is None or trace_kernel_events(trace):
                return True
            self.telemetry._event("slo-profile-empty", detail)
        raise RuntimeError(f"SLO breach capture {path}: {attempts} profiler captures on "
                           f"{device} recorded no CUDA kernel")

    def join_profile_capture(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight breach capture to finish (tests +
        orderly shutdown); re-raises a capture that failed on the card."""
        t = self._profile_thread
        if t is not None:
            t.join(timeout)
        with self._lock:
            err, self._profile_error = self._profile_error, None
        if err is not None:
            raise err


def _fmt_breach(
    chain: str, rule: SloRule, short: Optional[float], long: Optional[float]
) -> str:
    s = "n/a" if short is None else f"{short:.6g}"
    l = "n/a" if long is None else f"{long:.6g}"
    return (
        f"{chain}/{rule.name} observed={s} long={l} "
        f"target={rule.target:.6g}{rule.unit}"
    )


def summarize(doc: dict) -> dict:
    """Compact per-run record for a benchmark's detail file: the overall
    verdict, per-rule worst observation vs target, and which chains
    breached — small enough to ride every config entry."""
    if not doc.get("enabled"):
        return {"verdict": "disabled"}
    rules: Dict[str, dict] = {}
    for chain, entry in (doc.get("chains") or {}).items():
        for name, ev in (entry.get("rules") or {}).items():
            cur = rules.get(name)
            obs = ev.get("observed")
            if cur is None or (
                obs is not None
                and (cur.get("observed") is None or obs > cur["observed"])
            ):
                rules[name] = {
                    "observed": obs,
                    "target": ev.get("target"),
                    "verdict": ev.get("verdict"),
                    "chain": chain,
                }
    out = {"verdict": doc.get("verdict", "ok"), "rules": rules}
    breached = sorted(
        chain
        for chain, entry in (doc.get("chains") or {}).items()
        if entry.get("verdict") == "breach"
    )
    if breached:
        out["breached_chains"] = breached
    return out


# -- process-global engine (the socket/CLI/Prometheus surfaces share it
# so verdict-transition memory and profile cooldowns are coherent) -----------

_ENGINE: Optional[SloEngine] = None
_ENGINE_LOCK = threading.Lock()


def engine() -> SloEngine:
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = SloEngine()
        return _ENGINE


def reset_engine() -> None:
    """Drop the process-global engine (the next use reads the config)."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = None


def health_snapshot() -> dict:
    """Evaluate the process-global engine — the monitoring socket's
    ``health`` mode."""
    return engine().evaluate()
