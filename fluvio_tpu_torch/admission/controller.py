"""Health-keyed backpressure and load-shedding: the admission decision.

The port's copy of ``fluvio_tpu/admission/controller.py``. The SLO engine
(`telemetry.slo`) turns raw telemetry into machine-readable per-chain
``ok | warn | breach`` verdicts, with the queue-depth and device-memory
rules saying which resource saturates first. This module is the first
thing that ACTS on those verdicts:

- every chain gets a **token/credit bucket**; the refill rate scales
  with health (ok → full rate, warn → half, breach → zero), so pressure
  throttles admission continuously rather than cliff-edging;
- a **warn** verdict sheds probabilistically (``AdmissionConfig.
  warn_shed``), a **breach** sheds hard — both as a typed `Rejected`
  decline (reason-counted on ``TELEMETRY.admission``, never an exception
  into the client);
- **breaker-open** chains short-circuit through the SAME decline
  surface; the port has no circuit breakers yet, so a chain passes
  ``breaker=None`` and this never arises;
- verdicts are cached and refreshed at most every ``refresh_s`` (the SLO
  evaluation walks the window ring; per-slice would be a hot-path cost),
  and recover exactly when the SLO windows age out — shedding stops
  without a restart.

Every knob is an `AdmissionConfig` field (the JAX package's environment
variable beside each), read at construction from the process's settings
unless passed. `configure` applies a config to the process; the broker
seam reads the process gate through `gate`, which resolves once: with
admission disarmed (the default) it is one cached None read a slice and
touches no controller, queue, lock or gauge.

Build attribution: the port compiles no jit, so the compile events the
storm signal counts are its native library builds
(`telemetry.compiles.note_build`); `AdmissionPipeline` diffs
``TELEMETRY.compile_totals()`` around every dispatch and feeds
`AdmissionController.note_compiles`.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional

from fluvio_tpu_torch.admission.batcher import Flush, ShapeBucketBatcher
from fluvio_tpu_torch.admission.fairness import FairQueue
from fluvio_tpu_torch.admission.types import (
    AdmissionConfig,
    Decision,
    Rejected,
    current_config,
    set_config,
)
from fluvio_tpu_torch.telemetry import TELEMETRY

# health → token refill-rate multiplier: warn halves the credit stream,
# breach stops it (the hard shed below also fires, but a breach that
# ages out mid-window resumes from an empty bucket, not a full one)
_REFILL_SCALE = {"ok": 1.0, "warn": 0.5, "breach": 0.0}


def admission_enabled(config: Optional[AdmissionConfig] = None) -> bool:
    return (config if config is not None else current_config()).enabled


class TokenBucket:
    """Plain credit bucket; the caller holds the controller lock."""

    def __init__(self, capacity: float, refill_rate: float, now: float):
        self.capacity = capacity
        self.refill_rate = refill_rate
        self.tokens = capacity
        self.stamp = now

    def take(self, cost: float, now: float, rate_scale: float) -> bool:
        self.tokens = min(
            self.capacity,
            self.tokens + (now - self.stamp) * self.refill_rate * rate_scale,
        )
        self.stamp = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class AdmissionController:
    """Per-chain admission decisions keyed on the SLO engine."""

    def __init__(
        self,
        slo_engine=None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        refresh_s: Optional[float] = None,
        warn_shed: Optional[float] = None,
        tokens: Optional[float] = None,
        refill: Optional[float] = None,
    ) -> None:
        if slo_engine is None:
            from fluvio_tpu_torch.telemetry import slo as slo_mod

            slo_engine = slo_mod.engine()
        cfg = current_config()
        self.slo_engine = slo_engine
        self.clock = clock
        self.rng = rng if rng is not None else random.Random()
        self.refresh_s = refresh_s if refresh_s is not None else cfg.refresh_s
        self.warn_shed = warn_shed if warn_shed is not None else cfg.warn_shed
        self.capacity = tokens if tokens is not None else cfg.tokens
        self.refill = refill if refill is not None else cfg.refill
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._verdicts: Dict[str, str] = {}
        self._engine_verdict = "ok"
        self._verdict_stamp: Optional[float] = None
        # per-chain required-warm gate (serve gate): chains registered
        # with require_warm shed "cold-chain" until note_warm fires
        self._require_warm: Dict[str, bool] = {}
        self._warmed: Dict[str, set] = {}
        # migration grace: topic/partition -> deadline. A partition the
        # rebalancer just moved carries a breach verdict EARNED ON THE
        # OLD GROUP; the grace window lets it re-admit on the new group
        # so the backlog can drain
        self._migrated: Dict[str, float] = {}
        # per-chain build timestamps: the registry's storm thresholds
        # (TelemetryConfig.compile_storm_n / _window_s) applied per
        # chain — the fairness trip signal
        self._compile_times: Dict[str, List[float]] = {}

    # -- warm gate -----------------------------------------------------------

    def require_warm(self, chain: str, required: bool = True) -> None:
        with self._lock:
            self._require_warm[chain] = required

    def note_warm(self, chain: str, buckets) -> None:
        with self._lock:
            self._warmed.setdefault(chain, set()).update(buckets)

    def warmed(self, chain: str) -> bool:
        with self._lock:
            return bool(self._warmed.get(chain))

    # -- health refresh ------------------------------------------------------

    def _refresh_verdicts(self, now: float) -> None:
        with self._lock:
            stale = self._verdict_stamp is None or now - self._verdict_stamp >= self.refresh_s
            if stale:
                self._verdict_stamp = now  # claim before the evaluation
        if not stale:
            return
        # the SLO evaluation runs OUTSIDE the controller lock: it takes
        # the registry/timeseries locks and can fire breach hooks
        try:
            doc = self.slo_engine.evaluate()
        except Exception:  # noqa: BLE001 — health must fail open, not closed
            return
        chains = doc.get("chains") or {}
        engine_entry = chains.get("_engine") or {}
        rank = {"ok": 0, "warn": 1, "breach": 2}
        # the engine-wide rules (queue_depth and hbm_staged — the
        # saturating resources — plus error_rate/compile_budget/
        # recompile_rate/spill_ratio) are pressure every chain shares:
        # the _engine entry's verdict is already the worst across them
        engine_verdict = engine_entry.get("verdict", "ok")
        if engine_verdict not in rank:
            engine_verdict = "ok"
        verdicts = {
            chain: entry.get("verdict", "ok")
            for chain, entry in chains.items()
            if chain != "_engine"
        }
        with self._lock:
            self._engine_verdict = engine_verdict
            self._verdicts = verdicts

    def chain_verdict(self, chain: str) -> str:
        """worst(chain's own verdict, engine queue/memory verdict) from
        the cached evaluation."""
        rank = {"ok": 0, "warn": 1, "breach": 2}
        with self._lock:
            v1 = self._verdicts.get(chain, "ok")
            v2 = self._engine_verdict
        return v1 if rank.get(v1, 0) >= rank.get(v2, 0) else v2

    # -- migration grace (rebalancer recovery seam) --------------------------

    def note_migrated(self, partition: str, grace_s: float = 10.0) -> None:
        """A ``topic/partition`` just migrated to a new device group:
        clear its cached verdicts (they were earned on the OLD group)
        and grant a grace window during which lag breach/warn verdicts
        do not shed it — serving must resume for the backlog to drain,
        which is what clears the breach for real. Token buckets still
        apply, so grace is not an admission bypass."""
        now = self.clock()
        with self._lock:
            self._migrated.pop(partition, None)
            self._migrated[partition] = now + max(grace_s, 0.0)
            while len(self._migrated) > 128:
                self._migrated.pop(next(iter(self._migrated)))
            for chain in list(self._verdicts):
                if "@" in chain and chain.split("@", 1)[1] == partition:
                    self._verdicts[chain] = "ok"

    def _in_migration_grace(self, chain: str, now: float) -> bool:
        part = chain.split("@", 1)[1] if "@" in chain else chain
        with self._lock:
            deadline = self._migrated.get(part)
            if deadline is None:
                return False
            if now >= deadline:
                del self._migrated[part]
                return False
            return True

    # -- storm attribution (the fairness trip signal) ------------------------

    def note_compiles(self, chain: str, n: int) -> bool:
        """Attribute ``n`` build events to ``chain`` (the caller diffs
        ``TELEMETRY.compile_totals()`` around its dispatch); True when
        the chain just crossed the registry's storm threshold inside the
        storm window — the fairness layer's cue to penalize its weight."""
        if n <= 0:
            return False
        cfg = TELEMETRY.config
        now = self.clock()
        cutoff = now - cfg.compile_storm_window_s
        with self._lock:
            times = self._compile_times.setdefault(chain, [])
            times[:] = [t for t in times if t >= cutoff]
            before = len(times)
            times.extend([now] * n)
            return before <= cfg.compile_storm_n < len(times)

    # -- the decision --------------------------------------------------------

    def admit(self, chain: str, cost: float = 1.0, breaker=None, tenant: str = "") -> Decision:
        """One slice's admission decision. Order: breaker short-circuit
        (shared decline surface), warm gate, health shed, token charge.
        ``tenant`` attributes shed decisions to the per-tenant
        accounting plane — empty skips attribution."""
        now = self.clock()
        if breaker is not None and not breaker.allow_fused():
            return self._shed(chain, "breaker-open", "ok", tenant)
        # partition-keyed identity: "sig@topic/partition" keys get their
        # own token buckets and SLO-verdict families (a hot partition
        # sheds alone), but warm bookkeeping is per-CHAIN — the buckets
        # one partition warmed serve every sibling partition of the same
        # chain, so the cold gate reads through the base sig
        base = chain.split("@", 1)[0]
        with self._lock:
            cold = self._require_warm.get(base) and not self._warmed.get(base)
        if cold:
            return self._shed(chain, "cold-chain", "ok", tenant)
        self._refresh_verdicts(now)
        verdict = self.chain_verdict(chain)
        if verdict in ("breach", "warn") and self._in_migration_grace(chain, now):
            verdict = "ok"
        if verdict == "breach":
            return self._shed(chain, "breach-shed", verdict, tenant)
        if verdict == "warn" and self.rng.random() < self.warn_shed:
            return self._shed(chain, "warn-shed", verdict, tenant)
        with self._lock:
            # LRU-bounded: pop+reinsert makes every ACCESS refresh
            # recency, so churny short-lived chains evict first and a busy
            # chain's drained bucket can never be evicted-and-reborn full
            # mid-throttle
            bucket = self._buckets.pop(chain, None)
            if bucket is None:
                bucket = TokenBucket(self.capacity, self.refill, now)
            self._buckets[chain] = bucket
            while len(self._buckets) > 512:
                self._buckets.pop(next(iter(self._buckets)))
            ok = bucket.take(cost, now, _REFILL_SCALE.get(verdict, 1.0))
        if not ok:
            return self._shed(chain, "no-tokens", verdict, tenant)
        TELEMETRY.add_admission("admit")
        return Decision(True, chain=chain, verdict=verdict)

    def _shed(self, chain: str, reason: str, verdict: str, tenant: str = "") -> Rejected:
        TELEMETRY.add_admission(reason)
        if tenant:
            TELEMETRY.add_tenant_shed(tenant)
        retry = (
            self.refresh_s
            if reason in ("breach-shed", "warn-shed")
            else max(1.0 / max(self.refill, 1e-6), 0.005)
        )
        return Rejected(chain=chain, reason=reason, verdict=verdict, retry_after_s=retry)


class AdmissionPipeline:
    """The assembled front door: admit → fair queue → adaptive batcher.

    ``dispatch(flush)`` receives each coalesced batch (see `Flush`)
    outside every admission lock. Stateful or fan-out chains must not be
    routed through a shared pipeline's batcher — register them with
    ``coalesce=False`` and their slices dispatch solo, in admission
    order, through the same fairness layer.
    """

    def __init__(
        self,
        dispatch,
        controller: Optional[AdmissionController] = None,
        queue: Optional[FairQueue] = None,
        batcher: Optional[ShapeBucketBatcher] = None,
        clock: Callable[[], float] = time.monotonic,
        storm_cooldown_s: Optional[float] = None,
    ) -> None:
        self.controller = (
            controller if controller is not None else AdmissionController(clock=clock)
        )
        self.queue = queue if queue is not None else FairQueue(clock=clock)

        def _wrapped(flush):
            # build attribution: diff the build counter around every
            # dispatch so storms attribute to the chain that caused them
            # (the fairness trip signal)
            c0 = TELEMETRY.compile_totals()["compiles"]
            result = dispatch(flush)
            flush.compiles = TELEMETRY.compile_totals()["compiles"] - c0
            return result

        # an injected batcher keeps its own dispatch callback; solo
        # chains always attribute through the wrapper
        self.batcher = batcher if batcher is not None else ShapeBucketBatcher(_wrapped, clock=clock)
        self._solo_dispatch = _wrapped
        self.clock = clock
        self.storm_cooldown_s = (
            storm_cooldown_s
            if storm_cooldown_s is not None
            else TELEMETRY.config.compile_storm_window_s
        )
        self._coalesce: Dict[str, bool] = {}

    def register_chain(
        self, chain: str, weight: float = 1.0, coalesce: bool = True, require_warm: bool = False
    ) -> None:
        self.queue.set_weight(chain, weight)
        self._coalesce[chain] = coalesce
        if require_warm:
            self.controller.require_warm(chain)

    def note_warm(self, chain: str, buckets) -> None:
        self.controller.note_warm(chain, buckets)
        self.batcher.note_warm(chain, buckets)

    # -- intake --------------------------------------------------------------

    def submit(self, chain: str, buf, breaker=None, tenant: str = "") -> Decision:
        """Admit-or-shed one slice. Admitted slices enter the chain's
        fair queue (full queue downgrades the admission to a
        ``queue-full`` shed — the token is gone, which is correct: the
        queue IS the credit's backing store). Admitted slices also get
        their causal flow record (telemetry/flow.py): queue-wait and
        batcher residence land on it, and the batcher closes it after
        the coalesced dispatch it rode. ``tenant`` rides both the shed
        counters and the flow record."""
        decision = self.controller.admit(chain, breaker=breaker, tenant=tenant)
        if not decision:
            return decision
        if not self.queue.push(chain, buf):
            TELEMETRY.add_admission("queue-full")
            if tenant:
                TELEMETRY.add_tenant_shed(tenant)
            return Rejected(
                chain=chain, reason="queue-full", verdict=decision.verdict, retry_after_s=0.01
            )
        # the flow is born only once the slice is really IN (a queue-full
        # shed must not leave a stale flow, still counting queue-wait,
        # riding the buf into a later retry)
        flow = TELEMETRY.begin_flow(chain, tenant)
        if flow is not None:
            flow.decision = "admit"
            flow.note_queue()
            try:
                buf._flow = flow
            except AttributeError:  # slotted/foreign buffer: no flow ride
                pass
        return decision

    # -- drain ---------------------------------------------------------------

    def pump(self, max_items: Optional[int] = None) -> int:
        """Serve queued slices fairly into the batcher (or solo-dispatch
        non-coalescing chains), then flush deadline-expired buckets.
        Returns the number of slices drained. A chain whose dispatch
        crossed the storm threshold gets its fairness weight penalized
        for the cooldown."""
        drained = 0
        while max_items is None or drained < max_items:
            nxt = self.queue.pop()
            if nxt is None:
                break
            chain, buf = nxt
            drained += 1
            flw = getattr(buf, "_flow", None)
            if flw is not None:
                flw.end_queue()  # fair-queue residence onto the record
            if self._coalesce.get(chain, True):
                flushes = self.batcher.add(chain, buf)
            else:
                flushes = [self._dispatch_solo(chain, buf)]
            self._account_compiles(chain, flushes)
        for flush in self.batcher.poll():
            self._account_compiles(flush.chain, [flush])
        return drained

    def _dispatch_solo(self, chain: str, buf):
        # one counting policy with the batcher's solo path: the 'solo'
        # admission counter means EVERY un-coalesced dispatch
        TELEMETRY.add_admission("solo")
        flush = Flush(
            chain=chain, width_bucket=int(getattr(buf, "width", 0)),
            items=[buf], bases=[0], buffer=buf, cause="solo",
        )
        flw = getattr(buf, "_flow", None)
        if flw is not None:
            flw.mark_dispatch()
        flush.result = self._solo_dispatch(flush)
        if flw is not None:
            TELEMETRY.end_flow(flw, records=int(getattr(buf, "count", 0) or 0))
        return flush

    def _account_compiles(self, chain: str, flushes) -> None:
        for flush in flushes:
            n = getattr(flush, "compiles", 0)
            if n and self.controller.note_compiles(chain, n):
                self.queue.note_storm(chain, self.storm_cooldown_s)

    def drain(self) -> int:
        """Clean shutdown: serve everything queued, flush every pending
        bucket; nothing is lost, nothing dispatches twice."""
        n = self.pump()
        self.batcher.flush_all()
        return n


# -- process-global gate (the broker seam) -----------------------------------

_GATE: Optional[AdmissionController] = None
_GATE_RESOLVED = False
_GATE_LOCK = threading.Lock()


def gate() -> Optional[AdmissionController]:
    """The broker's admission controller, or None when admission is
    disarmed. Resolved ONCE from the process's `AdmissionConfig`: the
    disarmed path costs one cached None read per slice and touches no
    lock after the first call."""
    global _GATE, _GATE_RESOLVED
    if _GATE_RESOLVED:
        return _GATE
    with _GATE_LOCK:
        if not _GATE_RESOLVED:
            _GATE = AdmissionController() if admission_enabled() else None
            _GATE_RESOLVED = True
    return _GATE


def set_gate(controller: Optional[AdmissionController]) -> None:
    """Install a specific controller as the process gate (tests and
    embedders). The broker seam reads through `gate()`, so this takes
    effect on the next slice."""
    global _GATE, _GATE_RESOLVED
    with _GATE_LOCK:
        _GATE = controller
        _GATE_RESOLVED = True


def reset_gate() -> None:
    """Drop the resolved gate (the next `gate()` resolves it again from
    the process's settings)."""
    global _GATE, _GATE_RESOLVED
    with _GATE_LOCK:
        _GATE = None
        _GATE_RESOLVED = False


def configure(config: AdmissionConfig) -> None:
    """Apply ``config`` to the process: the settings every later
    controller, queue, batcher and warm-up reads, and the gate, resolved
    again from them on the next slice (armed when ``config.enabled``)."""
    set_config(config)
    reset_gate()
