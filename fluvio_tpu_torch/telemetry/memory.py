"""Device-memory accounting plane: the per-owner device-memory ledger.

The port's copy of ``fluvio_tpu/telemetry/memory.py``. Its bytes are the
port's tensors: a batch books what it uploaded to the card (the ragged
flat, the lengths and the columns it could not derive, or the glz tokens
of the up link), a window bank its live entries, a partition its carry
tensors. `MemoryLedger.reconcile` reads the card's caching allocator
(``torch.cuda.memory_stats``) on the engine's device; the budget, the
leak TTL and the sampling gap are ``TelemetryConfig`` fields.

Device memory is home to far more than staged batches — partition carry banks,
window state banks and their pow2 emit buffers, per-shard staging,
glz token ladders, the compiled-executable cache — yet before this
module the only accounting was one gauge bumped at one executor seam.
The :class:`MemoryLedger` is the join: every allocation seam books
``acquire(owner, key, nbytes)`` when bytes land on the device and
``release(key)`` when they retire, under a typed owner vocabulary, so
the engine always knows *who owns device memory, when it leaks, and
how much headroom is left* before the allocator finds out the hard
way. Like the link byte counters, the ledger is hardware-independent
evidence: the same tensors stage on the CPU and on the card, so the
balance invariants hold in the CPU tests too.

Three consumers sit on top:

- **gauges**: every acquire/release republishes the flat gauges
  (``device_memory_bytes``, ``device_memory_peak_bytes``) plus the
  compatibility aliases ``hbm_staged_bytes`` (the staged-batch +
  glz-token + shard-staging sum — the pre-ledger gauge folded in so it
  cannot drift from the ledger) and ``window_state_bytes`` (the
  ``window_bank`` owner). Per-owner byte totals export through the
  snapshot ``memory`` section and the Prometheus
  ``fluvio_device_memory_bytes{owner=...}`` family.
- **leak detection**: entries older than ``mem_leak_ttl_s``
  with no release are flagged ONCE — a ``mem-leak`` flight-recorder
  instant event plus the always-on ``memory_leaks_total{owner}``
  counter — and ``assert_drained()`` pins quiesce: transient owners
  must be zero after every drain (the chaos suites' standing
  invariant).
- **headroom shedding**: the ``hbm_headroom`` SLO rule windows
  ``device_memory_bytes`` against the ``mem_budget`` ceiling,
  so a runaway window bank sheds new work through the admission
  controller's typed ``Rejected`` declines *before* an OOM kills the
  process — the same control loop ``consumer_lag`` closes for
  backlogs.

Zero-cost contract: the executor/partition/window seams route through
``TELEMETRY.mem_acquire``/``mem_release``, which are one ``enabled``
check when capture is off. The ``window_bank`` owner is the deliberate
exception (`note_window_bank` books ALWAYS, once per batch): state
size is exactness evidence like the delta byte counters, not
observability sugar — but gauge publication stays gated either way.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from fluvio_tpu_torch.telemetry.registry import (
    TELEMETRY,
    PipelineTelemetry,
    TelemetryConfig,
)

#: the typed owner vocabulary — acquire() rejects anything else so a
#: typo'd owner fails loudly instead of minting an unbalanced class
OWNERS = (
    "staged_batch",   # single-device staged dispatch (flat + lengths + keys)
    "carry_bank",     # partition runtimes' device-resident aggregate carries
    "window_bank",    # WindowStateBank device arrays (sums/counts/meta)
    "emit_buffer",    # pow2-bucketed window emit/resync fetch buffers
    "glz_tokens",     # compressed-staging token ladders (ll/ml/srcs/lits)
    "shard_staging",  # sharded per-shard staged dispatch
    "compile_cache",  # resident compiled-executable estimates
)

#: owners that must drain to zero at quiesce — batch-scoped
#: allocations whose acquire/release pairs bracket one dispatch.
#: carry/window banks and the compile cache legitimately persist
#: across batches, so assert_drained() exempts them.
TRANSIENT_OWNERS = (
    "staged_batch", "emit_buffer", "glz_tokens", "shard_staging",
)

#: the SLO rule family this ledger feeds (the memory CLI's breach gate
#: and the socket ``memory`` document filter on exactly this)
MEM_RULES = ("hbm_headroom",)

#: the allocator statistic `MemoryLedger.reconcile` reads: the bytes of
#: live tensors, not the cached reserve the allocator holds beside them
BACKEND_STAT = "allocated_bytes.all.current"


def budget_bytes(config: Optional[TelemetryConfig] = None) -> int:
    """The ledger ceiling (0 = no budget, headroom rule off)."""
    cfg = config if config is not None else TELEMETRY.config
    return int(cfg.mem_budget or 0)


def leak_ttl_s(config: Optional[TelemetryConfig] = None) -> float:
    cfg = config if config is not None else TELEMETRY.config
    return float(cfg.mem_leak_ttl_s)


def sample_interval_s(config: Optional[TelemetryConfig] = None) -> float:
    cfg = config if config is not None else TELEMETRY.config
    return float(cfg.mem_sample_s)


class MemoryLedger:
    """Per-owner device-memory ledger with leak detection and
    high-watermark tracking. One lock; every public read/write is one
    short critical section, and gauge publication happens OUTSIDE the
    ledger lock (registry-lock ordering mirrors the lag engine)."""

    def __init__(
        self,
        telemetry: Optional[PipelineTelemetry] = None,
        clock=time.monotonic,
    ) -> None:
        self.telemetry = telemetry if telemetry is not None else TELEMETRY
        self.clock = clock
        self._lock = threading.Lock()
        # key -> [owner, nbytes, t_acquire, leak_flagged]
        self._entries: Dict[object, list] = {}
        self._by_owner: Dict[str, int] = {o: 0 for o in OWNERS}
        self._peak = 0          # process-lifetime high watermark
        self._config_peak = 0   # bench per-config watermark (reset_peak)
        self._last_sample_t: Optional[float] = None
        self._reconcile: Dict[str, object] = {}

    # -- the ledger ----------------------------------------------------------

    def acquire(self, owner: str, key, nbytes: int) -> None:
        """Book ``nbytes`` of device memory under ``owner``. Re-acquire
        of a live key is a RESIZE (the old booking retires atomically),
        so growth paths (bank migration, retry re-staging) stay
        balanced without explicit release-then-acquire races."""
        if owner not in self._by_owner:
            raise ValueError(
                f"unknown memory owner {owner!r} (known: {OWNERS})"
            )
        nbytes = max(int(nbytes), 0)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._by_owner[old[0]] -= old[1]
            self._entries[key] = [owner, nbytes, self.clock(), False]
            self._by_owner[owner] += nbytes
            total = sum(self._by_owner.values())
            if total > self._peak:
                self._peak = total
            if total > self._config_peak:
                self._config_peak = total
        self._publish()

    def release(self, key) -> None:
        """Idempotent: finish and discard may both see a handle on the
        recovery ladders — only the first release moves the ledger."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return
            self._by_owner[entry[0]] -= entry[1]
        self._publish()

    def _publish(self) -> None:
        """Republish the flat gauges from the current owner totals.
        Values snapshot under the ledger lock; gauge_set runs after
        release so the ledger never holds two locks at once."""
        t = self.telemetry
        if not t.enabled:
            return
        with self._lock:
            by = self._by_owner
            total = sum(by.values())
            staged = (
                by["staged_batch"] + by["glz_tokens"] + by["shard_staging"]
            )
            window = by["window_bank"]
            peak = self._peak
        t.gauge_set("device_memory_bytes", float(total))
        t.gauge_set("device_memory_peak_bytes", float(peak))
        t.gauge_set("hbm_staged_bytes", float(staged))
        t.gauge_set("window_state_bytes", float(window))

    # -- reads ---------------------------------------------------------------

    def owner_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_owner)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._by_owner.values())

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def config_peak_bytes(self) -> int:
        with self._lock:
            return self._config_peak

    def owner_entries(self) -> Dict[str, int]:
        """{owner: live entry count} — the snapshot/CLI occupancy view."""
        with self._lock:
            counts = {o: 0 for o in OWNERS}
            for owner, _, _, _ in self._entries.values():
                counts[owner] += 1
            return counts

    def leaked_entries(self) -> List[dict]:
        """Entries the TTL scan has flagged (still unreleased)."""
        now = self.clock()
        with self._lock:
            return [
                {
                    "owner": e[0],
                    "key": repr(k),
                    "bytes": e[1],
                    "age_s": round(now - e[2], 3),
                }
                for k, e in self._entries.items()
                if e[3]
            ]

    # -- leak detection ------------------------------------------------------

    def scan(self, now: Optional[float] = None) -> List[tuple]:
        """Flag every live TRANSIENT entry older than
        ``mem_leak_ttl_s`` ONCE: the always-on
        ``memory_leaks_total{owner}`` counter moves and a ``mem-leak``
        flight-recorder instant lands next to the batch spans that
        leaked it. Persistent owners (carry/window banks, compile
        cache) legitimately outlive any TTL on an idle engine, so only
        batch-scoped owners can leak — the same partition
        ``assert_drained`` draws. Returns the newly flagged entries as
        ``(owner, key, nbytes, age_s)``."""
        ttl = leak_ttl_s(self.telemetry.config)
        if now is None:
            now = self.clock()
        flagged: List[tuple] = []
        with self._lock:
            for key, entry in self._entries.items():
                if (
                    entry[0] in TRANSIENT_OWNERS
                    and not entry[3]
                    and now - entry[2] >= ttl
                ):
                    entry[3] = True
                    flagged.append(
                        (entry[0], key, entry[1], now - entry[2])
                    )
        for owner, key, nbytes, age in flagged:
            self.telemetry.add_memory_leak(
                owner, f"{owner} {key!r} {nbytes}B unreleased {age:.1f}s"
            )
        return flagged

    def assert_drained(self) -> None:
        """Quiesce invariant: every transient owner must be zero (the
        chaos suites call this after every drain — a fault path that
        strands staged bytes fails HERE, not as a slow device leak)."""
        with self._lock:
            bad = {
                o: self._by_owner[o]
                for o in TRANSIENT_OWNERS
                if self._by_owner[o] != 0
            }
            held = [
                (e[0], repr(k), e[1])
                for k, e in self._entries.items()
                if e[0] in TRANSIENT_OWNERS
            ] if bad else []
        if bad:
            raise AssertionError(
                f"transient device-memory owners not drained: {bad}; "
                f"live entries: {held[:8]}"
            )

    # -- reconciliation ------------------------------------------------------

    def reconcile(self) -> Dict[str, object]:
        """Cross-check the ledger total against the card's allocator on
        the engine's device (``TELEMETRY.device``): ``backend_bytes`` is
        ``torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]``,
        the bytes of live tensors — not the cached reserve the allocator
        keeps beside them. On a CPU engine (or before any engine) the
        document says ``"backend": "unavailable"``, as the JAX package's
        does on its CPU backend. Before CUDA is initialized in the
        process the allocator holds 0 bytes. On a card a failure to read
        the stats raises: the document never falls back to a guess.

        The allocator is read under the ledger's lock, so the two numbers
        are one instant's: a seam books bytes after it allocates them and
        retires the booking before it drops them, so no booking can be
        released and its tensors freed between the two reads, and
        ``unaccounted_bytes`` is never below 0."""
        import torch

        device = self.telemetry.device
        with self._lock:
            ledger = sum(self._by_owner.values())
            if device is None or torch.device(device).type != "cuda":
                doc: Dict[str, object] = {
                    "ledger_bytes": ledger, "backend": "unavailable",
                }
            else:
                # before CUDA's lazy init no context exists and the
                # allocator holds nothing (its stats are an empty dict)
                backend = (int(torch.cuda.memory_stats(torch.device(device))[BACKEND_STAT])
                           if torch.cuda.is_initialized() else 0)
                doc = {
                    "ledger_bytes": ledger,
                    "backend_bytes": backend,
                    "unaccounted_bytes": backend - ledger,
                }
            self._reconcile = doc
        return doc

    def last_reconcile(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._reconcile)

    # -- the pull sampler ----------------------------------------------------

    def sample(self) -> None:
        """Installed as ``TELEMETRY.mem_sampler``: the time-series tick
        and the Prometheus scrape both pull it (refresh_memory), so
        leak scans and reconciliation keep running while nothing is
        dispatching. Throttled to one real pass per
        ``mem_sample_s`` — the scan walks every live entry."""
        if not self.telemetry.enabled:
            return
        now = self.clock()
        with self._lock:
            interval = sample_interval_s(self.telemetry.config)
            if (
                self._last_sample_t is not None
                and now - self._last_sample_t < interval
            ):
                return
            self._last_sample_t = now
        self.scan(now)
        self.reconcile()
        self._publish()

    # -- lifecycle -----------------------------------------------------------

    def reset_peak(self) -> None:
        """Start a fresh per-config watermark at the CURRENT total
        (bench attribution between configs)."""
        with self._lock:
            self._config_peak = sum(self._by_owner.values())

    def reset(self) -> None:
        with self._lock:
            self._entries = {}
            self._by_owner = {o: 0 for o in OWNERS}
            self._peak = 0
            self._config_peak = 0
            self._last_sample_t = None
            self._reconcile = {}
        self._publish()


# -- process-global ledger (one balance for every surface) -------------------

_ENGINE: Optional[MemoryLedger] = None
_ENGINE_LOCK = threading.Lock()


def engine() -> MemoryLedger:
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = MemoryLedger()
            if _ENGINE.telemetry.mem_sampler is None:
                _ENGINE.telemetry.mem_sampler = _ENGINE.sample
        return _ENGINE


def peek() -> Optional[MemoryLedger]:
    """The ledger if one exists, WITHOUT creating it — snapshot paths
    must not mint an engine just by looking."""
    with _ENGINE_LOCK:
        return _ENGINE


def reset_engine() -> None:
    """Drop the process-global ledger AND its registry sampler hook
    (tests re-wire on next use)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is not None:
            _ENGINE.reset()
        _ENGINE = None
    TELEMETRY.mem_sampler = None


# -- always-on seams (the window_state_bytes promotion) ----------------------


def note_window_bank(key, nbytes: int) -> None:
    """Book (or resize) a window bank's device bytes under the
    ``window_bank`` owner. ALWAYS-ON by the same rule as the window
    close counters: state size is exactness evidence the bench pins
    diff around runs. Gauge publication inside the ledger still
    no-ops when capture is off."""
    engine().acquire("window_bank", ("winbank", key), nbytes)


def release_window_bank(key) -> None:
    engine().release(("winbank", key))


# -- the memory document (socket ``memory`` mode) ---------------------------


def memory_snapshot() -> dict:
    """Per-owner ledger document + the headroom verdict. ``verdict``
    is the worst ``hbm_headroom`` verdict from the SLO engine, floored
    to ``breach`` when the instantaneous total already exceeds the
    budget (the socket ``memory`` mode)."""
    if not TELEMETRY.enabled:
        return {"enabled": False, "verdict": "disabled", "owners": {}}
    from fluvio_tpu_torch.telemetry import slo as slo_mod

    eng = engine()
    eng.scan()
    recon = eng.reconcile()
    doc = slo_mod.engine().evaluate()
    verdict = "ok"
    for entry in (doc.get("chains") or {}).values():
        for rule, ev in (entry.get("rules") or {}).items():
            if rule in MEM_RULES:
                verdict = slo_mod.worst([verdict, ev.get("verdict", "ok")])
    budget = budget_bytes()
    total = eng.total_bytes()
    if budget > 0 and total > budget:
        verdict = "breach"
    leaks = TELEMETRY.memory_leak_counts()
    bytes_by = eng.owner_bytes()
    entries_by = eng.owner_entries()
    return {
        "enabled": True,
        "verdict": verdict,
        "owners": {
            o: {"bytes": bytes_by[o], "entries": entries_by[o]}
            for o in OWNERS
        },
        "total_bytes": total,
        "peak_bytes": eng.peak_bytes(),
        "budget_bytes": budget,
        "leaked": eng.leaked_entries(),
        "leaks": leaks,
        "leaks_total": sum(leaks.values()),
        "reconcile": recon,
    }


def bench_block() -> Optional[dict]:
    """Per-config benchmark record: the config's peak ledger
    bytes (since the last ``reset_peak``) + non-zero owner totals.
    None when nothing was ever booked (the key stays off entirely)."""
    eng = peek()
    if eng is None:
        return None
    peak = eng.config_peak_bytes()
    owners = {o: b for o, b in eng.owner_bytes().items() if b}
    if not peak and not owners:
        return None
    leaks = TELEMETRY.memory_leak_counts()
    out = {"peak_mb": round(peak / 1e6, 3), "owners": owners}
    if leaks:
        out["leaks"] = sum(leaks.values())
    return out
