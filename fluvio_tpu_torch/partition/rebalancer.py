"""Lag-driven elastic partition rebalancer: the closed control loop.

The port's counterpart of ``fluvio_tpu/partition/rebalancer.py``, with the
same decisions. It watches per-partition lag **burn rates** (the first
derivative of the lag readings across its own ticks: an absolute-lag
threshold alone cannot tell a draining backlog from a growing one) and
MOVES hot partitions onto colder device groups through a voluntary-move
actuator, so a skewed workload drains while other groups idle.

- **The lag reader is injectable** (``lag_reader() -> {key: lag}``, keys
  ``topic/partition`` or ``chain@topic/partition``); with none given it
  reads the telemetry registry's consumer-lag family after a pull-join
  (`_default_lag_reader`), as the reference's does.
- **The mover is injected** (``mover(plan_key, group, reason)``; a
  runtime's or a gate's ``move_partition``, or a failover coordinator's
  ``migrate_partition`` for the key's partition). A mover returning a dict
  (``migrate_partition``'s move document) has done its own accounting; a
  bare truthy return means the rebalancer books the move itself, on the
  registry's ``rebalance_moves`` and migration families too.
- **Storms are bounded by construction**: per-partition cooldown, a
  max-moves budget per tick, and an absolute-lag hysteresis floor. An
  oscillating load moves a key at most once per cooldown window.
- **The clock is injected** (``time.monotonic`` by default), so burn rates
  and every decision are deterministic in tests.

When the hottest group still burns past the move budget and owns several
partitions while a live group sits empty, the tick SPLITS the fold (half
the keys move, reason ``split``). Merging cold folds is an explicit
operator action (:meth:`PartitionRebalancer.merge`). The caller arms the
daemon by building it; no environment switch exists.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from fluvio_tpu_torch.telemetry import TELEMETRY

logger = logging.getLogger(__name__)

#: move reasons ("rollback" is booked by a mover on a failed migration)
MOVE_REASONS = ("lag", "split", "merge", "manual", "rollback")


@dataclass(frozen=True)
class RebalanceConfig:
    """Daemon knobs (the reference's defaults)."""

    interval_s: float = 0.25  # daemon tick period
    #: required drain rate (records/s): a partition above the hysteresis
    #: floor whose lag is NOT falling at least this fast is hot
    burn: float = 1.0
    cooldown_s: float = 5.0  # per-partition refractory window
    max_moves: int = 2  # move budget per tick
    hysteresis: float = 4.0  # absolute-lag floor below which never move


def _default_lag_reader() -> Dict[str, float]:
    """The registry's consumer-lag family after a pull-join (the socket's
    ``lag`` mode reads the same)."""
    TELEMETRY.refresh_lag()
    lag, _, _ = TELEMETRY.lag_families()
    return {k: float(v) for k, v in lag.items()}


def partition_of(lag_key: str) -> str:
    """``chain@topic/partition`` -> the plan's ``topic/partition`` key."""
    return lag_key.split("@", 1)[1] if "@" in lag_key else lag_key


class PartitionRebalancer:
    """Watches lag burn rates and moves hot partitions to colder groups.

    ``plan_view`` returns the CURRENT `PlacementPlan` (a runtime's ``plan``
    property); ``mover`` is the actuator ``(plan_key, group, reason) ->
    dict | bool``; ``lag_reader`` returns the lag readings (None: the
    telemetry registry's, `_default_lag_reader`). :meth:`tick`
    makes at most ``max_moves`` decisions and returns the moves it
    performed; :meth:`run` wraps it in a stoppable loop.
    """

    def __init__(
        self,
        plan_view: Callable[[], object],
        mover: Callable[..., object],
        config: Optional[RebalanceConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        *,
        lag_reader: Optional[Callable[[], Dict[str, float]]] = None,
    ):
        self._plan_view = plan_view
        self._mover = mover
        self.config = config or RebalanceConfig()
        self._clock = clock
        self._lag_reader = lag_reader if lag_reader is not None else _default_lag_reader
        self._lock = threading.Lock()
        # plan_key -> (last_lag, last_t) for burn-rate derivation
        self._samples: Dict[str, tuple] = {}
        # plan_key -> clock time before which it must not move again
        self._cooldown: Dict[str, float] = {}
        self._burn: Dict[str, float] = {}
        self._recent: List[dict] = []
        self.ticks = 0
        self.moves_total = 0
        self.rollbacks = 0

    # -- decision plumbing ---------------------------------------------------

    def _lag_by_plan_key(self) -> Dict[str, float]:
        """Collapse the readings onto plan keys (several chains can serve
        one partition; the decision is per partition, so their lags sum)."""
        out: Dict[str, float] = {}
        for key, lag in self._lag_reader().items():
            pk = partition_of(key)
            out[pk] = out.get(pk, 0.0) + max(float(lag), 0.0)
        return out

    def _update_burn(self, lags: Dict[str, float], now: float) -> Dict[str, float]:
        """records/s lag growth per plan key since the previous tick (a
        first sighting seeds the baseline: no burn, no move)."""
        burn: Dict[str, float] = {}
        for key, lag in lags.items():
            prev = self._samples.get(key)
            if prev is not None:
                last_lag, last_t = prev
                dt = now - last_t
                if dt > 0:
                    burn[key] = (lag - last_lag) / dt
            self._samples[key] = (lag, now)
        # forget keys that stopped reporting (stream closed)
        for gone in set(self._samples) - set(lags):
            self._samples.pop(gone, None)
            self._cooldown.pop(gone, None)
        return burn

    def _book(self, key: str, src, dst: int, reason: str, result) -> dict:
        """Uniform move record (a dict mover's own document is kept)."""
        doc = result if isinstance(result, dict) else {
            "ok": bool(result), "moved": bool(result),
            "from": src, "to": dst, "replayed": 0, "seconds": 0.0,
        }
        doc = dict(doc, key=key, reason=reason)
        if doc.get("moved") and not isinstance(result, dict):
            TELEMETRY.add_rebalance_move(reason, f"{key}:{src}->{dst}")
            TELEMETRY.add_migration_seconds(doc.get("seconds", 0.0))
        if not doc.get("ok"):
            self.rollbacks += 1
        return doc

    def _move(self, key: str, group: int, reason: str, now: float) -> dict:
        plan = self._plan_view()
        src = plan.assignments.get(key)
        try:
            result = self._mover(key, group, reason)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # a broken mover must not kill the daemon
            logger.warning("rebalance move %s -> %d failed: %s: %s",
                           key, group, type(e).__name__, e)
            result = {"ok": False, "moved": False, "from": src, "to": group,
                      "error": f"{type(e).__name__}: {e}"}
        doc = self._book(key, src, group, reason, result)
        self._cooldown[key] = now + self.config.cooldown_s
        if doc.get("moved"):
            self.moves_total += 1
        self._recent.append(doc)
        del self._recent[:-32]
        return doc

    # -- the control loop ----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One control-loop pass: sample lag, derive burn, move up to
        ``max_moves`` hot partitions onto the coldest live groups, split a
        still-burning fold onto an empty group. Returns the move
        documents (possibly empty)."""
        with self._lock:
            now = self._clock() if now is None else now
            self.ticks += 1
            cfg = self.config
            lags = self._lag_by_plan_key()
            burn = self._update_burn(lags, now)
            self._burn = dict(burn)
            plan = self._plan_view()
            # a partition that never dispatched is not in the lazy plan yet:
            # resolve it through the plan's own rules, as a mover will
            missing = [k for k in lags if k not in plan.assignments]
            if missing:
                plan = plan.with_partitions(sorted(missing))
            live = set(plan.live_groups())
            if len(live) < 2:
                return []
            group_lag: Dict[int, float] = {g: 0.0 for g in live}
            group_keys: Dict[int, List[str]] = {g: [] for g in live}
            for key, g in plan.assignments.items():
                if g in live:
                    group_lag[g] = group_lag.get(g, 0.0) + lags.get(key, 0.0)
                    group_keys.setdefault(g, []).append(key)
            hot = sorted(
                (
                    key
                    for key, lag in lags.items()
                    # above the floor and not draining at the required rate
                    # (a key needs two samples to qualify)
                    if lag >= cfg.hysteresis
                    and key in burn
                    and burn[key] > -cfg.burn
                    and now >= self._cooldown.get(key, 0.0)
                ),
                key=lambda k: -lags[k],
            )
            moves: List[dict] = []
            for key in hot:
                if len(moves) >= cfg.max_moves:
                    break
                src = self._plan_view().assignments.get(key, plan.assignments.get(key))
                if src is None or src not in live:
                    continue
                targets = sorted(
                    (g for g in live if g != src),
                    key=lambda g: (group_lag.get(g, 0.0), len(group_keys.get(g, ())), g),
                )
                if not targets:
                    continue
                dst = targets[0]
                if group_lag.get(dst, 0.0) >= group_lag.get(src, 0.0):
                    continue  # nowhere colder: moving only spreads heat
                doc = self._move(key, dst, "lag", now)
                if doc.get("moved"):
                    moves.append(doc)
                    group_lag[src] = group_lag.get(src, 0.0) - lags.get(key, 0.0)
                    group_lag[dst] = group_lag.get(dst, 0.0) + lags.get(key, 0.0)
                    group_keys.setdefault(dst, []).append(key)
                    if key in group_keys.get(src, ()):
                        group_keys[src].remove(key)
            # split: the hottest fold still burns past the move budget and
            # owns several partitions while a live group sits empty
            if len(moves) < cfg.max_moves and hot[len(moves):]:
                hottest = max(group_lag, key=lambda g: group_lag[g])
                empty = [g for g in live if not group_keys.get(g)]
                if empty and len(group_keys.get(hottest, ())) >= 2:
                    for key in sorted(group_keys[hottest])[1::2]:
                        if len(moves) >= cfg.max_moves:
                            break
                        if now < self._cooldown.get(key, 0.0):
                            continue
                        doc = self._move(key, empty[0], "split", now)
                        if doc.get("moved"):
                            moves.append(doc)
            return moves

    # -- explicit fold reshaping ---------------------------------------------

    def merge(self, src: int, dst: int) -> List[dict]:
        """Fold every partition of ``src`` onto ``dst`` (operator action)."""
        with self._lock:
            now = self._clock()
            plan = self._plan_view()
            return [self._move(key, dst, "merge", now)
                    for key in sorted(k for k, g in plan.assignments.items() if g == src)]

    def split(self, group: int, target: int) -> List[dict]:
        """Move every second partition of ``group`` onto ``target``."""
        with self._lock:
            now = self._clock()
            plan = self._plan_view()
            keys = sorted(k for k, g in plan.assignments.items() if g == group)
            return [self._move(key, target, "split", now) for key in keys[1::2]]

    # -- daemon loop ---------------------------------------------------------

    def run(self, stop_event, interval_s: Optional[float] = None) -> None:
        """Blocking loop (run it on a thread): tick until the event sets."""
        period = interval_s if interval_s is not None else self.config.interval_s
        while not stop_event.is_set():
            try:
                self.tick()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:  # noqa: BLE001 — the daemon must outlive a bad tick
                logger.exception("rebalancer tick failed")
            stop_event.wait(period)

    # -- observability -------------------------------------------------------

    def status(self) -> dict:
        """The daemon's state: config, counters, plan, per-partition lag,
        burn and cooldown, and the recent move documents."""
        with self._lock:
            plan = self._plan_view()
            lags = {k: lag for k, (lag, _) in self._samples.items()}
            now = self._clock()
            partitions = {
                key: {
                    "group": plan.assignments.get(key),
                    "lag": round(lags.get(key, 0.0), 3),
                    "burn": round(self._burn.get(key, 0.0), 3),
                    "cooldown_s": round(max(self._cooldown.get(key, 0.0) - now, 0.0), 3),
                }
                for key in sorted(lags)
            }
            moves, hist = TELEMETRY.rebalance_families()
            return {
                "enabled": True,
                "config": {
                    "interval_s": self.config.interval_s,
                    "burn": self.config.burn,
                    "cooldown_s": self.config.cooldown_s,
                    "max_moves": self.config.max_moves,
                    "hysteresis": self.config.hysteresis,
                },
                "ticks": self.ticks,
                "moves_total": self.moves_total,
                "rollbacks": self.rollbacks,
                "plan": plan.to_dict(),
                "partitions": partitions,
                "moves": moves,
                "migration_seconds": hist.to_dict(),
                "recent": list(self._recent),
            }
