"""Leader failover: carry replication, promotion replay and voluntary
migration.

The port's counterpart of ``fluvio_tpu/partition/failover.py``. A
follower's log already holds every record, so a promoted follower resumes
the stream where the dead leader stopped; what a fused chain adds is its
aggregate carry. That carry is tiny and constant-size (a few scalars per
aggregate stage), so the leader replicates ``(committed_offset, carries)``
on every commit (`CarryReplica`, mirrored onto the partition's
`LeaderReplicaState.publish_carry`).

Promotion needs no carry transfer from the dead leader: a fresh chain is
rebuilt from its replayable spec (`chain_from_spec`, the dead-letter
entries' identity format) on the same device, every partition is seeded
from its last committed snapshot, and the un-acked records (committed
offset to the log's end) replay through the port's full ladder
(`PartitionRuntime.process_chain`: the executor's retries, the card
re-run, the dead-letter quarantine). Every input record lands once in
served ∪ dead-letter, and a replay the card serves leaves the carries
bit-equal to a run that never failed over. The port has no host
interpreter: its re-run passes the card's seams again, so a fault that
persists through the fused attempt and the re-run quarantines the slab
where the JAX package's interpreter serves it (``ROADMAP.md`` §3, "a fault
on every card attempt").
"""

from __future__ import annotations

import base64
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from fluvio_tpu_torch.partition.placement import (
    DEFAULT_RULES,
    PlacementRule,
    partition_key,
    plan_placement,
)
from fluvio_tpu_torch.partition.runtime import PartitionRuntime
from fluvio_tpu_torch.resilience.policy import ResilienceConfig
from fluvio_tpu_torch.telemetry import TELEMETRY

logger = logging.getLogger(__name__)


def chain_from_spec(chain_spec: List[dict], device=None,
                    resilience: Optional[ResilienceConfig] = None):
    """Rebuild a chain from its replayable spec: rows ``{name, kind,
    params, initial}`` (a chain's ``chain_spec``, a dead-letter entry's
    chain), names resolved in the built-in registry (`models.lookup`), on
    ``device`` (None: the card) under ``resilience`` (None: the defaults).
    Returns the initialized `SmartModuleChainInstance`."""
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig

    engine = SmartEngine(device=device, resilience=resilience or ResilienceConfig())
    b = engine.builder()
    for row in chain_spec:
        initial = row.get("initial")
        b.add_smart_module(
            SmartModuleConfig(params=dict(row.get("params") or {}),
                              initial_data=base64.b64decode(initial) if initial else b""),
            lookup(row["name"]),
        )
    return b.initialize()


class CarryReplica:
    """The follower-side replication bus for per-partition chain state.

    Leaders ``publish`` after every served batch; promotion reads
    ``latest``. ``bind_leader`` mirrors each publish onto a leader replica
    object's ``publish_carry(offset, carries)``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._state: Dict[str, tuple] = {}
        self._leaders: Dict[str, object] = {}

    def bind_leader(self, key: str, leader) -> None:
        with self._lock:
            self._leaders[key] = leader

    def publish(
        self,
        key: str,
        committed_offset: int,
        carries: List[tuple],
        inst_state: Optional[List[tuple]] = None,
    ) -> None:
        with self._lock:
            self._state[key] = (
                committed_offset,
                [tuple(c) for c in carries],
                [tuple(s) for s in inst_state] if inst_state else None,
            )
            leader = self._leaders.get(key)
        if leader is not None:
            leader.publish_carry(committed_offset, carries)

    def latest(self, key: str) -> Tuple[int, Optional[list], Optional[list]]:
        """(committed_offset, carries, inst_state); (-1, None, None) when
        nothing was ever committed (replay from the beginning)."""
        with self._lock:
            got = self._state.get(key)
        if got is None:
            return -1, None, None
        return got

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: v[0] for k, v in self._state.items()}


@dataclass
class _PartitionLog:
    """The follower's view of one partition's log: every appended record
    slab with its offsets."""

    entries: List[tuple] = field(default_factory=list)  # (base, next, slab)

    def append(self, base_offset: int, next_offset: int, slab) -> None:
        self.entries.append((base_offset, next_offset, slab))

    def unacked(self, committed: int) -> List[tuple]:
        """The entries past ``committed``: what a promotion replays."""
        return [e for e in self.entries if e[1] > committed]


class FailoverCoordinator:
    """Drives a partitioned stream through leader losses.

    The leader runs the fast path only: `RecordBuffer.from_smartmodule_input`,
    `PartitionRuntime.process` (dispatch and finish, the executor's own
    retries), ``to_records()``. A failure its retries do not clear (an
    injected deterministic fault at ``stage``, ``h2d``, ``dispatch``,
    ``device`` or ``fetch``) escapes, and that is the leader's death: the
    promotion (`promote`) runs inline and the stream goes on on the new
    leader. ``chain_spec`` must build one card segment (``gpu_chain``);
    ``device`` is the chain's (None: the card), the groups fold onto it.
    ``rules`` place the partitions (None: `DEFAULT_RULES`) over
    ``n_groups`` groups; ``resilience`` sets the rebuilt chains' budgets and
    dead-letter directory.
    """

    def __init__(
        self,
        chain_spec: List[dict],
        topic: str = "t",
        n_groups: int = 2,
        device=None,
        rules: Optional[Sequence[PlacementRule]] = None,
        resilience: Optional[ResilienceConfig] = None,
    ):
        self.chain_spec = [dict(r) for r in chain_spec]
        self.topic = topic
        self.n_groups = n_groups
        self.device = device
        self._rules = tuple(rules) if rules is not None else DEFAULT_RULES
        self.resilience = resilience
        self.replica = CarryReplica()
        self.logs: Dict[str, _PartitionLog] = {}
        self.served: Dict[str, list] = {}
        self.promotions = 0
        self.migrations = 0
        self.migrations_failed = 0
        self.leader = self._build_runtime()

    def _build_runtime(self) -> PartitionRuntime:
        chain = chain_from_spec(self.chain_spec, device=self.device, resilience=self.resilience)
        if chain.gpu_chain is None:
            raise ValueError("the failover coordinator needs a chain that is one card segment")
        plan = plan_placement(self._rules, [], self.n_groups)
        return PartitionRuntime(chain.gpu_chain, plan, devices=[chain.gpu_chain.device],
                                chain=chain)

    # -- leader path ---------------------------------------------------------

    def _commit(self, key: str, partition: int, next_offset: int, out) -> None:
        self.served.setdefault(key, []).extend(out)
        self.leader.offsets.advance(key, next_offset)
        self.replica.publish(key, next_offset, self.leader.carry_snapshot(self.topic, partition))

    def run(self, slabs_by_partition: List[Tuple[int, object]]) -> None:
        """Process an interleaved stream of ``(partition, SmartModuleInput)``
        pairs. Each slab goes into the follower's log before the leader
        touches it (the follower's sync runs ahead of serving), so a death
        at any seam leaves its records replayable."""
        from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

        for partition, slab in list(slabs_by_partition):
            key = partition_key(self.topic, partition)
            base = max(self.leader.offsets.committed(key), 0)
            nxt = base + slab.record_count()
            self.logs.setdefault(key, _PartitionLog()).append(base, nxt, slab)
            try:
                buf = RecordBuffer.from_smartmodule_input(slab)
                out = self.leader.process(self.topic, partition, buf)
                self._commit(key, partition, nxt, out.to_records())
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                logger.warning("leader died serving %s (%s: %s); promoting a follower",
                               key, type(e).__name__, e)
                self.promote()

    # -- promotion -----------------------------------------------------------

    def promote(self) -> None:
        """Replace the dead leader: rebuild the chain from its spec, keep the
        committed consumer offsets, seed every partition from its last
        replicated carries and replay each log's un-acked suffix through the
        full ladder (a slab the ladder quarantines commits empty: its
        records are in the dead-letter directory)."""
        self.promotions += 1
        old_offsets = self.leader.offsets
        runtime = self._build_runtime()
        # committed consumer offsets survive the handoff: they live on the
        # replica bus, not in the dead leader
        for key, committed in old_offsets.snapshot().items():
            runtime.offsets.advance(key, committed)
        self.leader = runtime
        for key, plog in sorted(self.logs.items()):
            partition = int(key.rsplit("/", 1)[1])
            committed, carries, inst = self.replica.latest(key)
            if carries is not None:
                runtime.seed_partition(self.topic, partition, carries, inst_state=inst)
            for _base, nxt, slab in plog.unacked(committed):
                out = runtime.process_chain(self.topic, partition, slab)
                self._commit(key, partition, nxt, out.successes)

    # -- voluntary migration -------------------------------------------------

    def migrate_partition(self, partition: int, group: int, reason: str = "lag",
                          clock=None) -> dict:
        """Move ONE partition onto ``group`` as a controlled leader death:
        rewind it to its last committed replica snapshot (in-memory
        progress past it is dropped), move the assignment (the vacated group
        stays schedulable) and replay the un-acked suffix through the full
        ladder on the new group. A replay failure rolls back: the partition
        returns to its old group seeded with the newest committed snapshot
        (commits the partial replay made stay: they are monotonic), and the
        still un-acked suffix stays in the log for the next promotion or
        migration. Returns the move's document (``ok``, ``moved``, ``from``,
        ``to``, ``replayed``, ``seconds``, and ``error`` on a rollback): the
        rebalancer's dict-returning mover."""
        now = clock or time.monotonic
        t0 = now()
        key = partition_key(self.topic, partition)
        old_group = self.leader.plan.assignments.get(key)
        committed, carries, inst = self.replica.latest(key)
        plog = self.logs.get(key) or _PartitionLog()
        if not self.leader.move_partition(self.topic, partition, group):
            return {"ok": True, "moved": False, "from": old_group, "to": group,
                    "replayed": 0, "seconds": 0.0}
        if carries is not None:
            self.leader.seed_partition(self.topic, partition, carries, inst_state=inst)
        replayed = 0
        try:
            for _base, nxt, slab in plog.unacked(committed):
                out = self.leader.process_chain(self.topic, partition, slab)
                self._commit(key, partition, nxt, out.successes)
                replayed += 1
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            committed2, carries2, inst2 = self.replica.latest(key)
            self.leader.move_partition(self.topic, partition, old_group)
            if carries2 is not None:
                self.leader.seed_partition(self.topic, partition, carries2, inst_state=inst2)
            self.migrations_failed += 1
            seconds = max(now() - t0, 0.0)
            logger.warning("migration of %s -> group %d failed (%s: %s); rolled back",
                           key, group, type(e).__name__, e)
            self._note_move(key, old_group, group, reason, seconds, ok=False)
            return {"ok": False, "moved": False, "from": old_group, "to": group,
                    "replayed": replayed, "seconds": seconds,
                    "error": f"{type(e).__name__}: {e}"}
        self.migrations += 1
        seconds = max(now() - t0, 0.0)
        self._note_move(key, old_group, group, reason, seconds, ok=True)
        return {"ok": True, "moved": True, "from": old_group, "to": group,
                "replayed": replayed, "seconds": seconds}

    @staticmethod
    def _note_move(key, src, dst, reason, seconds, ok) -> None:
        if not TELEMETRY.enabled:
            return
        TELEMETRY.add_rebalance_move(reason if ok else "rollback", f"{key}:{src}->{dst}")
        TELEMETRY.add_migration_seconds(seconds)

    # -- accounting ----------------------------------------------------------

    def served_values(self, partition: int) -> List[bytes]:
        return [r.value for r in self.served.get(partition_key(self.topic, partition), [])]

    def final_carries(self, partition: int) -> List[tuple]:
        return self.leader.carry_snapshot(self.topic, partition)
