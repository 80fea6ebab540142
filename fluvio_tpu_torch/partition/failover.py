"""Carry replication for leader failover.

The port's copy of the replication half of
``fluvio_tpu/partition/failover.py``. A fused chain's aggregate carry is
tiny and constant-size (a few scalars per aggregate stage), so the leader
replicates ``(committed_offset, carries)`` to its followers on every
commit, and a promoted follower resumes from the last snapshot
(`PartitionRuntime.seed_partition`, or
`PartitionedWindowRuntime.seed` for window banks) with no carry transfer
from the dead leader.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


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
