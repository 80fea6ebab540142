"""Per-partition execution state over one shared chain executor.

The port's counterpart of ``fluvio_tpu/partition/runtime.py``. Each
``(topic, partition)`` owns its chain's aggregate carry, resident on its
placement group's device between batches, and a consumer offset on an
`OffsetPublisher` bus. The executor's one ``_device_carries`` slot becomes
a carry *bank*: one lowered chain (its learned explode capacity, link
counters and striped lowering stay per executor) whose few-scalar carry is
swapped per partition around each dispatch and finish. Swapping touches
pointers only; nothing syncs with the card until `carry_snapshot`.

Devices: the executor's lowered constants (needles, DFA tables and their
shared-memory images) live on its one device, so a group cannot move to
another card the way the reference moves a dispatch with
``jax.default_device``. This slice runs every group on ``executor.device``:
a fold over two or more distinct devices raises (cross-card placement is
``ROADMAP.md`` §1 item 6). On one card every group folds onto it, and a
carry "migration" after a move or a group failure re-points the bank and
copies nothing.

Threading: like the executor, a runtime is driven by ONE dispatcher at a
time. Its lock guards only the control-plane maps (states, plan), so a
rebalancer thread can move partitions while batches run.

Telemetry (the reference's seams): a partition's leader registers its
``topic/partition`` key with the lag engine and each ``advance`` moves its
committed offset there, so the rebalancer's default lag reader sees it;
each partition's carry tensors are booked under the device-memory
ledger's ``carry_bank`` owner after every dispatch and finish (a resize
of one entry) and retired by `seed_partition`.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import torch

from fluvio_tpu_torch.partition.placement import (
    PlacementPlan,
    device_for_group,
    fold_shape,
    make_partition_fold,
    partition_key,
)
from fluvio_tpu_torch.smartengine.gpu.executor import _Carry
from fluvio_tpu_torch.telemetry import TELEMETRY
from fluvio_tpu_torch.telemetry import lag as lag_mod
from fluvio_tpu_torch.types import OffsetPublisher

logger = logging.getLogger(__name__)


class PartitionOffsets:
    """Per-partition consumer-offset tracking.

    ``advance`` moves a partition's committed consumer offset (monotonic: a
    batch that is never served never calls it, so offsets never pass
    unserved records) and wakes that partition's `OffsetPublisher`
    listeners. ``attach_leader`` binds a leader replica (anything with
    ``leo()``) that ``lag`` reads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._committed: Dict[str, int] = {}
        self._publishers: Dict[str, OffsetPublisher] = {}
        self._leaders: Dict[str, object] = {}

    def publisher(self, key: str) -> OffsetPublisher:
        with self._lock:
            pub = self._publishers.get(key)
            if pub is None:
                pub = self._publishers[key] = OffsetPublisher(self._committed.get(key, -1))
            return pub

    def attach_leader(self, key: str, leader) -> None:
        """Bind the partition to its leader (LEO/HW source); the pair
        also registers with the streaming lag engine."""
        with self._lock:
            self._leaders[key] = leader
        if TELEMETRY.enabled:
            lag_mod.track_stream(key, leader)

    def leader(self, key: str):
        with self._lock:
            return self._leaders.get(key)

    def committed(self, key: str) -> int:
        with self._lock:
            return self._committed.get(key, -1)

    def advance(self, key: str, next_offset: int) -> bool:
        """Commit served progress; refuses to move backwards."""
        with self._lock:
            if next_offset <= self._committed.get(key, -1):
                return False
            self._committed[key] = next_offset
            pub = self._publishers.get(key)
        if pub is not None:
            pub.update(next_offset)
        if TELEMETRY.enabled:
            lag_mod.note_commit(key, next_offset)
        return True

    def lag(self, key: str) -> Optional[int]:
        """Unserved records behind the leader's LEO (None: no leader)."""
        with self._lock:
            leader = self._leaders.get(key)
            cur = self._committed.get(key, -1)
        if leader is None:
            return None
        return max(0, leader.leo() - max(cur, 0))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._committed)


@dataclass
class PartitionState:
    """One partition's execution state on its device group."""

    key: str
    group: int
    device_carries: Optional[tuple] = None  # the executor's carry tuple, on the card
    host_carries: List[tuple] = field(default_factory=list)
    carry_device: Optional[torch.device] = None  # where device_carries live
    batches: int = 0


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one card: compare devices by
    value, with the index filled in."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class PartitionRuntime:
    """Partition-parallel execution over one lowered chain.

    ``executor`` is the shared `GpuChainExecutor`; ``plan`` the placement;
    ``devices`` the devices to fold the groups onto (None: every visible
    CUDA device, raising without one). Every group's lead device must be
    ``executor.device``.
    """

    def __init__(self, executor, plan: PlacementPlan, devices=None):
        if executor is None:
            raise ValueError("PartitionRuntime needs a GPU chain executor")
        fold = make_partition_fold(plan.n_groups, devices=devices)
        distinct = {_canonical(d) for row in fold for d in row}
        if len(distinct) > 1:
            raise ValueError(
                f"the partition fold spans {len(distinct)} devices; this runtime runs "
                "every group on its executor's one device (cross-card placement is "
                "ROADMAP.md §1 item 6)"
            )
        if distinct != {_canonical(executor.device)}:
            raise ValueError(
                f"the partition fold's device {fold[0][0]} is not the executor's "
                f"{executor.device}"
            )
        self._executor = executor
        self._fold = fold
        self._lock = threading.Lock()
        self._plan = plan
        self._states: Dict[str, PartitionState] = {}
        self.offsets = PartitionOffsets()
        # what a new partition starts from: the chain spec's initial
        # aggregates, never the live executor's carries (a warmed executor
        # may already hold another stream's sums)
        self._seed_carries = executor.initial_carries()
        self._stateful = bool(executor.agg_configs)

    # -- control plane -------------------------------------------------------

    @property
    def plan(self) -> PlacementPlan:
        with self._lock:
            return self._plan

    @property
    def rebalances(self) -> int:
        with self._lock:
            return self._plan.rebalances

    @property
    def moves(self) -> int:
        with self._lock:
            return self._plan.moves

    def partitions(self) -> List[str]:
        with self._lock:
            return sorted(self._states)

    def device_of(self, group: int) -> torch.device:
        return device_for_group(self._fold, group)

    def _state(self, key: str) -> PartitionState:
        with self._lock:
            st = self._states.get(key)
            if st is None:
                if key not in self._plan.assignments:
                    self._plan = self._plan.with_partitions([key])
                st = PartitionState(key=key, group=self._plan.assignments[key],
                                    host_carries=list(self._seed_carries))
                self._states[key] = st
            return st

    def fail_group(self, group: int) -> int:
        """Leader-loss rebalance: move the group's partitions onto the
        survivors (`PlacementPlan.rebalance`). Carries follow at the next
        swap-in. Returns the number of partitions moved."""
        moved = 0
        with self._lock:
            self._plan = self._plan.rebalance(group)
            for st in self._states.values():
                new_group = self._plan.assignments.get(st.key, st.group)
                if new_group != st.group:
                    st.group = new_group
                    moved += 1
        logger.warning("device group %d failed: rebalanced %d partitions", group, moved)
        return moved

    def move_partition(self, topic: str, partition: int, group: int) -> bool:
        """Voluntary single-partition move (the rebalancer's actuator); the
        vacated group stays schedulable. Touches no device state, so it is
        safe from a control thread. Returns whether the assignment
        changed."""
        key = partition_key(topic, partition)
        with self._lock:
            plan = self._plan
            if key not in plan.assignments:
                plan = plan.with_partitions([key])
            new_plan = plan.move_partition(key, group)
            changed = new_plan is not plan
            self._plan = new_plan
            st = self._states.get(key)
            if st is not None and changed:
                st.group = group
        return changed

    # -- carry bank ----------------------------------------------------------

    def _swap_in(self, st: PartitionState) -> tuple:
        """Point the shared executor at this partition's state; returns the
        previous state for `_swap_out`. A carry left on another device than
        its group's moves there."""
        ex = self._executor
        prev = (ex._device_carries, ex.carries, ex.span_chain, ex.partition_tag)
        dev = self.device_of(st.group)
        carries = st.device_carries
        if carries is not None and st.carry_device is not None and (
                _canonical(st.carry_device) != _canonical(dev)):
            carries = tuple(_Carry(c.acc.to(dev), c.win.to(dev), c.has.to(dev))
                            for c in carries)
        # the device this swap used (a concurrent fail_group can change
        # st.group mid-dispatch; the carries committed live here)
        st.carry_device = dev
        ex._device_carries = carries
        ex.carries = list(st.host_carries)
        ex.set_partition_identity(st.key, st.group)
        return prev

    def _capture(self, st: PartitionState) -> None:
        ex = self._executor
        st.device_carries = ex._device_carries
        st.host_carries = list(ex.carries)
        st.batches += 1
        # the partition's carry bank stays on the card between batches:
        # a persistent owner, re-booked (a resize) every capture
        if TELEMETRY.enabled:
            carries = st.device_carries
            if carries is None:
                TELEMETRY.mem_release(("carry", st.key))
            else:
                nbytes = sum(c.acc.nbytes + c.win.nbytes + c.has.nbytes for c in carries)
                TELEMETRY.mem_acquire("carry_bank", ("carry", st.key), nbytes)

    def _swap_out(self, prev: tuple) -> None:
        ex = self._executor
        ex._device_carries, ex.carries, ex.span_chain, ex.partition_tag = prev

    def carry_snapshot(self, topic: str, partition: int) -> List[tuple]:
        """The partition's carries on the host, ``(acc, win, has)`` per
        aggregate: the few scalars a failover replica holds. Costs one
        sync when they live on the card."""
        st = self._state(partition_key(topic, partition))
        if st.device_carries:
            host = torch.stack([torch.stack([c.acc, c.win, c.has.to(torch.int64)])
                                for c in st.device_carries]).tolist()
            return [(int(acc), int(win), bool(has)) for acc, win, has in host]
        return [tuple(c) for c in st.host_carries]

    def seed_partition(self, topic: str, partition: int, host_carries: Iterable[tuple]) -> None:
        """Install replicated carry state (follower promotion): the
        partition resumes from the snapshot, on its group's device again at
        its next dispatch."""
        st = self._state(partition_key(topic, partition))
        st.device_carries = None
        st.carry_device = None
        # the old device-resident bank is garbage now: retire its booking
        TELEMETRY.mem_release(("carry", st.key))
        st.host_carries = [tuple(c) for c in host_carries]

    # -- data plane ----------------------------------------------------------

    def dispatch(self, topic: str, partition: int, buf):
        """Stage and dispatch one partition batch (asynchronous: `finish`
        collects). Carries commit at dispatch, so interleaving partitions
        is exact."""
        st = self._state(partition_key(topic, partition))
        prev = self._swap_in(st)
        try:
            return self._executor.dispatch_buffer(buf)
        finally:
            self._capture(st)
            self._swap_out(prev)

    def finish(self, topic: str, partition: int, buf, handle):
        """Wait for one partition batch's results. A stateful chain enters
        the partition's carry slot first: a failed fetch or an explode's
        re-run moves the executor's carries, and that must land on THIS
        partition's state, not a neighbour's."""
        st = self._state(partition_key(topic, partition))
        ex = self._executor
        if not self._stateful:
            prev = ex.set_partition_identity(st.key, st.group)
            try:
                return ex.finish_buffer(buf, handle)
            finally:
                ex.restore_partition_identity(prev)
        prev = self._swap_in(st)
        try:
            return ex.finish_buffer(buf, handle)
        finally:
            self._capture(st)
            self._swap_out(prev)

    def process(self, topic: str, partition: int, buf):
        return self.finish(topic, partition, buf, self.dispatch(topic, partition, buf))

    def _discard(self, topic: str, partition: int, handle) -> None:
        """Drop an in-flight batch; a stateful chain's carry restore lands
        in the batch's own partition slot."""
        if not self._stateful:
            self._executor.discard_dispatch(handle)
            return
        st = self._state(partition_key(topic, partition))
        prev = self._swap_in(st)
        try:
            self._executor.discard_dispatch(handle)
        finally:
            self._capture(st)
            self._swap_out(prev)

    def process_interleaved(self, items, depth: int = 2):
        """Pipelined generator over ``(topic, partition, buf)`` triples,
        yielding ``(topic, partition, buf, output)``.

        Up to ``depth`` batches stay in flight: partition A's batch k+1 is
        staged and queued on the card while partition B's batch k is
        rebuilt on the host. With the up link on, one worker compresses the
        next buffer while the current one dispatches (settled before that
        buffer stages). A chain with an explode and an aggregate runs one
        batch at a time, as `process_stream` does: an overflow re-run must
        restart from carries a later dispatch would already have moved on
        from. On an error, every in-flight batch is discarded and its
        partition's carries go back to where the batch found them."""
        items = list(items)
        ex = self._executor
        if self._stateful and ex._fanout:
            depth = 0
        inflight: List[tuple] = []
        fut = None
        pool: Optional[ThreadPoolExecutor] = None
        try:
            for i, (topic, part, buf) in enumerate(items):
                if fut is not None:
                    fut.result()
                    fut = None
                handle = self.dispatch(topic, part, buf)
                inflight.append((topic, part, buf, handle))
                if i + 1 < len(items):
                    nxt = items[i + 1][2]
                    job = ex.precompress_fn(nxt)
                    if job is not None:
                        if pool is None:
                            pool = ThreadPoolExecutor(max_workers=1,
                                                      thread_name_prefix="glz-compress")
                        fut = pool.submit(job, nxt)
                while len(inflight) > max(depth, 0):
                    t, p, b, h = inflight.pop(0)
                    yield t, p, b, self.finish(t, p, b, h)
            while inflight:
                t, p, b, h = inflight.pop(0)
                yield t, p, b, self.finish(t, p, b, h)
        except BaseException:
            if fut is not None:
                fut.cancel()
            # newest first: two in-flight batches of one partition leave
            # it at the older one's starting carries
            for t, p, _b, h in reversed(inflight):
                self._discard(t, p, h)
            raise
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    # -- observability -------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            plan = self._plan
            states = {k: {"group": st.group, "batches": st.batches}
                      for k, st in sorted(self._states.items())}
        return {
            "plan": plan.to_dict(),
            "partitions": states,
            "offsets": self.offsets.snapshot(),
            "mesh": {"axes": fold_shape(self._fold)},
        }
