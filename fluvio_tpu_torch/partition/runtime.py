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

The full ladder. A runtime built with ``chain=`` (the
`SmartModuleChainInstance` whose card segment ``executor`` is) also runs
one partition slab through the engine's whole ladder (`process_chain`:
the executor's retries, the card re-run, the quarantine), the promotion
replay of `failover.FailoverCoordinator`. Besides the executor's carries,
each partition then keeps the state of the chain's other segments (a
mixed chain's host hooks and further card segments, in
`SmartModuleChainInstance._snapshot` form), swapped in the same way.

The broker's gate. `BrokerPartitionGate` is the SPU's placement seam: a
broker stream already owns its chain (one stream, one partition), so the
gate gives each slice its partition's group, the ``chain@topic/partition``
identity on the executor and, on the card, its group's device
(`_GateScope`). It folds under the same one-device rule.

Telemetry (the reference's seams): a partition's leader registers its
``topic/partition`` key with the lag engine and each ``advance`` moves its
committed offset there, so the rebalancer's default lag reader sees it;
each partition's carry tensors are booked under the device-memory
ledger's ``carry_bank`` owner after every dispatch and finish (a resize
of one entry) and retired by `seed_partition`.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import torch

from fluvio_tpu_torch.partition.placement import (
    DEFAULT_RULES,
    PlacementPlan,
    device_for_group,
    fold_shape,
    make_partition_fold,
    partition_key,
    plan_placement,
    validate_rules,
)
from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor, _Carry
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
    # the chain's other segments' state (`process_chain`), one entry a
    # segment in `SmartModuleChainInstance._snapshot` form; the runtime's
    # own executor's entry is unused (its carries are the two above)
    inst_state: Optional[list] = None


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one card: compare devices by
    value, with the index filled in."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _one_device_fold(n_groups: int, devices, executor_device=None):
    """The groups' fold (`make_partition_fold`), which must name one device
    (and, given ``executor_device``, that one): cross-card placement is
    ``ROADMAP.md`` §1 item 6. Raises `ValueError` otherwise."""
    fold = make_partition_fold(n_groups, devices=devices)
    distinct = {_canonical(d) for row in fold for d in row}
    if len(distinct) > 1:
        raise ValueError(
            f"the partition fold spans {len(distinct)} devices; this runtime runs "
            "every group on its executor's one device (cross-card placement is "
            "ROADMAP.md §1 item 6)"
        )
    if executor_device is not None and distinct != {_canonical(executor_device)}:
        raise ValueError(
            f"the partition fold's device {fold[0][0]} is not the executor's "
            f"{executor_device}"
        )
    return fold


def _device_scope(dev: torch.device):
    """The current-device scope of a group's device (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class PartitionRuntime:
    """Partition-parallel execution over one lowered chain.

    ``executor`` is the shared `GpuChainExecutor`; ``plan`` the placement;
    ``devices`` the devices to fold the groups onto (None: every visible
    CUDA device, raising without one). Every group's lead device must be
    ``executor.device``. ``chain`` (optional) is the chain instance that
    holds ``executor`` as a segment; with it, `process_chain` runs the
    engine's full ladder per partition.
    """

    def __init__(self, executor, plan: PlacementPlan, devices=None, chain=None):
        if executor is None:
            raise ValueError("PartitionRuntime needs a GPU chain executor")
        if chain is not None and not any(seg is executor for seg in chain.segments):
            raise ValueError("the executor is not a segment of the chain")
        self._executor = executor
        self._fold = _one_device_fold(plan.n_groups, devices, executor.device)
        self._chain = chain
        self._lock = threading.Lock()
        self._plan = plan
        self._states: Dict[str, PartitionState] = {}
        self.offsets = PartitionOffsets()
        # what a new partition starts from: the chain spec's initial
        # aggregates, never the live executor's carries (a warmed executor
        # may already hold another stream's sums)
        self._seed_carries = executor.initial_carries()
        self._seed_inst = self._seed_segments() if chain is not None else None
        self._stateful = bool(executor.agg_configs)

    def _seed_segments(self) -> list:
        """What a new partition's other segments start from, from the chain
        spec as the carries are: a card segment's initial carries, a host
        segment's ``initial_data``."""
        out: list = []
        for seg in self._chain.segments:
            if seg is self._executor:
                out.append(None)
            elif isinstance(seg, GpuChainExecutor):
                out.append((None, seg.initial_carries()))
            else:
                out.append(seg.config.initial_data)
        return out

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
                                    host_carries=list(self._seed_carries),
                                    inst_state=(list(self._seed_inst)
                                                if self._seed_inst is not None else None))
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

    def seed_partition(self, topic: str, partition: int, host_carries: Iterable[tuple],
                       inst_state: Optional[list] = None) -> None:
        """Install replicated carry state (follower promotion): the
        partition resumes from the snapshot, on its group's device again at
        its next dispatch. ``inst_state`` is the chain's other segments'
        state (`process_chain`'s form); None starts them from the spec."""
        st = self._state(partition_key(topic, partition))
        st.device_carries = None
        st.carry_device = None
        # the old device-resident bank is garbage now: retire its booking
        TELEMETRY.mem_release(("carry", st.key))
        st.host_carries = [tuple(c) for c in host_carries]
        if inst_state is not None:
            st.inst_state = list(inst_state)
        elif self._seed_inst is not None:
            st.inst_state = list(self._seed_inst)

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

    def process_chain(self, topic: str, partition: int, inp):
        """One partition slab (a `SmartModuleInput`) through the chain's
        full ladder (`SmartModuleChainInstance.process`: the executor's
        retries, the card re-run, the quarantine) on the partition's state:
        the executor's carries swap as in `dispatch`, every other segment's
        state through the chain's ``_snapshot`` / ``_restore``. A
        quarantined slab leaves the partition where the slab found it. The
        promotion replay's entry point (`failover.py`). Returns the chain's
        `SmartModuleOutput`."""
        if self._chain is None:
            raise ValueError("process_chain needs the runtime built with chain=")
        st = self._state(partition_key(topic, partition))
        chain, ex = self._chain, self._executor
        prev_segments = chain._snapshot()
        prev = self._swap_in(st)
        chain._restore([(ex._device_carries, list(ex.carries)) if seg is ex else state
                        for seg, state in zip(chain.segments, st.inst_state)])
        try:
            with _device_scope(self.device_of(st.group)):
                return chain.process(inp)
        finally:
            self._capture(st)
            st.inst_state = [None if seg is ex else state
                             for seg, state in zip(chain.segments, chain._snapshot())]
            chain._restore(prev_segments)
            self._swap_out(prev)

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


class BrokerPartitionGate:
    """The broker's placement seam (`SpuConfig.partitions`, or
    `fluvio_tpu_torch.partition.set_gate`).

    A broker stream owns its chain (one stream, one partition), so its
    carries are per partition already; what the gate adds is placement:
    each slice's dispatches and finish run in its partition's group scope
    (`scope`), with the ``chain@topic/partition`` identity on the spans,
    declines and down-link families. ``rules`` (None: `DEFAULT_RULES`) are
    validated here, so a rule pinning a group past ``n_groups`` fails when
    the gate is built, never on the first slice of some topic. The groups
    fold onto ``devices`` (None: the visible CUDA devices) under the
    runtime's one-device rule."""

    def __init__(self, n_groups: int, rules=None, devices=None):
        rules = tuple(rules) if rules is not None else DEFAULT_RULES
        validate_rules(rules, n_groups)
        self._lock = threading.Lock()
        self._plan = plan_placement(rules, [], n_groups)
        self._fold = _one_device_fold(n_groups, devices)

    @property
    def plan(self) -> PlacementPlan:
        with self._lock:
            return self._plan

    def device_of(self, group: int) -> torch.device:
        return device_for_group(self._fold, group)

    def group_for(self, topic: str, partition: int) -> int:
        """The partition's group, placed by the rules on first sight (no
        matching rule raises `ValueError`)."""
        key = partition_key(topic, partition)
        with self._lock:
            if key not in self._plan.assignments:
                self._plan = self._plan.with_partitions([key])
            return self._plan.assignments[key]

    def fail_group(self, group: int) -> None:
        with self._lock:
            self._plan = self._plan.rebalance(group)

    def move_partition(self, topic: str, partition: int, group: int) -> bool:
        """Voluntary move (the rebalancer's actuator): the stream's slices
        take the new group from the next one; the vacated group stays
        schedulable. Returns whether the assignment changed."""
        key = partition_key(topic, partition)
        with self._lock:
            plan = self._plan
            if key not in plan.assignments:
                plan = plan.with_partitions([key])
            new_plan = plan.move_partition(key, group)
            changed = new_plan is not plan
            self._plan = new_plan
        return changed

    def scope(self, topic: str, partition: int, executor) -> "_GateScope":
        """A context manager: the partition's identity on ``executor`` and
        its group's device for one slice's dispatches or finish."""
        return _GateScope(self, topic, partition, executor)


class _GateScope:
    def __init__(self, gate: BrokerPartitionGate, topic: str, partition: int, executor):
        self._gate = gate
        self._topic = topic
        self._partition = partition
        self._ex = executor
        self._prev = None
        self._dev_ctx = None

    def __enter__(self) -> int:
        group = self._gate.group_for(self._topic, self._partition)
        dev = self._gate.device_of(group)
        if _canonical(dev) != _canonical(self._ex.device):
            # the executor's lowered constants live on its one device
            raise ValueError(f"group {group} is on {dev}, the chain on {self._ex.device}")
        self._prev = self._ex.set_partition_identity(
            partition_key(self._topic, self._partition), group)
        self._dev_ctx = _device_scope(dev)
        self._dev_ctx.__enter__()
        return group

    def __exit__(self, *exc) -> bool:
        try:
            self._dev_ctx.__exit__(*exc)
        finally:
            self._ex.restore_partition_identity(self._prev)
        return False
