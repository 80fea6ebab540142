"""Partitioned topics through a leader loss: the port's carry replication,
promotion replay, migration and the broker's partition gate
(``fluvio_tpu_torch.partition``, ``spu/replica.py``, ``spu/smart_chain.py``)
on the CPU against the JAX package's (``fluvio_tpu.partition``, its own
tests' way: ``backend="tpu"`` on the JAX CPU device), tolerance 0.

The stream is the JAX chaos suite's (``tests/test_partition_failover.py``):
``regex-filter("fluvio")`` -> ``aggregate-field(n, add)`` over six slabs
interleaved across two partitions. Carries must be bit-equal, served values
and committed offsets equal.

Pinned divergences (``ROADMAP.md`` §3, "a fault on every card attempt"):
the JAX package's promotion replay re-runs a failed fused attempt in its
interpreter, which passes no card seam; the port's re-run is the card again.
A deterministic fault armed ``first=K`` fires on the first K crossings: the
leader dies on crossing 1, and the promoted chain's fused attempt and its
re-run meet crossings 2 and 3. So for ``K >= 3`` the port quarantines the
slab that killed the leader where the JAX package serves it, and the poison
schedule (``device every=1``) quarantines every slab. Those cases assert the
port's own exactly-once accounting: every input committed once, every
dead-lettered record an input, no record both served and dead-lettered,
and the carries the sum over exactly the records that were not
dead-lettered.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from collections import Counter

import jax
import pytest
import torch

from fluvio_tpu import partition as ref_partition
from fluvio_tpu.partition import failover as ref_failover
from fluvio_tpu.partition import placement as ref_placement
from fluvio_tpu.partition import rebalancer as ref_rebalancer
from fluvio_tpu.partition import runtime as ref_runtime
from fluvio_tpu.resilience import faults as ref_faults
from fluvio_tpu.telemetry import TELEMETRY as REF_TELEMETRY
from fluvio_tpu_torch import interop
from fluvio_tpu_torch import partition
from fluvio_tpu_torch.partition import (
    BrokerPartitionGate,
    CarryReplica,
    FailoverCoordinator,
    PartitionGateConfig,
    PartitionRebalancer,
    PartitionRuntime,
    RebalanceConfig,
    chain_from_spec,
    parse_placement_rules,
    partition_key,
    plan_placement,
)
from fluvio_tpu_torch.resilience import faults
from fluvio_tpu_torch.resilience.policy import ResilienceConfig
from fluvio_tpu_torch.telemetry import TELEMETRY
from tests.test_torch_isolation import gen_json, hook_chain, partitioned_truth
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

CHAIN_SPEC = [
    {"name": "regex-filter", "kind": "filter", "params": {"regex": "fluvio"}},
    {"name": "aggregate-field", "kind": "aggregate", "params": {"field": "n", "combine": "add"}},
]
FILTER_SPEC = [{"name": "regex-filter", "kind": "filter", "params": {"regex": "fluvio"}}]
LEADER_POINTS = ("stage", "h2d", "dispatch", "device", "fetch")
EXTRA = ([10, 11], [12])  # the un-acked suffix a migration replays
STREAM = ((0, [1, 2]), (1, [5]), (0, [3]), (1, [7, 8]), (0, [4, 6]), (1, [9]))


def _slab(pkg: str, vals, keep: bool = True):
    if pkg == "ref":
        from fluvio_tpu.protocol.record import Record
        from fluvio_tpu.smartmodule.types import SmartModuleInput
    else:
        from fluvio_tpu_torch.protocol.record import Record
        from fluvio_tpu_torch.smartmodule.types import SmartModuleInput
    tag = "fluvio" if keep else "other"
    return SmartModuleInput.from_records(
        [Record(value=json.dumps({"n": v, "name": f"{tag}-{v}"}).encode()) for v in vals],
        base_offset=0, base_timestamp=0)


def _stream(pkg: str, stream=STREAM):
    return [(p, _slab(pkg, vals)) for p, vals in stream]


def _inputs():
    """Each partition's input values, in order."""
    per = {0: [], 1: []}
    for p, vals in STREAM:
        per[p] += [json.dumps({"n": v, "name": f"fluvio-{v}"}).encode() for v in vals]
    return per


def _ref(**kw):
    return ref_failover.FailoverCoordinator(CHAIN_SPEC, n_groups=2, **kw)


def _port(tmp_path, spec=CHAIN_SPEC, **kw):
    cfg = ResilienceConfig(retry_base_ms=0, deadletter_dir=str(tmp_path / "deadletter"))
    return FailoverCoordinator(spec, n_groups=2, device="cpu", resilience=cfg, **kw)


def _state(coord):
    """(final carries, served values, committed offsets) of both partitions."""
    return ([coord.final_carries(p) for p in (0, 1)],
            [coord.served_values(p) for p in (0, 1)],
            coord.leader.offsets.snapshot())


def _dead_values(dirpath):
    """Every record value in the dead-letter directory's entries."""
    import base64

    if not os.path.isdir(dirpath):
        return []
    out = []
    for f in sorted(os.listdir(dirpath)):
        if f.endswith(".json"):
            with open(os.path.join(dirpath, f)) as fh:
                entry = json.load(fh)
            out += [base64.b64decode(r["value"]) for r in entry["batch"]["records"]]
    return out


def _arm(point: str, **kw) -> None:
    """The same schedule in both packages' fault registries."""
    for reg in (ref_faults.FAULTS, faults.FAULTS):
        reg.inject(point, **kw)


@pytest.fixture(autouse=True)
def _clean_faults():
    for reg in (ref_faults.FAULTS, faults.FAULTS):
        reg.clear()
    yield
    for reg in (ref_faults.FAULTS, faults.FAULTS):
        reg.clear()


@pytest.fixture(autouse=True)
def _gates_reset():
    ref_partition.reset_gate()
    partition.configure(PartitionGateConfig())
    yield
    ref_partition.reset_gate()
    partition.configure(PartitionGateConfig())


@pytest.fixture(scope="module")
def clean():
    """The no-fault run of the JAX coordinator: the truth every arm ends at."""
    coord = _ref()
    coord.run(_stream("ref"))
    return _state(coord)


# ---------------------------------------------------------------------------
# the replica: LeaderReplicaState.publish_carry and the bus
# ---------------------------------------------------------------------------

def test_carry_replica_mirrors_onto_a_real_leader(tmp_path):
    """`CarryReplica.bind_leader` on each package's `LeaderReplicaState`:
    each publish lands in the leader's ``carry_state`` and wakes its carry
    bus, equal across the packages."""
    from fluvio_tpu.spu.replica import LeaderReplicaState as RefLeader
    from fluvio_tpu.storage.config import ReplicaConfig as RefReplicaConfig
    from fluvio_tpu_torch.spu.replica import LeaderReplicaState
    from fluvio_tpu_torch.storage.config import ReplicaConfig

    ref_leader = RefLeader("t", 0, RefReplicaConfig(base_dir=str(tmp_path / "ref")))
    leader = LeaderReplicaState("t", 0, ReplicaConfig(base_dir=str(tmp_path / "port")))
    try:
        for rep, ldr in ((ref_failover.CarryReplica(), ref_leader), (CarryReplica(), leader)):
            assert ldr.carry_state is None and ldr.carry_publisher.current_value() == -1
            rep.bind_leader("t/0", ldr)
            rep.publish("t/0", 7, [(42, 0, True)])
            rep.publish("t/1", 3, [(5, 0, True)])  # no leader bound: the bus only
            rep.publish("t/0", 9, [[44, 0, True]], inst_state=[(b"44", None)])
        assert leader.carry_state == ref_leader.carry_state == (9, [(44, 0, True)])
        assert leader.carry_publisher.current_value() == 9
        assert ref_leader.carry_publisher.current_value() == 9
    finally:
        leader.close()
        ref_leader.close()


def test_partition_log_unacked():
    ref_log, port_log = ref_failover._PartitionLog(), partition.failover._PartitionLog()
    for lg in (ref_log, port_log):
        lg.append(0, 2, "a")
        lg.append(2, 3, "b")
        lg.append(3, 5, "c")
    for committed in (-1, 0, 2, 3, 5):
        assert port_log.unacked(committed) == ref_log.unacked(committed), committed
    assert port_log.unacked(3) == [(3, 5, "c")]


# ---------------------------------------------------------------------------
# chain_from_spec
# ---------------------------------------------------------------------------

def test_chain_from_spec_round_trip():
    """The rebuilt chain is one card segment, keeps the spec's identity and
    serves what the JAX package's rebuilt chain serves."""
    chain = chain_from_spec(CHAIN_SPEC, device="cpu")
    ref = ref_failover.chain_from_spec(CHAIN_SPEC, backend="tpu")
    assert chain.backend_in_use == "gpu" and chain.gpu_chain is not None
    assert [m["name"] for m in chain.chain_spec] == [m["name"] for m in ref.chain_spec] == [
        "regex-filter", "aggregate-field"]
    for vals in ([1, 2], [3], [4, 6]):
        out, want = chain.process(_slab("port", vals)), ref.process(_slab("ref", vals))
        assert out.error is None and want.error is None
        assert [r.value for r in out.successes] == [r.value for r in want.successes]
    seeded = chain_from_spec([dict(CHAIN_SPEC[0]), dict(CHAIN_SPEC[1], initial="MTAw")],
                             device="cpu")  # initial_data b"100"
    assert [r.value for r in seeded.process(_slab("port", [1])).successes] == [b"101"]


def test_a_chain_of_several_segments_is_refused():
    """Two explodes cut into two card segments: no ``gpu_chain``, so the
    coordinator refuses it, as the JAX one refuses a chain with no fused
    executor (its interpreter backend's)."""
    spec = [{"name": "array-map-json", "kind": "array_map", "params": {}},
            {"name": "array-map-json", "kind": "array_map", "params": {}}]
    assert chain_from_spec(spec, device="cpu").gpu_chain is None
    with pytest.raises(ValueError):
        FailoverCoordinator(spec, device="cpu")
    with pytest.raises(ValueError):
        ref_failover.FailoverCoordinator(CHAIN_SPEC, backend="python")


# ---------------------------------------------------------------------------
# leader death at every seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", LEADER_POINTS)
def test_leader_death_at_every_seam_equals_reference(point, clean, tmp_path):
    """``first=1``: the leader dies on its first crossing, the promoted chain
    replays the un-acked suffix on the card and everything equals the JAX
    coordinator's run (which equals the run that never failed over)."""
    _arm(point, first=1, exc="deterministic")
    ref = _ref()
    ref.run(_stream("ref"))
    port = _port(tmp_path)
    port.run(_stream("port"))
    assert ref_faults.FAULTS.rule(point).fired and faults.FAULTS.rule(point).fired
    assert port.promotions == ref.promotions >= 1
    assert _state(port) == _state(ref)
    assert _state(port)[0] == clean[0]
    assert _dead_values(tmp_path / "deadletter") == []


@pytest.mark.parametrize("point", LEADER_POINTS)
@pytest.mark.parametrize("nth", (3, 5))
def test_a_fault_through_both_card_attempts_quarantines_divergence(point, nth, clean,
                                                                  tmp_path):
    """Pinned divergence: ``first=3`` / ``first=5`` also fail the promoted
    chain's fused attempt and its card re-run, so the port quarantines the
    slab that killed the leader (partition 0's ``[1, 2]``) where the JAX
    interpreter serves it. The JAX run equals the clean one; the port's is
    exactly-once, its carries the sum over the records not dead-lettered."""
    _arm(point, first=nth, exc="deterministic")
    ref = _ref()
    ref.run(_stream("ref"))
    port = _port(tmp_path)
    port.run(_stream("port"))
    assert ref.promotions >= 1 and port.promotions >= 1
    assert _state(ref) == clean
    dead = _dead_values(tmp_path / "deadletter")
    inputs = _inputs()
    assert Counter(dead) == Counter(inputs[0][:2])  # the first slab, once
    assert port.leader.offsets.snapshot() == ref.leader.offsets.snapshot() == {
        "t/0": len(inputs[0]), "t/1": len(inputs[1])}
    for p in (0, 1):
        kept = [v for v in inputs[p] if v not in dead]
        assert port.final_carries(p) == [(partitioned_truth(kept), 0, True)]
        assert not set(port.served_values(p)) & set(dead)
    assert port.final_carries(0) != ref.final_carries(0)
    assert port.final_carries(1) == ref.final_carries(1)


def test_transient_fault_recovers_without_promotion(clean, tmp_path):
    _arm("device", first=2, exc="transient")
    ref = _ref()
    ref.run(_stream("ref"))
    port = _port(tmp_path)
    port.run(_stream("port"))
    assert port.promotions == ref.promotions == 0
    assert _state(port) == _state(ref) == clean


def test_poison_replay_divergence_every_card_attempt_fails(clean, tmp_path, monkeypatch):
    """Pinned divergence: ``device every=1`` kills every leader and fails
    every card attempt of the promoted chains (``spill_rerun first=2`` as the
    JAX suite arms it). The JAX interpreter serves all but the batch its
    re-run seam poisons; the port quarantines every slab. Its accounting is
    exactly-once all the same: every input committed once and dead-lettered
    once, nothing served, every carry the spec's seed."""
    monkeypatch.setenv("FLUVIO_DEADLETTER_DIR", str(tmp_path / "ref-deadletter"))
    _arm("device", every=1, exc="deterministic")
    _arm("spill_rerun", first=2, exc="deterministic")
    ref = _ref()
    ref.run(_stream("ref"))
    port = _port(tmp_path)
    port.run(_stream("port"))
    inputs = _inputs()
    every = inputs[0] + inputs[1]
    ref_dead = _dead_values(tmp_path / "ref-deadletter")
    assert ref.promotions >= 1 and ref_dead and set(ref_dead) <= set(every)
    assert len(ref_dead) < len(every)
    dead = _dead_values(tmp_path / "deadletter")
    assert port.promotions == len(STREAM)
    assert Counter(dead) == Counter(every)
    assert port.leader.offsets.snapshot() == ref.leader.offsets.snapshot() == {
        "t/0": len(inputs[0]), "t/1": len(inputs[1])}
    assert [port.served_values(p) for p in (0, 1)] == [[], []]
    assert [port.final_carries(p) for p in (0, 1)] == [[(0, 0, True)]] * 2


@pytest.mark.parametrize("nth", (1, 3))
def test_promotion_keeps_committed_offsets(nth, tmp_path):
    _arm("device", first=nth, exc="deterministic")
    ref = _ref()
    ref.run(_stream("ref"))
    port = _port(tmp_path)
    port.run(_stream("port"))
    assert ref.promotions >= 1 and port.promotions >= 1
    inputs = _inputs()
    assert port.leader.offsets.snapshot() == ref.leader.offsets.snapshot() == {
        "t/0": len(inputs[0]), "t/1": len(inputs[1])}
    assert port.replica.snapshot() == ref.replica.snapshot()


# ---------------------------------------------------------------------------
# PartitionRuntime.process_chain
# ---------------------------------------------------------------------------

def _runtimes(spec=CHAIN_SPEC):
    ref_chain = ref_failover.chain_from_spec(spec, backend="tpu")
    ref_rt = ref_runtime.PartitionRuntime(
        ref_chain.tpu_chain,
        ref_placement.plan_placement(ref_placement.parse_placement_rules(".*=spread"), [], 2),
        chain=ref_chain, devices=jax.devices()[:1])
    chain = chain_from_spec(spec, device="cpu",
                            resilience=ResilienceConfig(retry_base_ms=0))
    rt = PartitionRuntime(chain.gpu_chain, plan_placement(parse_placement_rules(".*=spread"),
                                                           [], 2),
                          devices=["cpu"], chain=chain)
    return ref_rt, rt


def test_process_chain_full_ladder_per_partition():
    """A deterministic ``device`` fault in one partition's slab: the card
    re-run serves it, and it lands in that partition's carries only."""
    ref_rt, rt = _runtimes()
    for pkg, r in (("ref", ref_rt), ("port", rt)):
        r.process_chain("t", 0, _slab(pkg, [1, 2]))
        r.process_chain("t", 1, _slab(pkg, [10]))
    _arm("device", first=1, exc="deterministic")
    outs = [r.process_chain("t", 0, _slab(pkg, [3])) for pkg, r in (("ref", ref_rt),
                                                                    ("port", rt))]
    assert all(o.error is None for o in outs)
    assert [r.value for r in outs[1].successes] == [r.value for r in outs[0].successes] == [
        b"6"]
    for p, want in ((0, 6), (1, 10)):
        assert rt.carry_snapshot("t", p) == ref_rt.carry_snapshot("t", p) == [(want, 0, True)]


def test_process_chain_interleaves_with_dispatch():
    """The fast path (`process`) and the ladder (`process_chain`) share a
    partition's carries."""
    from fluvio_tpu.smartengine.tpu.buffer import RecordBuffer as RefBuffer
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    ref_rt, rt = _runtimes()
    for k, (p, vals) in enumerate(STREAM):
        if k % 2:
            ref_rt.process("t", p, RefBuffer.from_smartmodule_input(_slab("ref", vals)))
            rt.process("t", p, RecordBuffer.from_smartmodule_input(_slab("port", vals)))
        else:
            ref_rt.process_chain("t", p, _slab("ref", vals))
            rt.process_chain("t", p, _slab("port", vals))
    for p in (0, 1):
        assert rt.carry_snapshot("t", p) == ref_rt.carry_snapshot("t", p)


HOOK_SUM_SM = b"""
@smartmodule.aggregate
def total(acc, record):
    import json
    return str(int(acc or b"0") + json.loads(record.value)["n"]).encode()
"""


def test_process_chain_keeps_host_segment_state_per_partition():
    """A mixed chain (a card filter, a host aggregate hook): the hook's
    accumulator is per partition too, equal to one chain a partition."""
    specs = [("regex-filter", {"regex": "fluvio"}), (HOOK_SUM_SM, {})]
    chain = hook_chain(specs, "cpu")
    card = chain.segments[0]
    rt = PartitionRuntime(card, plan_placement(parse_placement_rules(".*=spread"), [], 2),
                          devices=["cpu"], chain=chain)
    alone = {p: hook_chain(specs, "cpu") for p in (0, 1)}
    for p, vals in STREAM:
        got = rt.process_chain("t", p, _slab("port", vals))
        want = alone[p].process(_slab("port", vals))
        assert [r.value for r in got.successes] == [r.value for r in want.successes]
    for p in (0, 1):
        assert rt._state(partition_key("t", p)).inst_state[1] == alone[p].segments[1].accumulator
    # a seeded partition starts its hook from the replicated snapshot
    rt.seed_partition("t", 0, [], inst_state=[None, b"1000"])
    assert [r.value for r in rt.process_chain("t", 0, _slab("port", [5])).successes] == [
        b"1005"]
    with pytest.raises(ValueError):
        PartitionRuntime(alone[0].segments[0], rt.plan, devices=["cpu"], chain=chain)


# ---------------------------------------------------------------------------
# voluntary migration
# ---------------------------------------------------------------------------

def _before_migration(coord, pkg: str):
    """``stream[:3]`` served, then ``EXTRA`` synced into partition 0's log
    un-acked (replication runs ahead of serving). Returns (key, committed,
    the other live group)."""
    coord.run(_stream(pkg)[:3])
    key = "t/0"
    committed = coord.leader.offsets.committed(key)
    base = max(committed, 0)
    for vals in EXTRA:
        coord.logs[key].append(base, base + len(vals), _slab(pkg, vals))
        base += len(vals)
    src = coord.leader.plan.assignments[key]
    dst = next(g for g in coord.leader.plan.live_groups() if g != src)
    return key, committed, dst


def _doc(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "seconds"}


def test_migration_equals_promotion(tmp_path):
    """Partition 0 migrates with two un-acked slabs: the replay on the new
    group ends equal to a plain promotion's, in both packages."""
    runs = {}
    for pkg, make in (("ref", _ref), ("port", lambda: _port(tmp_path))):
        promoted, migrated = make(), make()
        _before_migration(promoted, pkg)
        promoted.promote()
        promoted.run(_stream(pkg)[3:])
        _, _, dst = _before_migration(migrated, pkg)
        res = migrated.migrate_partition(0, dst, reason="lag")
        migrated.run(_stream(pkg)[3:])
        assert res["ok"] and res["moved"] and res["replayed"] == len(EXTRA)
        assert migrated.migrations == 1 and migrated.promotions == 0
        assert _state(migrated) == _state(promoted)
        runs[pkg] = (_state(migrated), _doc(res))
    assert runs["port"] == runs["ref"]


@pytest.mark.parametrize("fail_at", (1, 2))
def test_failed_migration_rolls_back(fail_at, tmp_path):
    """The replay dies on its first (or second) slab: the partition goes
    back to its old group seeded with the newest committed snapshot (a
    slab the replay committed stays committed), the rest stays in the log
    for the next promotion, and the run ends equal to one that never
    migrated; the rollback is on the rebalance books."""
    runs = {}
    for pkg, make, tel in (("ref", _ref, REF_TELEMETRY),
                           ("port", lambda: _port(tmp_path), TELEMETRY)):
        clean = make()
        _before_migration(clean, pkg)
        clean.promote()
        clean.run(_stream(pkg)[3:])
        coord = make()
        key, committed, dst = _before_migration(coord, pkg)
        src = coord.leader.plan.assignments[key]
        real, calls = coord.leader.process_chain, []

        def dies(topic, part, slab, real=real, calls=calls):
            calls.append(1)
            if len(calls) >= fail_at:
                raise RuntimeError("new group is lava")
            return real(topic, part, slab)

        coord.leader.process_chain = dies
        moves0 = tel.rebalance_families()[0].get("rollback", 0)
        res = coord.migrate_partition(0, dst, reason="lag")
        del coord.leader.process_chain
        assert res["ok"] is False and res["moved"] is False and "lava" in res["error"]
        assert res["replayed"] == fail_at - 1
        assert coord.migrations_failed == 1 and coord.migrations == 0
        assert coord.leader.plan.assignments[key] == src
        now = coord.leader.offsets.committed(key)
        assert now == committed + sum(len(v) for v in EXTRA[:fail_at - 1])
        assert len(coord.logs[key].unacked(now)) == len(EXTRA) - (fail_at - 1)
        assert tel.rebalance_families()[0].get("rollback", 0) == moves0 + 1
        served = len(coord.served_values(0))
        coord.promote()  # replays only what is still un-acked
        assert len(coord.served_values(0)) == served + sum(
            len(v) for v in EXTRA[fail_at - 1:])
        coord.run(_stream(pkg)[3:])
        assert _state(coord) == _state(clean)
        runs[pkg] = (_state(coord), _doc(res))
    assert runs["port"] == runs["ref"]


def test_migration_onto_its_own_group_is_a_noop(tmp_path):
    docs = []
    for pkg, coord in (("ref", _ref()), ("port", _port(tmp_path))):
        coord.run(_stream(pkg)[:2])
        src = coord.leader.plan.assignments["t/0"]
        res = coord.migrate_partition(0, src)
        assert res["ok"] and not res["moved"] and res["replayed"] == 0
        assert coord.migrations == 0
        docs.append(_doc(res))
    assert docs[0] == docs[1]


def test_migrate_partition_is_the_rebalancers_mover(tmp_path):
    """`FailoverCoordinator.migrate_partition` as the rebalancer's
    dict-returning mover: the same decisions and move documents as the
    JAX rebalancer over the JAX coordinator, and the moved partition's
    un-acked suffix replayed exactly once."""
    runs = {}
    for pkg, make, reb_cls, cfg_cls in (
            ("ref", _ref, ref_rebalancer.PartitionRebalancer, ref_rebalancer.RebalanceConfig),
            ("port", lambda: _port(tmp_path), PartitionRebalancer, RebalanceConfig)):
        coord = make()
        _before_migration(coord, pkg)
        clock = [0.0]
        lags = {"t/0": 10.0, "t/1": 0.0}
        reb = reb_cls(lambda c=coord: c.leader.plan,
                      lambda key, group, reason, c=coord: c.migrate_partition(
                          int(key.rsplit("/", 1)[1]), group, reason=reason),
                      config=cfg_cls(interval_s=0.0, burn=1.0, cooldown_s=0.0, max_moves=1,
                                     hysteresis=4.0),
                      clock=lambda: clock[0], lag_reader=lambda: dict(lags))
        reb.tick()
        clock[0] += 1.0
        moves = reb.tick()
        coord.run(_stream(pkg)[3:])
        runs[pkg] = ([_doc(m) for m in moves], reb.moves_total, reb.rollbacks, _state(coord),
                     coord.leader.plan.assignments)
        assert len(moves) == 1 and moves[0]["moved"] and moves[0]["replayed"] == len(EXTRA)
    assert runs["port"] == runs["ref"]


# ---------------------------------------------------------------------------
# the replicated state carried across from the JAX package
# ---------------------------------------------------------------------------

def test_promotion_from_the_reference_replica(tmp_path):
    """A port coordinator promoted from the JAX coordinator's replicated
    snapshots (`interop.carry_state_from_reference`) goes on equal to it."""
    ref = _ref()
    ref.run(_stream("ref")[:3])
    port = _port(tmp_path)
    base = {0: 0, 1: 0}
    for p, vals in STREAM[:3]:
        key = partition_key("t", p)
        port.logs.setdefault(key, partition.failover._PartitionLog()).append(
            base[p], base[p] + len(vals), _slab("port", vals))
        base[p] += len(vals)
    for key in sorted(ref.replica.snapshot()):
        committed, carries, inst = interop.carry_state_from_reference(
            ref.replica.latest(key), port.leader._chain)
        port.replica.publish(key, committed, carries, inst_state=inst)
        port.leader.offsets.advance(key, committed)
    port.promote()
    assert port.served == {}  # nothing was un-acked: the promotion only seeded
    ref.run(_stream("ref")[3:])
    port.run(_stream("port")[3:])
    for p in (0, 1):
        assert port.final_carries(p) == ref.final_carries(p)
        tail = port.served_values(p)
        assert tail == ref.served_values(p)[-len(tail):]
    assert port.leader.offsets.snapshot() == ref.leader.offsets.snapshot()


def test_carry_state_from_reference_builds_a_segment_snapshot():
    chain = chain_from_spec(CHAIN_SPEC, device="cpu")
    assert interop.carry_state_from_reference((-1, None, None), chain) == (-1, None, None)
    assert interop.carry_state_from_reference((7, [[42, 0, True]], None), chain) == (
        7, [(42, 0, True)], None)
    got = interop.carry_state_from_reference(
        (7, [(42, 0, True)], [(b"0", None), (b"42", None)]), chain)
    assert got == (7, [(42, 0, True)], [(None, [(42, 0, True)])])
    mixed = hook_chain([("aggregate-field", {"field": "n", "combine": "add"}),
                        (HOOK_SUM_SM, {})], "cpu")
    got = interop.carry_state_from_reference(
        (3, [(5, 0, True)], [(b"5", None), (b"17", None)]), mixed)
    assert got == (3, [(5, 0, True)], [(None, [(5, 0, True)]), b"17"])
    with pytest.raises(ValueError):
        interop.carry_state_from_reference((3, [(5, 0, True), (1, 0, True)], [(b"5", None)]),
                                           chain)


# ---------------------------------------------------------------------------
# the broker's partition gate
# ---------------------------------------------------------------------------

def test_gate_rejects_out_of_range_pinned_group():
    """A rule pinning a group past the groups fails when the gate is built
    (the server's start logs it), never on the first slice of some topic."""
    with pytest.raises(ValueError):
        ref_runtime.BrokerPartitionGate(2, rules=ref_placement.parse_placement_rules(
            "orders/.*=5"))
    with pytest.raises(ValueError):
        BrokerPartitionGate(2, rules=parse_placement_rules("orders/.*=5"), devices=["cpu"])


def test_gate_places_like_the_reference():
    ref_gate = ref_runtime.BrokerPartitionGate(
        3, rules=ref_placement.parse_placement_rules("orders/.*=1;.*=spread"),
        devices=jax.devices()[:1])
    gate = BrokerPartitionGate(3, rules=parse_placement_rules("orders/.*=1;.*=spread"),
                               devices=["cpu"])
    for g in (ref_gate, gate):
        for topic, p in (("orders", 0), ("logs", 0), ("logs", 1), ("orders", 3), ("t", 2)):
            g.group_for(topic, p)
        assert g.move_partition("logs", 0, 2) is True
        assert g.move_partition("logs", 0, 2) is False
        g.fail_group(1)
    assert gate.plan.to_dict() == ref_gate.plan.to_dict()
    assert {gate.device_of(g) for g in range(3)} == {torch.device("cpu")}


def _shallow_batches(pkg: str, values):
    if pkg == "ref":
        from fluvio_tpu.protocol.codec import ByteReader, ByteWriter
        from fluvio_tpu.protocol.record import Batch, Record
    else:
        from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter
        from fluvio_tpu_torch.protocol.record import Batch, Record
    w = ByteWriter()
    Batch.from_records(
        [Record(value=json.dumps({"n": v, "name": f"fluvio-{v}"}).encode()) for v in values],
        base_offset=0, first_timestamp=5000).encode(w)
    return [Batch.decode(ByteReader(w.bytes()), parse_records=False)]


def _wire(pkg: str, result) -> list:
    if pkg == "ref":
        from fluvio_tpu.protocol.codec import ByteWriter
    else:
        from fluvio_tpu_torch.protocol.codec import ByteWriter
    out = []
    for b in result.records.batches:
        w = ByteWriter()
        b.encode(w)
        out.append(w.bytes())
    return out


def test_broker_seam_placement_error_declines_typed():
    """A gate whose rules match no rule for the slice's topic: the dispatch
    and the finish each book ``partition-placement-error`` (two a slice,
    no per-batch fallback), and the slice still serves on the card; a topic
    the rules match places as ``sig@orders/1``. Both packages alike."""
    from fluvio_tpu.smartengine.metrics import SmartModuleChainMetrics as RefMetrics
    from fluvio_tpu.spu import smart_chain as ref_sc
    from fluvio_tpu_torch.smartengine.metrics import SmartModuleChainMetrics
    from fluvio_tpu_torch.spu import smart_chain as sc

    ref_partition.set_gate(ref_runtime.BrokerPartitionGate(
        2, rules=ref_placement.parse_placement_rules("orders/.*=0"),
        devices=jax.devices()[:1]))
    partition.set_gate(BrokerPartitionGate(2, rules=parse_placement_rules("orders/.*=0"),
                                           devices=["cpu"]))
    ref_chain = ref_failover.chain_from_spec(FILTER_SPEC, backend="tpu")
    chain = chain_from_spec(FILTER_SPEC, device="cpu")
    sides = (("ref", ref_chain, REF_TELEMETRY, RefMetrics(), ref_sc.tpu_stage_dispatch,
              ref_sc.tpu_finish, ref_chain.tpu_chain),
             ("port", chain, TELEMETRY, SmartModuleChainMetrics(), sc.gpu_stage_dispatch,
              sc.gpu_finish, chain.gpu_chain))
    wires = {}
    for pkg, ch, tel, metrics, dispatch, finish, ex in sides:
        d0 = tel.declines.get("partition-placement-error", 0)
        pending = dispatch(ch, _shallow_batches(pkg, (1, 2, 3)), metrics, topic="logs",
                           partition=0)
        assert pending is not None, "the slice must still serve"
        result = finish(ch, pending, 1 << 20, metrics, topic="logs", partition=0)
        assert result is not None and result.error is None
        assert tel.declines.get("partition-placement-error", 0) - d0 == 2
        assert metrics.fallback_slices == 0 and metrics.fastpath_slices == 1
        assert ex.span_chain is None and ex.partition_tag is None  # scope left
        pending = dispatch(ch, _shallow_batches(pkg, (4, 5)), metrics, topic="orders",
                           partition=1)
        placed = finish(ch, pending, 1 << 20, metrics, topic="orders", partition=1)
        assert placed.error is None and metrics.fallback_slices == 0
        assert f"{ex._chain_sig}@orders/1" in tel.chain_hist_copies()
        wires[pkg] = _wire(pkg, result) + _wire(pkg, placed)
    assert wires["port"] == wires["ref"]


def test_an_unarmed_gate_enters_no_scope():
    from fluvio_tpu_torch.spu import smart_chain as sc

    chain = chain_from_spec(FILTER_SPEC, device="cpu")
    assert partition.gate() is None
    assert sc._enter_partition_scope("t", 0, chain.gpu_chain) is None
    partition.set_gate(BrokerPartitionGate(2, rules=parse_placement_rules(".*=spread"),
                                           devices=["cpu"]))
    assert sc._enter_partition_scope("t", None, chain.gpu_chain) is None
    scope = sc._enter_partition_scope("t", 3, chain.gpu_chain)
    try:
        assert chain.gpu_chain.span_chain == f"{chain.gpu_chain._chain_sig}@t/3"
    finally:
        scope.__exit__(None, None, None)
    assert chain.gpu_chain.span_chain is None


def test_gate_resolves_from_config_never_the_environment(monkeypatch, caplog):
    """The port's gate comes from `partition.configure` (an SPU's
    ``SpuConfig.partitions``), built there; the reference's
    ``FLUVIO_PARTITIONS`` arms the JAX gate only. A rule set that fails
    validation is logged and leaves the gate unarmed, in both packages."""
    monkeypatch.setenv("FLUVIO_PARTITIONS", "2")
    ref_partition.reset_gate()
    assert isinstance(ref_partition.gate(), ref_runtime.BrokerPartitionGate)
    partition.set_gate(None)
    assert partition.gate() is None
    armed = partition.configure(PartitionGateConfig(groups=2, rules=".*=spread"),
                                devices=["cpu"])
    assert isinstance(armed, BrokerPartitionGate) and partition.gate() is armed
    assert armed.plan.n_groups == 2 and armed.plan.rules == parse_placement_rules(".*=spread")
    partition.configure(PartitionGateConfig(groups=0, rules=".*=spread"), devices=["cpu"])
    assert partition.gate() is None
    monkeypatch.setenv("FLUVIO_PARTITION_RULES", "orders/.*=5")
    ref_partition.reset_gate()
    with caplog.at_level(logging.ERROR):
        partition.configure(PartitionGateConfig(groups=2, rules="orders/.*=5"),
                            devices=["cpu"])
        assert partition.gate() is None
        assert ref_partition.gate() is None
    assert sum("partition gate unavailable" in r.getMessage() for r in caplog.records) == 2


def test_server_start_resolves_the_gate(tmp_path, caplog):
    """`SpuServer` builds the gate from ``SpuConfig.partitions`` (folded
    onto its engine's device) before it serves, and disarms it when it
    stops; a bad rule set is logged and the server serves unarmed; a
    server with no ``partitions`` leaves the process's gate alone."""
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.server import SpuServer
    from fluvio_tpu_torch.storage.config import ReplicaConfig

    async def start(cfg):
        config = SpuConfig(public_addr="127.0.0.1:0", private_addr="",
                           log_base_dir=str(tmp_path), cleaner_interval_seconds=0,
                           replication=ReplicaConfig(base_dir=str(tmp_path)), partitions=cfg)
        config.smart_engine.device = "cpu"
        server = SpuServer(config)
        await server.start()
        gate = partition.gate()
        await server.stop()
        return gate, partition.gate()

    gate, after = asyncio.run(start(PartitionGateConfig(groups=2, rules=".*=spread")))
    assert isinstance(gate, BrokerPartitionGate) and after is None
    assert gate.device_of(0) == gate.device_of(1) == torch.device("cpu")
    with caplog.at_level(logging.ERROR):
        assert asyncio.run(start(PartitionGateConfig(groups=2, rules="orders/.*=5"))) == (
            None, None)
    assert any("partition gate unavailable" in r.getMessage() for r in caplog.records)
    # None leaves the process's gate as it is, through start and stop
    partition.set_gate(gate)
    assert asyncio.run(start(None)) == (gate, gate)


# ---------------------------------------------------------------------------
# the slice: a 4-partition topic behind each package's SPU, the gate armed
# ---------------------------------------------------------------------------

PARTS = 4
PER_PART = 384
BATCH = 96


def test_spu_consumes_every_partition_through_the_armed_gate(tmp_path, monkeypatch):
    """A 4-partition topic (``gen_json``, stored batches of 96) behind the
    port's `SpuServer` with ``SpuConfig.partitions`` (2 groups,
    ``.*=spread``) and behind the JAX SPU with its gate armed by its
    environment: each partition consumed through ``3_aggregate`` and
    ``flu[vV]io`` pushes the same wire batches, every last sum is the
    partition's truth, and the port's histograms hold ``chain@bench/p`` for
    every partition."""
    from fluvio_tpu.client import ConsumerConfig as RefConsumerConfig
    from fluvio_tpu.client import Fluvio as RefFluvio
    from fluvio_tpu.client import Offset as RefOffset
    from fluvio_tpu.protocol import codec as ref_codec
    from fluvio_tpu.spu import SpuConfig as RefSpuConfig
    from fluvio_tpu.spu import SpuServer as RefSpuServer
    from fluvio_tpu.storage.config import ReplicaConfig as RefReplicaConfig
    from fluvio_tpu_torch.client import Fluvio, Offset
    from fluvio_tpu_torch.protocol import codec
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.server import SpuServer
    from fluvio_tpu_torch.storage.config import ReplicaConfig
    from fluvio_tpu_torch.protocol.record import RecordSet
    from tests.test_torch_isolation import broker_log, server_consumer_config, server_invocations
    from tests.test_torch_server import _port_batches, _ref_invocations, _write_ref

    monkeypatch.setenv("FLUVIO_PARTITIONS", "2")
    monkeypatch.setenv("FLUVIO_PARTITION_RULES", ".*=spread")
    ref_partition.reset_gate()
    values = gen_json(PARTS * PER_PART, seed=91)
    per_part = [values[p::PARTS] for p in range(PARTS)]
    wires = [broker_log(v, BATCH)[0] for v in per_part]
    chains = {"3_aggregate": server_invocations("3_aggregate"),
              "flu_regex_filter": server_invocations("flu_regex_filter")}

    async def consume(addr, invocations, p, port: bool):
        if port:
            client = await Fluvio.connect(addr)
            cfg, start = server_consumer_config(invocations, 1 << 20), Offset.beginning()
            writer = codec.ByteWriter
        else:
            client = await RefFluvio.connect(addr)
            cfg = RefConsumerConfig(disable_continuous=True, max_bytes=1 << 20,
                                    smartmodules=_ref_invocations(invocations))
            start, writer = RefOffset.beginning(), ref_codec.ByteWriter
        try:
            consumer = await client.partition_consumer("bench", p)
            out = []
            async for b in consumer.stream_batches(start, cfg):
                w = writer()
                b.encode(w)
                out.append((w.bytes(), [r.value for r in b.memory_records()]))
            return out
        finally:
            await client.close()

    async def main():
        ref_cfg = RefSpuConfig(public_addr="127.0.0.1:0", private_addr="",
                               log_base_dir=str(tmp_path / "ref"), cleaner_interval_seconds=0,
                               replication=RefReplicaConfig(base_dir=str(tmp_path / "ref")))
        ref_cfg.smart_engine.backend = "tpu"
        ref = RefSpuServer(ref_cfg)
        cfg = SpuConfig(public_addr="127.0.0.1:0", private_addr="",
                        log_base_dir=str(tmp_path / "port"), cleaner_interval_seconds=0,
                        replication=ReplicaConfig(base_dir=str(tmp_path / "port")),
                        partitions=PartitionGateConfig(groups=2, rules=".*=spread"))
        cfg.smart_engine.device = "cpu"
        port = SpuServer(cfg)
        await ref.start()
        await port.start()
        assert isinstance(partition.gate(), BrokerPartitionGate)
        try:
            for p in range(PARTS):
                await _write_ref(ref.ctx.create_replica("bench", p), wires[p])
                leader = port.ctx.create_replica("bench", p)
                for b in _port_batches(wires[p]):
                    rs = RecordSet()
                    rs.add(b)
                    await leader.write_record_set(rs)
            got = {}
            for name, invocations in chains.items():
                for p in range(PARTS):
                    want = await consume(ref.public_addr, invocations, p, port=False)
                    mine = await consume(port.public_addr, invocations, p, port=True)
                    assert [w for w, _ in mine] == [w for w, _ in want], (name, p)
                    got[name, p] = [v for _, vals in mine for v in vals]
            return got
        finally:
            await port.stop()
            await ref.stop()

    got = asyncio.run(asyncio.wait_for(main(), timeout=120))
    for p in range(PARTS):
        assert int(got["3_aggregate", p][-1]) == sum(json.loads(v)["n"] for v in per_part[p])
        assert got["flu_regex_filter", p] == [v for v in per_part[p]
                                              if b"fluvio" in v or b"fluVio" in v]
    # each partition's slices placed under both chains' identities
    placed = Counter(k.rsplit("@", 1)[1] for k in TELEMETRY.chain_hist_copies() if "@" in k)
    assert {f"bench/{p}": 2 for p in range(PARTS)}.items() <= placed.items()
    assert partition.gate() is None  # the server disarmed its gate on stop
