"""Partitioned-topic execution: the port's ``fluvio_tpu_torch.partition``
(on the CPU) against the JAX package's ``fluvio_tpu.partition`` (JAX on the
CPU), driving the same sequences on inputs made from a seed; tolerance 0.

Placement plans (``to_dict()``), the device fold's shape, runtime carries
(``carry_snapshot``), outputs, offsets and the rebalancer's moves and
status must be equal. The runtimes share one chain spec per test; batches
keep fixed sizes, so JAX compiles each chain once.
"""

from __future__ import annotations

import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from fluvio_tpu.parallel.mesh import make_grouped_mesh
from fluvio_tpu.partition import failover as ref_failover
from fluvio_tpu.partition import placement as ref_placement
from fluvio_tpu.partition import rebalancer as ref_rebalancer
from fluvio_tpu.partition import runtime as ref_runtime
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.partition import (
    CarryReplica,
    PartitionOffsets,
    PartitionRebalancer,
    PartitionRuntime,
    PlacementRule,
    RebalanceConfig,
    device_for_group,
    make_partition_fold,
    match_placement,
    parse_placement_rules,
    partition_key,
    plan_placement,
    validate_rules,
)
from fluvio_tpu_torch.partition import failover, placement, rebalancer
from fluvio_tpu_torch.smartengine import EngineError
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.windows import PartitionedWindowRuntime, WindowSpec
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_chain import _assert_equal, _chains, _port_buffer, _ref_buffer
from tests.test_torch_isolation import (
    _Leader,
    gen_arrays,
    gen_ints,
    gen_json,
    partitioned_truth,
    run_partitioned,
)
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

SPECS = [("regex-filter", {"regex": "fluvio"}),
         ("aggregate-field", {"field": "n", "combine": "add"})]  # 9_partitioned's chain
FILTER = [("regex-filter", {"regex": "fluvio"})]
BATCH = 48  # records a batch: one JAX row bucket (64)
CPU = [torch.device("cpu")]


def _ref_runtime(ex, plan):
    """The JAX runtime with every group folded onto one CPU device, as the
    port's groups fold onto its one device (one compile per chain)."""
    return ref_runtime.PartitionRuntime(ex, plan, devices=jax.devices()[:1])


def _port_chain(specs):
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig

    b = SmartEngine(device="cpu").builder()
    for name, params in specs:
        b.add_smart_module(SmartModuleConfig(params=dict(params)), lookup(name))
    return b.initialize().gpu_chain


def _batch(seed: int, n: int = BATCH):
    """(JAX buffer, port buffer) of ``n`` bench JSON records."""
    ref = _ref_buffer(gen_json(n, seed=seed))
    return ref, _port_buffer(ref)


def _runtimes(specs=SPECS, n_groups=2, rules=".*=spread", keys=()):
    """(JAX runtime, port runtime on the CPU) over fresh chains of ``specs``."""
    ref_ex, port_ex = _chains(specs)
    ref_plan = ref_placement.plan_placement(ref_placement.parse_placement_rules(rules), keys,
                                            n_groups)
    port_plan = plan_placement(parse_placement_rules(rules), keys, n_groups)
    return _ref_runtime(ref_ex, ref_plan), PartitionRuntime(port_ex, port_plan, devices=CPU)


def _assert_same_state(ref_rt, port_rt, parts, topic="t"):
    for p in parts:
        assert port_rt.carry_snapshot(topic, p) == ref_rt.carry_snapshot(topic, p), p
    ref_doc, port_doc = ref_rt.to_dict(), port_rt.to_dict()
    for k in ("plan", "partitions", "offsets"):
        assert port_doc[k] == ref_doc[k], k
    assert set(port_doc["mesh"]["axes"]) == set(ref_doc["mesh"]["axes"])


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — both sides must raise the same type
        return "raise", type(e).__name__


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

RULE_SPECS = (None, ".*=spread", ".*=hash", "orders/.*=1;.*=spread", "logs/.*=spread;t/[0-3]=0;.*=hash")
KEY_SETS = (
    [f"t/{i}" for i in range(6)],
    ["orders/0", "orders/1", "logs/0", "logs/7", "t/9"],
    [f"topic-{c}/{i}" for c in "ab" for i in range(5)],
)


def _plan_sequence(api, spec, keys, n_groups):
    """Every plan primitive in turn; each step's ``to_dict()`` or the type
    it raised."""
    rules = api.parse_placement_rules(spec)
    out = [_outcome(lambda: api.validate_rules(rules, n_groups))]
    got = _outcome(lambda: api.plan_placement(rules, keys[:3], n_groups))
    out.append(got if got[0] == "raise" else ("ok", got[1].to_dict()))
    if got[0] == "raise":
        return out
    plan = got[1].with_partitions(keys + keys[:2])
    out.append(("ok", plan.to_dict()))
    out.append(("ok", [api.match_placement(rules, k, n_groups, plan.loads()) for k in keys]))
    first = sorted(plan.assignments)[0]
    for step in (
        lambda p: p.move_partition(first, (p.assignments[first] + 1) % n_groups),
        lambda p: p.move_partition(first, p.assignments[first]),
        lambda p: p.move_partition("nope/0", 0),
        lambda p: p.split_group(0, n_groups - 1),
        lambda p: p.merge_groups(n_groups - 1, 0),
        lambda p: p.rebalance(0),
        lambda p: p.with_partitions(["late/0", "late/1"]),
        lambda p: p.move_partition(first, 0),
        lambda p: p.rebalance(n_groups - 1),
    ):
        got = _outcome(lambda: step(plan))
        if got[0] == "ok":
            plan = got[1]
            got = ("ok", plan.to_dict(), plan.rows(), plan.live_groups())
        out.append(got)
    return out


@pytest.mark.parametrize("n_groups", (1, 2, 3, 4))
@pytest.mark.parametrize("keys", KEY_SETS, ids=("t", "orders-logs", "two-topics"))
@pytest.mark.parametrize("spec", RULE_SPECS)
def test_placement_plans_equal_the_reference(spec, keys, n_groups):
    ref = _plan_sequence(ref_placement, spec, keys, n_groups)
    port = _plan_sequence(placement, spec, keys, n_groups)
    assert port == ref


@pytest.mark.parametrize("spec", ("no-equals-here", "t/.*=bogus-word", "[unclosed=0", "a/.*=1;b",
                                  "x=1.5"))
def test_malformed_rule_grammar_raises_on_both_sides(spec):
    assert _outcome(lambda: parse_placement_rules(spec)) == _outcome(
        lambda: ref_placement.parse_placement_rules(spec))
    assert _outcome(lambda: parse_placement_rules(spec))[0] == "raise"


def test_rules_and_partition_key():
    assert parse_placement_rules("orders/.*=0; logs/[0-3]=spread ;.*=hash") == (
        PlacementRule("orders/.*", 0), PlacementRule("logs/[0-3]", "spread"),
        PlacementRule(".*", "hash"))
    assert partition_key("t", 3) == ref_placement.partition_key("t", 3) == "t/3"
    with pytest.raises(ValueError):
        validate_rules((PlacementRule(".*", 2),), 2)
    with pytest.raises(ValueError):
        match_placement((PlacementRule("^only$", 0),), "t/0", 2)


# ---------------------------------------------------------------------------
# the device fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", range(1, 9))
def test_fold_follows_the_grouped_mesh_rule(n_devices):
    """Over 1-8 stand-in devices, every (groups, group size): the fold's
    rows are the grouped mesh's (by device position), the lead device of
    each group is the mesh's, and the same calls raise."""
    jax_devs = jax.devices()[:n_devices]
    assert len(jax_devs) == n_devices
    stand_ins = [torch.device("cuda", i) for i in range(n_devices)]
    for n_groups in (0, 1, 2, 3, 5, 8, 100):
        for group_size in (None, 1, 2, 3, 9):
            ref = _outcome(lambda: make_grouped_mesh(n_groups, group_size, devices=jax_devs))
            port = _outcome(lambda: make_partition_fold(n_groups, group_size, devices=stand_ins))
            assert port[0] == ref[0], (n_groups, group_size)
            if ref[0] == "raise":
                assert port[1] == ref[1]
                continue
            rows = [[jax_devs.index(d) for d in row] for row in np.asarray(ref[1].devices)]
            assert [[d.index for d in row] for row in port[1]] == rows
            for g in range(12):
                lead = ref_placement.device_for_group(ref[1], g)
                assert device_for_group(port[1], g).index == jax_devs.index(lead)


def test_fold_shape_matches_the_partition_mesh():
    ref = ref_placement.make_partition_mesh(2)  # every JAX CPU device
    fold = make_partition_fold(2, devices=[torch.device("cuda", i) for i in range(len(jax.devices()))])
    assert placement.fold_shape(fold) == dict(zip(ref.axis_names, ref.devices.shape))


def test_runtime_devices_follow_the_device_rule(monkeypatch):
    """No CUDA and no devices given: the runtime raises, never drifts to
    the CPU; a fold over two distinct devices, or over another device
    than the executor's, raises ValueError."""
    port_ex = _port_chain(FILTER)
    plan = plan_placement(parse_placement_rules(".*=spread"), [], 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError):
        PartitionRuntime(port_ex, plan)
    with pytest.raises(ValueError, match="item 6"):
        PartitionRuntime(port_ex, plan, devices=["cpu", "cuda:1"])
    with pytest.raises(ValueError):
        PartitionRuntime(port_ex, plan, devices=["cuda:0"])
    rt = PartitionRuntime(port_ex, plan, devices=["cpu", "cpu"])  # two groups, one device
    assert rt.device_of(0) == rt.device_of(1) == torch.device("cpu")
    assert rt.to_dict()["mesh"] == {"axes": {"partitions": 2, "records": 1}}


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def test_interleaved_partitions_keep_their_own_carries():
    ref_rt, port_rt = _runtimes()
    for k, p in enumerate((0, 1, 0, 2, 1, 0)):
        ref_buf, port_buf = _batch(k)
        _assert_equal(ref_rt.process("t", p, ref_buf), port_rt.process("t", p, port_buf))
    _assert_same_state(ref_rt, port_rt, (0, 1, 2))
    assert port_rt.carry_snapshot("t", 0)[0][0] == sum(
        partitioned_truth(gen_json(BATCH, seed=k)) for k in (0, 2, 5))
    ex = port_rt._executor
    assert (ex.span_chain, ex.partition_tag) == (None, None)
    prev = ex.set_partition_identity("t/1", 1)
    assert (ex.span_chain, ex.partition_tag) == ("filter+aggregate@t/1", "t/1:g1")
    ex.restore_partition_identity(prev)
    assert ex._chain_sig == ref_rt._executor._chain_sig


@pytest.mark.parametrize("specs", (SPECS, FILTER), ids=("filter-aggregate", "filter"))
@pytest.mark.parametrize("depth", (0, 2))
def test_process_interleaved_outputs_equal(specs, depth):
    ref_rt, port_rt = _runtimes(specs)
    parts = (0, 1, 2, 1, 0, 3, 3, 2)
    batches = [_batch(k) for k in range(len(parts))]
    ref_out = list(ref_rt.process_interleaved(
        [("t", p, b[0]) for p, b in zip(parts, batches)], depth=depth))
    port_out = list(port_rt.process_interleaved(
        [("t", p, b[1]) for p, b in zip(parts, batches)], depth=depth))
    assert [(t, p) for t, p, _, _ in port_out] == [(t, p) for t, p, _, _ in ref_out]
    for r, q in zip(ref_out, port_out):
        _assert_equal(r[3], q[3])
    _assert_same_state(ref_rt, port_rt, (0, 1, 2, 3))


def test_fail_group_and_move_partition_stay_exact():
    ref_rt, port_rt = _runtimes()
    for k, p in enumerate((0, 1, 2, 3)):
        ref_buf, port_buf = _batch(k)
        _assert_equal(ref_rt.process("t", p, ref_buf), port_rt.process("t", p, port_buf))
    assert port_rt.move_partition("t", 0, 1) == ref_rt.move_partition("t", 0, 1) is True
    assert port_rt.move_partition("t", 0, 1) == ref_rt.move_partition("t", 0, 1) is False
    assert port_rt.move_partition("t", 9, 0) == ref_rt.move_partition("t", 9, 0)
    _assert_same_state(ref_rt, port_rt, (0, 1, 2, 3, 9))
    assert port_rt.fail_group(1) == ref_rt.fail_group(1)
    assert port_rt.rebalances == ref_rt.rebalances == 1
    assert port_rt.moves == ref_rt.moves
    for k, p in enumerate((0, 1, 2, 3, 9), start=4):
        ref_buf, port_buf = _batch(k)
        _assert_equal(ref_rt.process("t", p, ref_buf), port_rt.process("t", p, port_buf))
    _assert_same_state(ref_rt, port_rt, (0, 1, 2, 3, 9))
    assert port_rt.partitions() == ref_rt.partitions()
    assert set(port_rt.plan.assignments.values()) == {0}
    assert port_rt.carry_snapshot("t", 9)[0][0] == partitioned_truth(gen_json(BATCH, seed=8))


def test_warmed_executor_seeds_partitions_from_the_spec():
    ref_ex, port_ex = _chains(SPECS)
    ref_buf, port_buf = _batch(40)
    ref_ex.process_buffer(ref_buf)
    port_ex.process_buffer(port_buf)
    plan = plan_placement(parse_placement_rules(".*=spread"), [], 2)
    port_rt = PartitionRuntime(port_ex, plan, devices=CPU)
    ref_rt = _ref_runtime(ref_ex, ref_placement.plan_placement(
        ref_placement.parse_placement_rules(".*=spread"), [], 2))
    ref_buf, port_buf = _batch(41)
    _assert_equal(ref_rt.process("t", 0, ref_buf), port_rt.process("t", 0, port_buf))
    _assert_same_state(ref_rt, port_rt, (0,))
    assert port_rt.carry_snapshot("t", 0)[0][0] == partitioned_truth(gen_json(BATCH, seed=41))
    # the warmed executor's own carries are where the runtime found them
    port_ex._ensure_host_state()
    assert port_ex.carries[0][0] == partitioned_truth(gen_json(BATCH, seed=40))


def _explode_batch(k: int):
    docs = [json.dumps([{"n": k * 10 + j}, {"n": j}]).encode() for j in range(8)]
    ref = _ref_buffer(docs)
    return ref, _port_buffer(ref)


def test_fanout_aggregate_interleave_runs_one_batch_at_a_time():
    specs = [("array-map-json", {}), ("aggregate-field", {"field": "n", "combine": "add"})]
    ref_rt, port_rt = _runtimes(specs)
    assert ref_rt._executor._fanout and port_rt._executor._fanout
    calls = {}
    for side, rt in (("ref", ref_rt), ("port", port_rt)):
        seen = calls[side] = []
        dispatch, finish = rt.dispatch, rt.finish

        def spy_dispatch(*a, seen=seen, fn=dispatch):
            seen.append("d")
            return fn(*a)

        def spy_finish(*a, seen=seen, fn=finish):
            seen.append("f")
            return fn(*a)

        rt.dispatch, rt.finish = spy_dispatch, spy_finish
    batches = [_explode_batch(k) for k in range(3)]
    ref_out = list(ref_rt.process_interleaved([("t", k % 2, b[0]) for k, b in enumerate(batches)]))
    port_out = list(port_rt.process_interleaved([("t", k % 2, b[1]) for k, b in enumerate(batches)]))
    assert calls["port"] == calls["ref"] == ["d", "f"] * 3
    for r, q in zip(ref_out, port_out):
        _assert_equal(r[3], q[3])
    _assert_same_state(ref_rt, port_rt, (0, 1))


def _failing_dispatch(rt, fail_at: int):
    """Make the runtime's executor raise on its ``fail_at``-th dispatch."""
    ex = rt._executor
    inner = ex.dispatch_buffer
    count = [0]

    def dispatch_buffer(buf):
        count[0] += 1
        if count[0] == fail_at:
            raise RuntimeError("injected dispatch failure")
        return inner(buf)

    ex.dispatch_buffer = dispatch_buffer


def test_failed_dispatch_mid_interleave_restores_every_partition():
    ref_rt, port_rt = _runtimes()
    for k, p in enumerate((0, 1, 2)):
        ref_buf, port_buf = _batch(k)
        ref_rt.process("t", p, ref_buf)
        port_rt.process("t", p, port_buf)
    before = [port_rt.carry_snapshot("t", p) for p in (0, 1, 2)]
    parts = (0, 1, 2, 0)
    batches = [_batch(10 + k) for k in range(len(parts))]
    for side, rt in ((0, ref_rt), (1, port_rt)):
        _failing_dispatch(rt, 3)
        with pytest.raises(RuntimeError, match="injected"):
            list(rt.process_interleaved([("t", p, b[side]) for p, b in zip(parts, batches)]))
    assert [port_rt.carry_snapshot("t", p) for p in (0, 1, 2)] == before
    _assert_same_state(ref_rt, port_rt, (0, 1, 2))


def test_two_in_flight_batches_of_one_partition_unwind_to_the_first():
    """A reference fault the port does not follow: with two batches of one
    partition in flight when a dispatch fails, the JAX runtime discards
    them oldest first, so the partition keeps the first batch's sums
    though neither batch was delivered; the port discards newest first
    and the partition is back where the batches found it."""
    ref_rt, port_rt = _runtimes()
    seed_buf = _batch(0)
    ref_rt.process("t", 0, seed_buf[0])
    port_rt.process("t", 0, seed_buf[1])
    before = port_rt.carry_snapshot("t", 0)
    batches = [_batch(20 + k) for k in range(3)]
    for side, rt in ((0, ref_rt), (1, port_rt)):
        _failing_dispatch(rt, 3)
        with pytest.raises(RuntimeError, match="injected"):
            list(rt.process_interleaved([("t", 0, b[side]) for b in batches]))
    assert port_rt.carry_snapshot("t", 0) == before
    first = partitioned_truth(gen_json(BATCH, seed=20))
    assert ref_rt.carry_snapshot("t", 0) == [(before[0][0] + first, 0, True)]


def test_port_continues_a_reference_runtime_mid_stream():
    """The JAX runtime runs, moves a partition and loses a group; its plan
    (`interop.placement_plan_from_reference`) and each partition's carry
    snapshot (`seed_partition`) start a port runtime, and both go on
    equal."""
    ref_ex, _ = _chains(SPECS)
    rules = ref_placement.parse_placement_rules("t/0=2;.*=spread")
    ref_rt = _ref_runtime(ref_ex, ref_placement.plan_placement(rules, [], 3))
    for k, p in enumerate((0, 1, 2, 3, 1)):
        ref_rt.process("t", p, _batch(k)[0])
    ref_rt.move_partition("t", 1, 2)
    ref_rt.fail_group(0)
    port_ex = _port_chain(SPECS)
    port_plan = interop.placement_plan_from_reference(
        ref_rt.plan.to_dict(), [(r.pattern, r.group) for r in ref_rt.plan.rules])
    assert port_plan.to_dict() == ref_rt.plan.to_dict()
    port_rt = PartitionRuntime(port_ex, port_plan, devices=CPU)
    for p in (0, 1, 2, 3):
        port_rt.seed_partition("t", p, ref_rt.carry_snapshot("t", p))
    for k, p in enumerate((3, 0, 4, 2, 1, 4), start=10):
        ref_buf, port_buf = _batch(k)
        _assert_equal(ref_rt.process("t", p, ref_buf), port_rt.process("t", p, port_buf))
    for p in (0, 1, 2, 3, 4):
        assert port_rt.carry_snapshot("t", p) == ref_rt.carry_snapshot("t", p)
    assert port_rt.plan.to_dict() == ref_rt.plan.to_dict()


# ---------------------------------------------------------------------------
# 9_partitioned at a small size
# ---------------------------------------------------------------------------

def test_9_partitioned_small():
    n, parts = 2048, 4
    values = gen_json(n)
    per_part = [values[p::parts] for p in range(parts)]
    bufs = []
    for v in per_part:
        ref = _ref_buffer(v)
        bufs.append((ref, _port_buffer(ref)))
    keys = [f"bench/{p}" for p in range(parts)]
    ref_rt, port_rt = _runtimes(keys=keys)
    ref = run_partitioned(ref_rt, [b[0] for b in bufs], ref_rebalancer.PartitionRebalancer,
                          ref_rebalancer.RebalanceConfig)
    port = run_partitioned(port_rt, [b[1] for b in bufs], PartitionRebalancer, RebalanceConfig)
    assert port["moves"] == ref["moves"] and len(port["moves"]) == 1
    assert port["moves"][0]["key"] == "bench/0" and port["moves"][0]["to"] == 1
    ref_outs, port_outs = ref["outs"], port["outs"]
    for r, q in zip(ref_outs, port_outs):
        _assert_equal(r, q)
    _assert_same_state(ref_rt, port_rt, range(parts), topic="bench")
    # the bench advances from committed() (-1 before the first commit), so
    # each partition ends one short of its leader's end offset
    assert port_rt.offsets.snapshot() == {k: 3 * len(per_part[0]) - 1 for k in keys}
    assert port["lags"] == ref["lags"] == [1] * parts
    assert port_rt.to_dict()["plan"] == {
        "n_groups": 2, "assignments": {k: 1 for k in keys}, "failed": [0],
        "rebalances": 1, "moves": 1}
    for p in range(parts):
        assert port_rt.carry_snapshot("bench", p) == [(4 * partitioned_truth(per_part[p]), 0, True)]


# ---------------------------------------------------------------------------
# offsets
# ---------------------------------------------------------------------------

def test_offsets_follow_the_reference():
    port, ref = PartitionOffsets(), ref_runtime.PartitionOffsets()
    leader = _Leader()
    for offs in (port, ref):
        assert offs.lag("t/0") is None
        offs.attach_leader("t/0", leader)
    steps = [("t/0", 5), ("t/0", 3), ("t/1", 0), ("t/0", 5), ("t/0", 9), ("t/1", -2)]
    for k, (key, off) in enumerate(steps):
        leader.end = 4 * k
        assert port.advance(key, off) == ref.advance(key, off), (key, off)
        for offs in (port, ref):
            assert offs.publisher(key).current_value() == offs.committed(key)
        assert port.lag("t/0") == ref.lag("t/0")
        assert port.committed(key) == ref.committed(key)
    assert port.snapshot() == ref.snapshot() == {"t/0": 9, "t/1": 0}
    assert port.leader("t/0") is leader


def test_offset_publisher_wakes_a_listener():
    port = PartitionOffsets()

    async def run():
        listener = port.publisher("t/0").change_listener()
        waiter = asyncio.ensure_future(listener.listen())
        await asyncio.sleep(0)
        assert not waiter.done()
        port.advance("t/0", 7)
        return await asyncio.wait_for(waiter, 5)

    assert asyncio.run(run()) == 7


# ---------------------------------------------------------------------------
# the rebalancer: tests/test_rebalancer.py's control-loop scenarios, both sides
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class _PlanBox:
    """A mutable plan with a recording mover (registers unknown keys
    through the plan's rules, as the runtime's mover does)."""

    def __init__(self, plan):
        self.plan = plan
        self.calls = []

    def mover(self, key, group, reason):
        self.calls.append((key, group, reason))
        if key not in self.plan.assignments:
            self.plan = self.plan.with_partitions([key])
        new = self.plan.move_partition(key, group)
        changed = new is not self.plan
        self.plan = new
        return changed


def _scenario(name: str, side):
    """Run one control-loop scenario on one side (``placement`` and
    ``rebalancer`` modules); returns everything the two sides must agree
    on."""
    pl, rb = side

    def plan(keys, n_groups=2, pin=None):
        rules = pl.parse_placement_rules(f".*={pin}") if pin is not None else ()
        return pl.plan_placement(rules, keys, n_groups)

    cfg = rb.RebalanceConfig(interval_s=0.0, burn=1.0, cooldown_s=5.0, max_moves=2,
                             hysteresis=4.0)
    clock = _Clock()
    lags = {}
    ticks = []
    box = mover = None

    def build(p, lag0, config=cfg, mover_fn=None):
        nonlocal box
        box = _PlanBox(p)
        lags.clear()
        lags.update(lag0)
        return rb.PartitionRebalancer(lambda: box.plan, mover_fn or box.mover, config=config,
                                      clock=clock, lag_reader=lambda: dict(lags))

    def step(reb, dt=1.0, **new_lags):
        lags.update(new_lags)
        ticks.append(reb.tick())
        clock.t += dt

    if name == "stalled-hot":
        reb = build(plan(["t/0", "t/1"], 3, pin=0), {"t/0": 50.0, "t/1": 1.0})
        step(reb)
        step(reb)
    elif name == "growing-vs-draining":
        reb = build(plan(["t/0"], 2, pin=0), {"t/0": 40.0})
        for lag in (40.0, 30.0, 45.0):
            step(reb, **{"t/0": lag})
    elif name == "hysteresis":
        reb = build(plan(["t/0"], 2, pin=0), {"t/0": 3.0})
        step(reb)
        step(reb)
    elif name == "nowhere-colder":
        reb = build(plan(["t/0", "t/1"], 2, pin=0).move_partition("t/1", 1),
                    {"t/0": 20.0, "t/1": 20.0})
        step(reb)
        step(reb)
    elif name == "move-budget":
        reb = build(plan([f"t/{i}" for i in range(4)], 4, pin=0),
                    {f"t/{i}": 100.0 for i in range(4)})
        step(reb)
        step(reb)
    elif name == "cooldown-flap":
        reb = build(plan(["t/0"], 2, pin=0), {"t/0": 100.0})
        for i in range(51):
            step(reb, 0.1, **{"t/0": 100.0 if i % 2 else 90.0})
    elif name == "held-from-birth":
        reb = build(plan(["t/0"], 2, pin=0), {"t/0": 10.0, "t/1": 50.0})
        step(reb)
        step(reb)
    elif name == "broken-mover":
        def boom(key, group, reason):
            raise RuntimeError("actuator on fire")

        reb = build(plan(["t/0"], 2, pin=0), {"t/0": 50.0},
                    config=rb.RebalanceConfig(cooldown_s=5.0), mover_fn=boom)
        step(reb)
        step(reb)
    elif name == "split":
        reb = build(plan([f"t/{i}" for i in range(4)], 2, pin=0),
                    {f"t/{i}": 100.0 for i in range(4)},
                    config=rb.RebalanceConfig(cooldown_s=0.0, max_moves=4, hysteresis=4.0))
        step(reb)
        step(reb)
    elif name == "explicit-split-merge":
        reb = build(plan([f"t/{i}" for i in range(4)], 2, pin=0), {})
        ticks.append(reb.split(0, 1))
        ticks.append(reb.merge(1, 0))
    elif name == "single-live-group":
        reb = build(plan(["t/0"], 1, pin=0), {"t/0": 100.0})
        step(reb)
        step(reb)
    elif name == "failed-group":
        reb = build(plan([f"t/{i}" for i in range(3)], 3, pin=0).rebalance(2),
                    {"t/0": 30.0, "t/1": 30.0, "t/2": 2.0})
        step(reb)
        step(reb, **{"t/0": 35.0})
        step(reb, 6.0, **{"t/1": 60.0})
    elif name == "daemon-run":
        stop = threading.Event()
        reads = [0]

        def reader():
            reads[0] += 1
            if reads[0] == 3:
                stop.set()
            return {"t/0": 50.0}

        reb = build(plan(["t/0"], 2, pin=0), {})
        reb._lag_reader = reader
        reb.run(stop, interval_s=0.0)
        ticks.append(reads[0])
    else:
        raise AssertionError(name)
    status = reb.status()
    for telemetry_field in ("moves", "migration_seconds"):
        status.pop(telemetry_field, None)
    return {"ticks": ticks, "calls": box.calls, "plan": box.plan.to_dict(),
            "moves_total": reb.moves_total, "rollbacks": reb.rollbacks, "status": status}


SCENARIOS = ("stalled-hot", "growing-vs-draining", "hysteresis", "nowhere-colder", "move-budget",
             "cooldown-flap", "held-from-birth", "broken-mover", "split", "explicit-split-merge",
             "single-live-group", "failed-group", "daemon-run")


@pytest.mark.parametrize("name", SCENARIOS)
def test_rebalancer_decisions_equal_the_reference(name):
    ref = _scenario(name, (ref_placement, ref_rebalancer))
    port = _scenario(name, (placement, rebalancer))
    assert port == ref
    expect_moves = {"stalled-hot": 1, "growing-vs-draining": 1, "move-budget": 2, "split": 2,
                    "explicit-split-merge": 4, "held-from-birth": 1}
    if name in expect_moves:
        assert port["moves_total"] == expect_moves[name]
    if name in ("hysteresis", "nowhere-colder", "single-live-group"):
        assert port["moves_total"] == 0
    if name == "cooldown-flap":
        assert 1 <= port["moves_total"] <= 2
    if name == "broken-mover":
        assert port["rollbacks"] == 1 and "actuator" in port["status"]["recent"][-1]["error"]
    if name == "split":
        assert {m["reason"] for t in port["ticks"] for m in t} <= set(rebalancer.MOVE_REASONS)


def test_rebalancer_defaults_and_partition_of():
    assert RebalanceConfig() == RebalanceConfig(**{
        k: getattr(ref_rebalancer.RebalanceConfig(), k)
        for k in ("interval_s", "burn", "cooldown_s", "max_moves", "hysteresis")})
    assert rebalancer.MOVE_REASONS == ref_rebalancer.MOVE_REASONS
    for key in ("sig123@t00.s0/0", "t00.s0/0", "a@b@c/1"):
        assert rebalancer.partition_of(key) == ref_rebalancer.partition_of(key)
    # no lag reader: each reads its telemetry registry's consumer-lag family
    from fluvio_tpu.telemetry import TELEMETRY as REF_TELEMETRY
    from fluvio_tpu_torch.telemetry import TELEMETRY

    for t in (REF_TELEMETRY, TELEMETRY):
        t.reset()
        t.set_consumer_lag("sig123@t00.s0/0", 7)
        t.set_consumer_lag("t00.s0/1", 2)
    try:
        port = PartitionRebalancer(lambda: None, lambda *a: True)
        ref = ref_rebalancer.PartitionRebalancer(lambda: None, lambda *a: True)
        assert port._lag_by_plan_key() == ref._lag_by_plan_key() == {
            "t00.s0/0": 7.0, "t00.s0/1": 2.0}
    finally:
        for t in (REF_TELEMETRY, TELEMETRY):
            t.reset()


# ---------------------------------------------------------------------------
# carry replication
# ---------------------------------------------------------------------------

class _ReplicaLeader:
    def __init__(self):
        self.published = []

    def publish_carry(self, offset, carries):
        self.published.append((offset, [tuple(c) for c in carries]))


def test_carry_replica_follows_the_reference():
    port, ref = CarryReplica(), ref_failover.CarryReplica()
    leaders = (_ReplicaLeader(), _ReplicaLeader())
    for rep, leader in zip((port, ref), leaders):
        assert rep.latest("t/0") == (-1, None, None)
        rep.bind_leader("t/0", leader)
        rep.publish("t/0", 10, [(5, 0, True)])
        rep.publish("t/1", 3, [[7, 100, False]], inst_state=[(b"7", None)])
        rep.publish("t/0", 20, [(9, 0, True)], inst_state=[])
    for key in ("t/0", "t/1", "t/2"):
        assert port.latest(key) == ref.latest(key)
    assert port.snapshot() == ref.snapshot() == {"t/0": 20, "t/1": 3}
    assert leaders[0].published == leaders[1].published
    log = failover._PartitionLog()
    log.append(0, 4, "slab")
    assert log.entries == [(0, 4, "slab")]


def _window_buffer(k: int, n: int = 64):
    buf = RecordBuffer.from_values(gen_ints(n, seed=k), base_timestamp=1_000_000 + 97 * n * k)
    buf.timestamp_deltas[:n] = np.arange(n) * 97
    return buf


def test_window_runtime_seeds_from_a_carry_replica():
    """`PartitionedWindowRuntime(replica=CarryReplica())`: a promoted
    runtime seeds from the replica at the committed offset, its bank equal
    to the leader's, and both go on equal."""
    spec = WindowSpec(window_ms=1000)
    replica = CarryReplica()
    leader = PartitionedWindowRuntime(spec, replica=replica, device="cpu")
    for k in range(3):
        leader.process_buffer("t", 0, _window_buffer(k))
    follower = PartitionedWindowRuntime(spec, replica=replica, device="cpu")
    assert follower.seed("t", 0) == 3 * 64 == replica.latest("window/t/0")[0]
    assert follower.snapshot("t", 0) == leader.snapshot("t", 0)
    a = leader.process_buffer("t", 0, _window_buffer(3))
    b = follower.process_buffer("t", 0, _window_buffer(3))
    assert (a.offset, a.watermark, a.ids.tolist(), a.accs.tolist()) == (
        b.offset, b.watermark, b.ids.tolist(), b.accs.tolist())
    assert follower.snapshot("t", 0) == leader.snapshot("t", 0)


def test_explode_chain_interleaves_without_an_aggregate():
    """A stateless explode chain pipelines (depth 2) and equals the
    reference's outputs."""
    ref_rt, port_rt = _runtimes([("array-map-json", {})])
    batches = []
    for k in range(4):
        ref = _ref_buffer(gen_arrays(32, seed=k))
        batches.append((ref, _port_buffer(ref)))
    ref_out = list(ref_rt.process_interleaved([("t", k % 2, b[0]) for k, b in enumerate(batches)]))
    port_out = list(port_rt.process_interleaved([("t", k % 2, b[1]) for k, b in enumerate(batches)]))
    for r, q in zip(ref_out, port_out):
        _assert_equal(r[3], q[3])
    _assert_same_state(ref_rt, port_rt, (0, 1))


def test_interleave_compresses_the_next_buffer_ahead():
    """With the up link on, each next buffer is compressed on the worker
    thread while the current one dispatches; outputs equal the link-off
    runtime's."""
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import LinkParams, SmartEngine, SmartModuleConfig

    outs = []
    for link in (LinkParams(), LinkParams(compress=True)):
        b = SmartEngine(device="cpu", link=link).builder()
        for name, params in SPECS:
            b.add_smart_module(SmartModuleConfig(params=dict(params)), lookup(name))
        ex = b.initialize().gpu_chain
        threads = []
        compressed = ex._compressed

        def spy(buf, fn=compressed, seen=threads):
            seen.append((id(buf), threading.current_thread().name))
            return fn(buf)

        ex._compressed = spy
        rt = PartitionRuntime(ex, plan_placement(parse_placement_rules(".*=spread"), [], 2),
                              devices=CPU)
        bufs = [RecordBuffer.from_values(gen_json(600, seed=k)) for k in range(4)]
        outs.append([(o.value_list(), rt.carry_snapshot(t, p))
                     for t, p, _, o in rt.process_interleaved([("t", k % 2, b)
                                                              for k, b in enumerate(bufs)])])
        if link.compress:
            first = {}
            for key, name in threads:
                first.setdefault(key, name)
            assert [first[id(b)].startswith("glz-compress") for b in bufs] == [False] + [True] * 3
            assert ex.link_counts["glz"] + ex.link_counts["raw"] == 4
        else:
            assert threads == []
    assert outs[0] == outs[1]
