"""The port's replication layer against the JAX package's, on the CPU.

The followers, the SPU-to-SPU sync, the in-sync quorum, promotion and
demotion, and the retention cleaner of ``fluvio_tpu_torch`` are held to
``fluvio_tpu`` on the same seeded inputs, tolerance 0:

- the five internal wire types (``schema/internal_spu.py``) encode
  byte-equal over values hypothesis draws, and each package's bytes
  decode with the other's codec to the same bytes;
- a leader's high watermark after each follower report (the JAX tests'
  sequences and seeded random ones at replica sets of 2-4);
- a follower's ``apply_sync`` on an exact append, an overlap and a gap:
  the same answer, stored bytes and offsets, from the same pushed bytes
  (each leader's ``_build_sync``);
- two SPUs wired directly, each package's and across packages;
- cluster sequences through the JAX package's replicated
  ``boot_cluster`` (``tests/test_replication.py``) and the port's
  ``boot_torch_cluster`` (SPUs with ``smart_engine.device="cpu"``): a
  READ_COMMITTED produce at a replica set of 2; a leader's failure with a
  client connected before it, a produce after it (whose HW does not move:
  the promoted leader's quorum is its replica set's size, 2, with one SPU
  down), the dead SPU's restart and rejoin; a demotion driven by the SC's
  health view; a rejoin with a log longer than the new leader's (the JAX
  cluster keeps the tail, and the port does the same: ``ROADMAP.md`` §3);
  and a replica set of 3 consumed through the north star, ``flu[vV]io``
  and ``3_aggregate`` from its promoted leader. Each compares every SPU's
  stored batches, HW and LEO, the SC's LRS and the consumed records;
- the `Cleaner` on ``tests/test_storage.py``'s cases and on seeded
  segment layouts, the `CleanerController`'s two-phase unlink, and a
  running SPU shedding by size and by age.

A produce straight to an SPU stamps its batch 1,000, so both packages
store the same bytes; the SC-routed producer stamps the wall clock, so
its logs are compared batch by batch without the header's timestamps
(every record's timestamp delta is 0).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fluvio_tpu import client as ref_client
from fluvio_tpu.metadata import partition as ref_partition
from fluvio_tpu.metadata import topic as ref_topic
from fluvio_tpu.protocol import codec as ref_codec
from fluvio_tpu.protocol import error as ref_error
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.schema import controlplane as ref_controlplane
from fluvio_tpu.schema import internal_spu as ref_internal
from fluvio_tpu.schema import spu as ref_spu_schema
from fluvio_tpu.spu import cleaner_controller as ref_cleaner_controller
from fluvio_tpu.spu import follower as ref_follower
from fluvio_tpu.spu import internal_service as ref_internal_service
from fluvio_tpu.spu import replica as ref_replica
from fluvio_tpu.spu.config import SpuConfig as RefSpuConfig
from fluvio_tpu.spu.server import SpuServer as RefSpuServer
from fluvio_tpu.storage import cleaner as ref_cleaner
from fluvio_tpu.storage import config as ref_storage_config
from fluvio_tpu.storage import replica as ref_storage_replica
from fluvio_tpu_torch import client as port_client
from fluvio_tpu_torch.metadata import partition as port_partition
from fluvio_tpu_torch.metadata import topic as port_topic
from fluvio_tpu_torch.protocol import codec as port_codec
from fluvio_tpu_torch.protocol import error as port_error
from fluvio_tpu_torch.protocol import record as port_record
from fluvio_tpu_torch.schema import controlplane as port_controlplane
from fluvio_tpu_torch.schema import internal_spu as port_internal
from fluvio_tpu_torch.schema import spu as port_spu_schema
from fluvio_tpu_torch.spu import cleaner_controller as port_cleaner_controller
from fluvio_tpu_torch.spu import follower as port_follower
from fluvio_tpu_torch.spu import internal_service as port_internal_service
from fluvio_tpu_torch.spu import replica as port_replica
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.server import SpuServer
from fluvio_tpu_torch.storage import cleaner as port_cleaner
from fluvio_tpu_torch.storage import config as port_storage_config
from fluvio_tpu_torch.storage import replica as port_storage_replica
from tests.test_replication import boot_cluster as ref_boot_cluster
from tests.test_torch_cluster import _produce_direct, _ref_invocations, _until
from tests.test_torch_isolation import (
    CLUSTER_WAIT_S,
    boot_torch_cluster,
    gen_json,
    namespace_invocations,
    replica_log,
    restart_spu,
    restart_torch_spu,
    shutdown_torch_cluster,
    wait_for_module,
    wait_spu_online,
)
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

REF = SimpleNamespace(
    port=False, internal=ref_internal, record=ref_record, codec=ref_codec, error=ref_error,
    Leader=ref_replica.LeaderReplicaState, Follower=ref_follower.FollowerReplicaState,
    build_sync=ref_internal_service._build_sync, Cleaner=ref_cleaner.Cleaner,
    CleanerController=ref_cleaner_controller.CleanerController,
    FileReplica=ref_storage_replica.FileReplica, ReplicaConfig=ref_storage_config.ReplicaConfig,
    SpuConfig=RefSpuConfig, SpuServer=RefSpuServer, SpuUpdate=ref_controlplane.SpuUpdate,
    spu_schema=ref_spu_schema, client=ref_client, topic=ref_topic, partition=ref_partition,
)
PORT = SimpleNamespace(
    port=True, internal=port_internal, record=port_record, codec=port_codec, error=port_error,
    Leader=port_replica.LeaderReplicaState, Follower=port_follower.FollowerReplicaState,
    build_sync=port_internal_service._build_sync, Cleaner=port_cleaner.Cleaner,
    CleanerController=port_cleaner_controller.CleanerController,
    FileReplica=port_storage_replica.FileReplica, ReplicaConfig=port_storage_config.ReplicaConfig,
    SpuConfig=SpuConfig, SpuServer=SpuServer, SpuUpdate=port_controlplane.SpuUpdate,
    spu_schema=port_spu_schema, client=port_client, topic=port_topic, partition=port_partition,
)


def _run(coro, timeout: float = 90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _encode(value, pkg) -> bytes:
    w = pkg.codec.ByteWriter()
    value.encode(w)
    return w.bytes()


def _record_set(pkg, values, first_timestamp: int = 1_000):
    R = pkg.record
    return R.RecordSet(batches=[R.Batch.from_records(
        [R.Record(value=v) for v in values], first_timestamp=first_timestamp)])


# ---------------------------------------------------------------------------
# Wire types
# ---------------------------------------------------------------------------

WIRE_TYPES = ("ReplicaOffsets", "SyncRecords", "FollowerSyncRequest", "FollowerOffsetsAck",
              "FollowerOffsetsRequest")
_text = st.text(max_size=8)
_i32 = st.integers(-(2**31), 2**31 - 1)
_i64 = st.integers(-(2**63), 2**63 - 1)
_offsets = st.tuples(_text, _i32, _i64, _i64)
_batch = st.fixed_dictionaries({
    "base": st.integers(0, 2**40), "ts": st.integers(0, 2**41),
    "records": st.lists(st.tuples(st.one_of(st.none(), st.binary(max_size=6)),
                                  st.binary(max_size=24)), min_size=1, max_size=5)})
_wire = st.fixed_dictionaries({
    "offsets": st.lists(_offsets, min_size=1, max_size=3), "id": _i32,
    "code": st.sampled_from([int(c) for c in port_error.ErrorCode]),
    "leo": _i64, "hw": _i64, "batches": st.lists(_batch, max_size=3)})


def _wire_value(pkg, kind: str, d: dict):
    I, R = pkg.internal, pkg.record
    offsets = [I.ReplicaOffsets(topic=t, partition=p, leo=leo, hw=hw)
               for t, p, leo, hw in d["offsets"]]
    if kind == "ReplicaOffsets":
        return offsets[0]
    if kind == "SyncRecords":
        batches = [R.Batch.from_records([R.Record(value=v, key=k) for k, v in b["records"]],
                                        base_offset=b["base"], first_timestamp=b["ts"])
                   for b in d["batches"]]
        return I.SyncRecords(topic=offsets[0].topic, partition=offsets[0].partition,
                             error_code=pkg.error.ErrorCode(d["code"]), leader_leo=d["leo"],
                             leader_hw=d["hw"], records=R.RecordSet(batches=batches))
    if kind == "FollowerSyncRequest":
        return I.FollowerSyncRequest(follower_id=d["id"], replicas=offsets)
    if kind == "FollowerOffsetsAck":
        return I.FollowerOffsetsAck(error_code=pkg.error.ErrorCode(d["code"]))
    return I.FollowerOffsetsRequest(follower_id=d["id"], offsets=offsets)


def test_internal_api_keys_equal_the_reference():
    assert {k.name: int(k) for k in port_internal.InternalSpuApiKey} == {
        k.name: int(k) for k in ref_internal.InternalSpuApiKey}
    for name in ("FollowerSyncRequest", "FollowerOffsetsRequest"):
        port_cls, ref_cls = getattr(port_internal, name), getattr(ref_internal, name)
        assert int(port_cls.API_KEY) == int(ref_cls.API_KEY)
        assert port_cls.RESPONSE.__name__ == ref_cls.RESPONSE.__name__


@pytest.mark.parametrize("kind", WIRE_TYPES)
@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(d=_wire)
def test_internal_wire_types_encode_byte_equal_to_the_reference(kind, d):
    port_bytes = _encode(_wire_value(PORT, kind, d), PORT)
    ref_bytes = _encode(_wire_value(REF, kind, d), REF)
    assert port_bytes == ref_bytes
    ref_back = getattr(ref_internal, kind).decode(ref_codec.ByteReader(port_bytes))
    port_back = getattr(port_internal, kind).decode(port_codec.ByteReader(ref_bytes))
    assert _encode(ref_back, REF) == _encode(port_back, PORT) == port_bytes
    if kind == "SyncRecords":  # the port keeps a pushed batch's records unparsed
        assert all(b.raw_records is not None for b in port_back.records.batches)
        assert [[(r.key, r.value) for r in b.memory_records()] for b in
                port_back.records.batches] == [[(r.key, r.value) for r in b.records]
                                               for b in ref_back.records.batches]


# ---------------------------------------------------------------------------
# The leader's HW from its followers' reports
# ---------------------------------------------------------------------------

# TestLeaderFollowerOffsets' sequences (tests/test_replication.py:51-95):
# (in_sync_replica, records written, [(spu, leo, hw)])
KNOWN_REPORTS = {
    "quorum_of_two": (2, 3, [(2, 2, 0), (2, 3, 2)]),
    "second_highest_of_three": (3, 3, [(2, 3, 0), (3, 2, 0)]),
    "never_past_the_leo": (2, 1, [(2, 99, 0)]),
}


def _random_steps(seed: int, rf: int):
    """A seeded sequence: writes of 1-5 records, follower reports (spu ids
    1..rf, a LEO up to 2 past the leader's) and follower drops."""
    rng = np.random.default_rng(seed)
    steps, leo = [], 0
    for _ in range(24):
        kind = rng.choice(["write", "report", "report", "report", "drop"])
        if kind == "write":
            n = int(rng.integers(1, 6))
            steps.append(("write", n))
            leo += n
        elif kind == "report":
            steps.append(("report", int(rng.integers(1, rf + 1)), int(rng.integers(0, leo + 3)),
                          int(rng.integers(0, leo + 1))))
        else:
            steps.append(("drop", int(rng.integers(1, rf + 1))))
    return steps


async def _hw_sequence(pkg, tmp_path, in_sync: int, steps):
    leader = pkg.Leader("t", 0, pkg.ReplicaConfig(base_dir=str(tmp_path / ("port" if pkg.port
                                                                             else "ref"))),
                        in_sync_replica=in_sync)
    out, written = [], 0
    try:
        for step in steps:
            if step[0] == "write":
                vals = [b"r%d" % (written + i) for i in range(step[1])]
                written += step[1]
                out.append(("write", await leader.write_record_set(_record_set(pkg, vals))))
            elif step[0] == "report":
                out.append(("report", leader.update_follower_offsets(step[1], leo=step[2],
                                                                     hw=step[3])))
            else:
                leader.drop_follower(step[1])
                out.append(("drop", None))
            out[-1] += (leader.leo(), leader.hw(), leader.hw_publisher.current_value(),
                        sorted(leader.followers.items()))
    finally:
        leader.close()
    return out


@pytest.mark.parametrize("name", sorted(KNOWN_REPORTS))
def test_known_report_sequences_equal_the_reference(tmp_path, name):
    in_sync, n, reports = KNOWN_REPORTS[name]
    steps = [("write", n)] + [("report", *r) for r in reports]
    got, ref = (_run(_hw_sequence(pkg, tmp_path, in_sync, steps)) for pkg in (PORT, REF))
    assert got == ref
    assert [s[3] for s in got] == {"quorum_of_two": [0, 2, 3],
                                    "second_highest_of_three": [0, 0, 2],
                                    "never_past_the_leo": [0, 1]}[name]


@pytest.mark.parametrize("rf, seed", [(2, 1), (2, 2), (3, 3), (3, 4), (4, 5), (4, 6)])
def test_random_report_sequences_equal_the_reference(tmp_path, rf, seed):
    steps = _random_steps(seed, rf)
    got, ref = (_run(_hw_sequence(pkg, tmp_path, rf, steps)) for pkg in (PORT, REF))
    assert got == ref
    assert any(s[0] == "report" and s[1] for s in got)  # the HW moved at least once


# ---------------------------------------------------------------------------
# A follower applying pushed batches
# ---------------------------------------------------------------------------

APPLY_CASES = ("exact", "overlap", "gap")


async def _apply_sequence(pkg, tmp_path, case: str):
    """A leader of three batches; its ``_build_sync`` from offset 0; a
    follower fed (exact) all of it, (overlap) its first batch then all of
    it, (gap) all but the first batch, then rebuilt (``reset_storage``)
    and fed all of it. Returns the pushed bytes and, after each apply, the
    answer, the follower's offsets and stored bytes."""
    side = tmp_path / ("port" if pkg.port else "ref")
    leader = pkg.Leader("t", 0, pkg.ReplicaConfig(base_dir=str(side / "leader")))
    follower = pkg.Follower("t", 0, leader=1,
                            config=pkg.ReplicaConfig(base_dir=str(side / "follower")))
    try:
        for k, values in enumerate((gen_json(5, seed=11), gen_json(3, seed=12),
                                    gen_json(4, seed=13))):
            await leader.write_record_set(_record_set(pkg, values, first_timestamp=1_000 + k))
        sync = pkg.build_sync(leader, 0)
        pushed = _encode(sync, pkg)
        decoded = pkg.internal.SyncRecords.decode(pkg.codec.ByteReader(pushed))
        batches = decoded.records.batches

        def part(bs):
            return dataclasses.replace(decoded, records=pkg.record.RecordSet(batches=list(bs)))

        feeds = {"exact": [decoded], "overlap": [part(batches[:1]), decoded],
                 "gap": [part(batches[1:])]}[case]
        out = []
        for feed in feeds:
            out.append((follower.apply_sync(feed), follower.leo(), follower.hw(),
                        replica_log(follower.storage)))
        if case == "gap":
            follower.reset_storage()
            out.append((follower.apply_sync(decoded), follower.leo(), follower.hw(),
                        replica_log(follower.storage)))
        assert out[-1][3] == replica_log(leader.storage)  # the follower holds the leader's bytes
        return pushed, out
    finally:
        leader.close()
        follower.close()


@pytest.mark.parametrize("case", APPLY_CASES)
def test_apply_sync_equals_the_reference(tmp_path, case):
    got, ref = (_run(_apply_sequence(pkg, tmp_path, case)) for pkg in (PORT, REF))
    assert got == ref
    answers = [a for a, *_ in got[1]]
    assert answers == {"exact": [False], "overlap": [False, False], "gap": [True, False]}[case]
    if case == "gap":
        assert got[1][0][1:3] == (0, 0)  # nothing stored past a gap


# ---------------------------------------------------------------------------
# Two SPUs wired directly
# ---------------------------------------------------------------------------


def _spu(pkg, tmp_path, spu_id: int, in_sync: int = 1, sc_addr: str = ""):
    d = str(tmp_path / f"spu-{spu_id}")
    config = pkg.SpuConfig(id=spu_id, public_addr="127.0.0.1:0", private_addr="127.0.0.1:0",
                           sc_addr=sc_addr, log_base_dir=d,
                           replication=pkg.ReplicaConfig(base_dir=d), in_sync_replica=in_sync)
    if pkg.port:
        config.smart_engine.device = "cpu"
    return pkg.SpuServer(config)


async def _wired_sequence(leader_pkg, follower_pkg, tmp_path):
    """SPU 1 leads ``t-0`` at a quorum of 2 (``in_sync_replica``), SPU 2
    follows it through its peer table (no SC), as
    ``tests/test_replication.py:141-200``. Returns the offsets after each
    step and both stored logs."""
    a = _spu(leader_pkg, tmp_path, 1, in_sync=2)
    b = _spu(follower_pkg, tmp_path, 2)
    await a.start()
    await b.start()
    out = []
    try:
        leader = a.ctx.create_replica("t", 0)
        b.ctx.peers = {1: follower_pkg.SpuUpdate(id=1, private_addr=a.private_addr)}
        follower = b.ctx.create_follower("t", 0, leader=1)
        b.ctx.notify_followers_changed()
        for k, values in enumerate(([b"r1", b"r2", b"r3"], [b"r4"], gen_json(40, seed=5))):
            await leader.write_record_set(_record_set(leader_pkg, values, 1_000 + k))
            out.append(("written", leader.leo(), leader.hw()))
            await _until(lambda: follower.hw() == leader.leo() == leader.hw()
                         and leader.followers.get(2) == (leader.leo(),) * 2, "follower sync")
            out.append(("synced", follower.leo(), follower.hw(), leader.hw(),
                        sorted(leader.followers.items())))
        logs = (replica_log(leader.storage), replica_log(follower.storage))
        assert logs[0] == logs[1]
        out.append(logs[0])
    finally:
        await a.stop()
        await b.stop()
    return out


def test_wired_follower_sync_equals_the_reference(tmp_path):
    got = _run(_wired_sequence(PORT, PORT, tmp_path / "port"))
    ref = _run(_wired_sequence(REF, REF, tmp_path / "ref"))
    assert got == ref
    assert got[0] == ("written", 3, 0)  # no follower ack yet
    assert got[1][:4] == ("synced", 3, 3, 3)


@pytest.mark.parametrize("leader_pkg, follower_pkg", [(REF, PORT), (PORT, REF)],
                         ids=["port_follows_jax", "jax_follows_port"])
def test_follower_syncs_across_packages(tmp_path, leader_pkg, follower_pkg):
    """A port follower syncs from a JAX leader and a JAX follower from a
    port leader, over the internal API: the wire is one."""
    got = _run(_wired_sequence(leader_pkg, follower_pkg, tmp_path / "mixed"))
    ref = _run(_wired_sequence(REF, REF, tmp_path / "ref"))
    assert got == ref


# ---------------------------------------------------------------------------
# Cluster sequences
# ---------------------------------------------------------------------------


class Side:
    """One package's replicated cluster and client types."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.port = pkg.port
        self.topic = pkg.topic
        self.Fluvio = pkg.client.Fluvio
        self.Offset = pkg.client.Offset
        self.ConsumerConfig = pkg.client.ConsumerConfig
        self.ProducerConfig = pkg.client.ProducerConfig
        self.Isolation = pkg.spu_schema.Isolation

    async def boot(self, tmp_path, n_spus: int):
        if self.port:
            return await boot_torch_cluster(tmp_path / "port", n_spus, device="cpu")
        return await ref_boot_cluster(tmp_path / "ref", n_spus)

    async def restart(self, sc, server):
        if self.port:
            return await restart_torch_spu(sc, server)
        return await restart_spu(sc, server, RefSpuServer)

    def invocations(self, invocations):
        return list(invocations) if self.port else _ref_invocations(invocations)


SIDES = (Side(REF), Side(PORT))


async def _wait_online(side, sc, topic: str, partition: int = 0, not_leader=None):
    """The partition ONLINE at the SC (under a leader other than
    ``not_leader``): its spec."""
    online = side.pkg.partition.PartitionResolution.ONLINE
    obj = await sc.ctx.partitions.wait_action(
        f"{topic}-{partition}", lambda o: o is not None and o.status.resolution == online
        and o.spec.leader != not_leader, timeout=CLUSTER_WAIT_S)
    if obj is None or obj.status.resolution != online or obj.spec.leader == not_leader:
        raise TimeoutError(f"{topic}-{partition} never came online at the SC")
    return obj.spec


async def _lrs(sc, key: str, leo: int, replicas):
    """The SC's LRS of ``key`` once it reports the leader at ``leo`` and
    each of ``replicas`` ((spu, leo, hw)): (leader spu, hw, leo, the
    replicas, lsr)."""
    want = sorted(replicas)

    def done(o):
        return (o is not None and o.status.leader.leo == leo
                and sorted((r.spu, r.leo, r.hw) for r in o.status.replicas) == want)

    obj = await sc.ctx.partitions.wait_action(key, done, timeout=CLUSTER_WAIT_S)
    if not done(obj):
        raise TimeoutError(f"the SC's LRS of {key} never reached {leo}, {want}")
    st_ = obj.status
    return (st_.leader.spu, st_.leader.hw, st_.leader.leo,
            sorted((r.spu, r.leo, r.hw) for r in st_.replicas), st_.lsr)


async def _produce(addr: str, topic: str, values, committed: bool = False):
    """`_produce_direct` to partition 0: (error code, base offset)."""
    isolation = port_spu_schema.Isolation
    return (await _produce_direct(addr, topic, 0, values, isolation.READ_COMMITTED if committed
                                  else isolation.READ_UNCOMMITTED))[:2]


def _batches_view(storage):
    """A replica's stored batches without their header timestamps: (base
    offset, last offset delta, attributes, record count, record bytes)."""
    from fluvio_tpu_torch.protocol.codec import ByteReader

    r, out = ByteReader(replica_log(storage)), []
    while r.remaining() > 0:
        b = port_record.Batch.decode(r, parse_records=False, check_crc=True)
        out.append((b.base_offset, b.header.last_offset_delta, b.header.attributes,
                    b.raw_record_count, b.raw_records))
    return out


def _spu_by_id(spus, spu_id: int):
    return next(s for s in spus if s.config.id == spu_id)


async def _consume(side, client, topic: str, invocations=()):
    """Every record of ``topic``-0 from the beginning, through
    ``invocations``: (offset, key, value)."""
    consumer = await client.partition_consumer(topic, 0)
    config = side.ConsumerConfig(disable_continuous=True,
                                 smartmodules=side.invocations(invocations))
    return [(r.offset, r.key, bytes(r.value)) async for r in
            consumer.stream(side.Offset.beginning(), config)]


async def _committed_sequence(side, tmp_path):
    """rf 2: a READ_COMMITTED produce through the SC-routed producer is
    answered once the follower holds the records."""
    sc, admin, spus = cluster = await side.boot(tmp_path, 2)
    out = {}
    client = None
    try:
        await admin.create_topic("committed", side.topic.TopicSpec.computed(1, 2))
        spec = await _wait_online(side, sc, "committed")
        leader_spu = _spu_by_id(spus, spec.leader)
        follower_spu = next(s for s in spus if s is not leader_spu)
        await _until(lambda: follower_spu.ctx.follower_for("committed", 0) is not None
                     and leader_spu.ctx.leader_for("committed", 0) is not None, "replicas")
        out["replicas"] = (spec.leader, list(spec.replicas),
                           leader_spu.ctx.leader_for("committed", 0).in_sync_replica)
        client = await side.Fluvio.connect(sc.public_addr)
        producer = await client.topic_producer("committed", config=side.ProducerConfig(
            isolation=side.Isolation.READ_COMMITTED, batch_size=1024))
        values = gen_json(60, seed=31)
        futs = [await producer.send(None, v) for v in values]
        await producer.flush()
        out["offsets"] = [(m.partition, m.offset) for m in [await f.wait() for f in futs]]
        await producer.close()
        leader = leader_spu.ctx.leader_for("committed", 0)
        follower = follower_spu.ctx.follower_for("committed", 0)
        out["acked"] = (leader.leo(), leader.hw(), follower.leo())  # the ack implies the copy
        await _until(lambda: follower.hw() == len(values), "follower HW")
        assert replica_log(leader.storage) == replica_log(follower.storage)
        out["log"] = _batches_view(leader.storage)
        out["lrs"] = await _lrs(sc, "committed-0", len(values),
                                [(follower_spu.config.id, len(values), len(values))])
        out["consumed"] = await _consume(side, client, "committed")
    finally:
        if client is not None:
            await client.close()
        await shutdown_torch_cluster(*cluster)
    return out


def test_committed_produce_at_rf2_equals_the_reference(tmp_path):
    ref = _run(_committed_sequence(SIDES[0], tmp_path))
    got = _run(_committed_sequence(SIDES[1], tmp_path))
    assert got == ref
    n = len(got["offsets"])
    assert got["replicas"][2] == 2 and got["acked"] == (n, n, n)
    assert got["lrs"][1:] == (n, n, [(got["replicas"][1][1], n, n)], 2)
    assert len(got["log"]) > 1 and [v for *_, v in got["consumed"]] == gen_json(60, seed=31)


async def _failover_sequence(side, tmp_path):
    """rf 2: records replicated; the leader's SPU stopped; the follower
    elected and promoted; a client connected before the failure reads the
    log from the new leader and produces to it (READ_COMMITTED, 300 ms:
    the HW stays, the quorum being 2 with one SPU down); the dead SPU
    restarted on its log, rejoining as a follower and catching up."""
    sc, admin, spus = await side.boot(tmp_path, 2)
    out, client, live = {}, None, list(spus)
    try:
        await admin.create_topic("ha", side.topic.TopicSpec.computed(1, 2))
        spec = await _wait_online(side, sc, "ha")
        first = _spu_by_id(spus, spec.leader)
        survivor = next(s for s in spus if s is not first)
        await _until(lambda: survivor.ctx.follower_for("ha", 0) is not None, "follower")
        client = await side.Fluvio.connect(sc.public_addr)
        values = [b"rec-%d" % i for i in range(10)]
        out["produce"] = await _produce(first.public_addr, "ha", values, True)
        await _until(lambda: survivor.ctx.follower_for("ha", 0).hw() == 10, "replicated")

        await first.stop()
        live.remove(first)
        spec = await _wait_online(side, sc, "ha", not_leader=first.config.id)
        await _until(lambda: survivor.ctx.leader_for("ha", 0) is not None, "promotion")
        leader = survivor.ctx.leader_for("ha", 0)
        out["promoted"] = (spec.leader, leader.leo(), leader.hw(), leader.in_sync_replica,
                           sorted(survivor.ctx.followers))
        out["consumed_after_failover"] = await _consume(side, client, "ha")

        producer = await client.topic_producer("ha", config=side.ProducerConfig(
            isolation=side.Isolation.READ_COMMITTED, timeout_ms=300))
        futs = [await producer.send(None, b"after-%d" % i) for i in range(3)]
        await producer.flush()
        out["after_offsets"] = [(await f.wait()).offset for f in futs]
        await producer.close()
        out["after"] = (leader.leo(), leader.hw())

        restarted = await side.restart(sc, first)
        live.append(restarted)
        await _until(lambda: restarted.ctx.follower_for("ha", 0) is not None
                     and restarted.ctx.follower_for("ha", 0).hw() == 13, "rejoin")
        rejoined = restarted.ctx.follower_for("ha", 0)
        out["rejoined"] = (rejoined.leader, rejoined.leo(), rejoined.hw(), leader.hw(),
                           sorted(restarted.ctx.leaders))
        assert replica_log(rejoined.storage) == replica_log(leader.storage)
        out["log"] = _batches_view(leader.storage)
        out["lrs"] = await _lrs(sc, "ha-0", 13, [(first.config.id, 13, 13)])
        out["consumed"] = await _consume(side, client, "ha")
    finally:
        if client is not None:
            await client.close()
        await shutdown_torch_cluster(sc, admin, live)
    return out


def test_leader_failure_and_rejoin_equal_the_reference(tmp_path):
    ref = _run(_failover_sequence(SIDES[0], tmp_path))
    got = _run(_failover_sequence(SIDES[1], tmp_path))
    assert got == ref
    assert got["produce"] == (0, 0)
    assert got["promoted"][1:] == (10, 10, 2, [])
    assert [v for *_, v in got["consumed_after_failover"]] == [b"rec-%d" % i for i in range(10)]
    assert got["after_offsets"] == [10, 11, 12] and got["after"] == (13, 10)
    assert got["rejoined"][1:] == (13, 13, 13, [])
    assert len(got["consumed"]) == 13


async def _demotion_sequence(side, tmp_path):
    """rf 2: the SC's health view marks the running leader's SPU down; the
    SC elects the other, which is promoted, and the old leader, still
    connected, is demoted to its follower on the same storage and syncs
    from it."""
    sc, admin, spus = cluster = await side.boot(tmp_path, 2)
    out = {}
    try:
        await admin.create_topic("demote", side.topic.TopicSpec.computed(1, 2))
        spec = await _wait_online(side, sc, "demote")
        old = _spu_by_id(spus, spec.leader)
        new = next(s for s in spus if s is not old)
        await _until(lambda: new.ctx.follower_for("demote", 0) is not None, "follower")
        out["produce"] = await _produce(old.public_addr, "demote", gen_json(5, seed=41), True)
        sc.ctx.health.update(old.config.id, False)
        spec = await _wait_online(side, sc, "demote", not_leader=old.config.id)
        await _until(lambda: new.ctx.leader_for("demote", 0) is not None
                     and old.ctx.follower_for("demote", 0) is not None, "roles switched")
        out["roles"] = [(s.config.id, sorted(s.ctx.leaders), sorted(s.ctx.followers))
                        for s in (old, new)]
        leader, follower = new.ctx.leader_for("demote", 0), old.ctx.follower_for("demote", 0)
        out["switched"] = (spec.leader, follower.leader, leader.leo(), leader.hw(),
                           follower.leo(), leader.in_sync_replica)
        out["produce_after"] = await _produce(new.public_addr, "demote", gen_json(4, seed=42),
                                              True)
        out["refused"] = await _produce(old.public_addr, "demote", [b"x"])
        await _until(lambda: follower.hw() == 9, "demoted follower caught up")
        out["offsets"] = (leader.leo(), leader.hw(), follower.leo(), follower.hw())
        out["log"] = replica_log(leader.storage)
        assert out["log"] == replica_log(follower.storage)
        out["lrs"] = await _lrs(sc, "demote-0", 9, [(old.config.id, 9, 9)])
    finally:
        await shutdown_torch_cluster(*cluster)
    return out


def test_demotion_by_the_sc_health_equals_the_reference(tmp_path):
    ref = _run(_demotion_sequence(SIDES[0], tmp_path))
    got = _run(_demotion_sequence(SIDES[1], tmp_path))
    assert got == ref
    assert got["switched"][2:] == (5, 5, 5, 2)
    assert got["produce_after"] == (0, 5) and got["offsets"] == (9, 9, 9, 9)
    assert got["refused"][0] == int(port_error.ErrorCode.NOT_LEADER_FOR_PARTITION)


async def _tail_sequence(side, tmp_path):
    """rf 2, a rejoin with a log longer than the new leader's: the
    follower stopped; the leader takes 3 records it cannot commit, then
    stops; the follower restarted, elected and promoted with the shorter
    log, takes 2 records; the old leader restarted as its follower."""
    sc, admin, spus = await side.boot(tmp_path, 2)
    out, live = {}, list(spus)
    try:
        await admin.create_topic("tail", side.topic.TopicSpec.computed(1, 2))
        spec = await _wait_online(side, sc, "tail")
        lead = _spu_by_id(spus, spec.leader)
        foll = next(s for s in spus if s is not lead)
        await _until(lambda: foll.ctx.follower_for("tail", 0) is not None, "follower")
        out["committed"] = await _produce(lead.public_addr, "tail",
                                          [b"c-%d" % i for i in range(4)], True)
        await _until(lambda: foll.ctx.follower_for("tail", 0).hw() == 4, "replicated")
        await foll.stop()
        live.remove(foll)
        await wait_spu_online(sc, foll.config.id, online=False)
        out["uncommitted"] = await _produce(lead.public_addr, "tail",
                                            [b"lost-%d" % i for i in range(3)])
        old_leader = lead.ctx.leader_for("tail", 0)
        out["before"] = (old_leader.leo(), old_leader.hw())
        # the stopped follower's session closed: the leader dropped it
        out["lrs_alone"] = await _lrs(sc, "tail-0", 7, [])
        await lead.stop()
        live.remove(lead)
        foll = await side.restart(sc, foll)
        live.append(foll)
        spec = await _wait_online(side, sc, "tail", not_leader=lead.config.id)
        await _until(lambda: foll.ctx.leader_for("tail", 0) is not None, "promotion")
        leader = foll.ctx.leader_for("tail", 0)
        out["new"] = await _produce(foll.public_addr, "tail", [b"new-%d" % i for i in range(2)])
        lead = await side.restart(sc, lead)
        live.append(lead)
        await _until(lambda: lead.ctx.follower_for("tail", 0) is not None
                     and lead.ctx.follower_for("tail", 0).hw() == leader.hw() > 4, "rejoin")
        rejoined = lead.ctx.follower_for("tail", 0)
        out["after"] = (spec.leader, leader.leo(), leader.hw(), rejoined.leo(), rejoined.hw())
        out["logs"] = (replica_log(leader.storage), replica_log(rejoined.storage))
    finally:
        await shutdown_torch_cluster(sc, admin, live)
    return out


def test_rejoin_with_a_longer_log_keeps_its_tail_as_the_reference_does(tmp_path):
    """A reference fault, pinned: the rejoining SPU's 3 uncommitted
    records stay past the new leader's log (``apply_sync`` skips what lies
    below its LEO and nothing truncates), and its LEO, reported to the new
    leader, moves the leader's HW over the new leader's own 2 records."""
    ref = _run(_tail_sequence(SIDES[0], tmp_path))
    got = _run(_tail_sequence(SIDES[1], tmp_path))
    assert got == ref
    assert got["before"] == (7, 4) and got["new"] == (0, 4)
    assert got["lrs_alone"][1:] == (4, 7, [], 1)
    assert got["after"][1:] == (6, 6, 7, 6)
    leader_log, rejoined_log = got["logs"]
    assert rejoined_log != leader_log and len(rejoined_log) > len(leader_log)


CHAINS = ("north_star", "flu_regex_filter", "3_aggregate")


async def _rf3_chains_sequence(side, tmp_path):
    """Three SPUs, ``repl`` at rf 3, 300 ``gen_json`` records produced
    READ_COMMITTED through the SC; the leader's SPU stopped; the north
    star, ``flu[vV]io`` and ``3_aggregate`` consumed by name from the
    promoted leader through a fresh client."""
    sc, admin, spus = await side.boot(tmp_path, 3)
    out, live, client = {}, list(spus), None
    try:
        await admin.create_topic("repl", side.topic.TopicSpec.computed(1, 3))
        spec = await _wait_online(side, sc, "repl")
        first = _spu_by_id(spus, spec.leader)
        others = [s for s in spus if s is not first]
        await _until(lambda: all(s.ctx.follower_for("repl", 0) is not None for s in others),
                     "followers")
        pushed = {}
        for chain in CHAINS:
            modules, pushed[chain] = namespace_invocations(chain)
            for name, source in modules:
                await admin.create_smartmodule(name, source)
                for s in spus:
                    await wait_for_module(s, name)
        values = gen_json(300, seed=51)
        producer_client = await side.Fluvio.connect(sc.public_addr)
        try:
            producer = await producer_client.topic_producer("repl", config=side.ProducerConfig(
                isolation=side.Isolation.READ_COMMITTED, timeout_ms=30_000, batch_size=8192))
            futs = await producer.send_all([(None, v) for v in values])
            await producer.flush()
            out["offsets"] = [(await f.wait()).offset for f in futs]
            await producer.close()
        finally:
            await producer_client.close()
        leader = first.ctx.leader_for("repl", 0)
        out["acked"] = (leader.leo(), leader.hw(), sorted(
            (s.config.id, s.ctx.follower_for("repl", 0).leo()) for s in others))
        await _until(lambda: all(s.ctx.follower_for("repl", 0).hw() == 300 for s in others),
                     "followers' HW")
        await first.stop()
        live.remove(first)
        spec = await _wait_online(side, sc, "repl", not_leader=first.config.id)
        new = _spu_by_id(spus, spec.leader)
        await _until(lambda: new.ctx.leader_for("repl", 0) is not None, "promotion")
        promoted = new.ctx.leader_for("repl", 0)
        out["promoted"] = (promoted.leo(), promoted.hw(), promoted.in_sync_replica)
        client = await side.Fluvio.connect(sc.public_addr)
        for chain in CHAINS:
            out[chain] = await _consume(side, client, "repl", pushed[chain])
        if side.port:
            assert new.ctx.metrics.smartmodule.fallback_slices == 0
    finally:
        if client is not None:
            await client.close()
        await shutdown_torch_cluster(sc, admin, live)
    return out


def test_rf3_failover_chains_equal_the_reference(tmp_path):
    ref = _run(_rf3_chains_sequence(SIDES[0], tmp_path), timeout=180)
    got = _run(_rf3_chains_sequence(SIDES[1], tmp_path), timeout=180)
    assert got == ref
    assert got["offsets"] == list(range(300))
    assert got["acked"][:2] == (300, 300) and [leo for _, leo in got["acked"][2]] == [300, 300]
    assert got["promoted"] == (300, 300, 3)
    for chain in CHAINS:
        assert 0 < len(got[chain]) <= 300


# ---------------------------------------------------------------------------
# The retention cleaner
# ---------------------------------------------------------------------------


def _storage_state(replica):
    """What a replica holds after cleaning: its segment bases, log start,
    offsets and the bytes readable from its start."""
    return (sorted(replica.prev_segments), replica.active_segment.base_offset,
            replica.get_log_start_offset(), replica.get_leo(), replica.get_hw(),
            replica_log(replica))


def _write(pkg, replica, values, first_timestamp=None):
    replica.write_recordset(_record_set(pkg, values, first_timestamp=first_timestamp))


def _storage_case(pkg, tmp_path, case: str):
    """``tests/test_storage.py``'s TestCleaner cases (:183-215), with
    fixed timestamps: (the cleaner's answer, the state after, the read
    below the start's error code)."""
    d = tmp_path / ("port" if pkg.port else "ref")
    if case == "age":
        config = pkg.ReplicaConfig(base_dir=str(d), segment_max_bytes=300, retention_seconds=10)
        replica = pkg.FileReplica("t", 0, 0, config)
        for _ in range(6):
            _write(pkg, replica, [b"x" * 100], first_timestamp=1_000_000)
        removed = pkg.Cleaner(replica).clean(now_ms=1_060_000)
    elif case == "size":
        config = pkg.ReplicaConfig(base_dir=str(d), segment_max_bytes=300,
                                   max_partition_size=600, retention_seconds=10**9)
        replica = pkg.FileReplica("t", 0, 0, config)
        for i in range(8):
            _write(pkg, replica, [b"y" * 100], first_timestamp=5_000 + i)
        removed = pkg.Cleaner(replica).clean(now_ms=10_000)
    else:
        config = pkg.ReplicaConfig(base_dir=str(d), segment_max_bytes=300, retention_seconds=10)
        replica = pkg.FileReplica("t", 0, 0, config)
        for _ in range(6):
            _write(pkg, replica, [b"x" * 100], first_timestamp=1000)
        removed = pkg.Cleaner(replica).clean(now_ms=10_000_000)
    try:
        replica.read_partition_slice(0, 1 << 20)
        below = None
    except pkg.error.FluvioError as e:
        below = int(e.code)
    state = _storage_state(replica)
    replica.close()
    return removed, state, below


@pytest.mark.parametrize("case", ["age", "size", "start_offset_errors"])
def test_cleaner_cases_equal_the_reference(tmp_path, case):
    got, ref = (_storage_case(pkg, tmp_path, case) for pkg in (PORT, REF))
    assert got == ref
    assert got[0] and got[1][2] > 0  # segments shed, the log start advanced
    assert got[2] == int(port_error.ErrorCode.OFFSET_OUT_OF_RANGE)


def _layout_case(pkg, tmp_path, seed: int):
    """A seeded layout: 20-60 batches of 1-4 records of 20-200 B, each
    batch a second newer than the last, in segments of 300-1,500 B;
    cleaned at a seeded time and retention window, with a partition size
    or none, detaching first (``unlink=False``), then unlinking."""
    rng = np.random.default_rng(seed)
    d = tmp_path / ("port" if pkg.port else "ref")
    config = pkg.ReplicaConfig(
        base_dir=str(d), segment_max_bytes=int(rng.integers(300, 1500)),
        retention_seconds=int(rng.integers(5, 40)),
        max_partition_size=None if rng.random() < 0.4 else int(rng.integers(500, 5000)))
    replica = pkg.FileReplica("t", 0, 0, config)
    n_batches = int(rng.integers(20, 60))
    for k in range(n_batches):
        values = [bytes(rng.integers(97, 123, size=int(rng.integers(20, 200)), dtype=np.uint8))
                  for _ in range(int(rng.integers(1, 5)))]
        _write(pkg, replica, values, first_timestamp=1_000_000 + 1_000 * k)
    cleaner = pkg.Cleaner(replica)
    removed = cleaner.clean(now_ms=1_000_000 + 1_000 * int(rng.integers(0, n_batches + 40)),
                            unlink=False)
    on_disk = [os.path.exists(seg.log_path) for seg in cleaner.detached]
    for seg in cleaner.detached:
        seg.remove_files()
    state = _storage_state(replica)
    files = sorted(os.listdir(replica.directory))
    replica.close()
    return removed, on_disk, state, files


@pytest.mark.parametrize("seed", range(6))
def test_cleaner_on_seeded_layouts_equals_the_reference(tmp_path, seed):
    got, ref = (_layout_case(pkg, tmp_path, seed) for pkg in (PORT, REF))
    assert got == ref
    assert all(got[1])  # detached segments stay on disk until unlinked


def _controller_case(pkg, tmp_path):
    """The `CleanerController`'s sweeps over a context of one led replica
    whose segments are past retention: what each sweep sheds and which
    shed segments' files are still on disk after it, and after ``stop``."""
    d = tmp_path / ("port" if pkg.port else "ref")
    config = pkg.ReplicaConfig(base_dir=str(d), segment_max_bytes=300, retention_seconds=10)
    leader = pkg.Leader("t", 0, config)
    ctx = SimpleNamespace(leaders={"t-0": leader})
    controller = pkg.CleanerController(ctx, interval_seconds=0)

    async def body():
        out = []
        for round_ in range(3):
            for _ in range(4):
                await leader.write_record_set(_record_set(pkg, [b"z" * 100], first_timestamp=1000))
            shed = controller.sweep()
            out.append((shed, sorted(os.path.basename(s.log_path)
                                     for s in controller._pending_unlink
                                     if os.path.exists(s.log_path)),
                        sorted(f for f in os.listdir(leader.storage.directory)
                               if f.endswith(".log"))))
        pending = list(controller._pending_unlink)
        await controller.stop()
        out.append(("stopped", [os.path.exists(s.log_path) for s in pending]))
        return out

    try:
        return _run(body())
    finally:
        leader.close()


def test_cleaner_controller_two_phase_unlink_equals_the_reference(tmp_path):
    got, ref = (_controller_case(pkg, tmp_path) for pkg in (PORT, REF))
    assert got == ref
    assert all(shed > 0 and pending for shed, pending, _ in got[:3])
    assert got[3] == ("stopped", [False] * len(got[3][1]))


async def _running_spu_case(pkg, tmp_path, case: str):
    """A running SPU sheds by size (segments of 2,048 B, 6,144 B a
    partition) or by age (segments of 1,024 B, an hour's window, the first
    40 records stamped 1970), swept by hand: what each sweep shed, the
    replica's state, and the records a consumer reads from the start."""
    d = str(tmp_path / ("port" if pkg.port else "ref"))
    if case == "size":
        replication = pkg.ReplicaConfig(base_dir=d, segment_max_bytes=2048,
                                        max_partition_size=6144)
    else:
        replication = pkg.ReplicaConfig(base_dir=d, segment_max_bytes=1024,
                                        retention_seconds=3600)
    config = pkg.SpuConfig(id=5002, public_addr="127.0.0.1:0", private_addr="",
                           log_base_dir=d, replication=replication, cleaner_interval_seconds=0)
    if pkg.port:
        config.smart_engine.device = "cpu"
    server = pkg.SpuServer(config)
    await server.start()
    out = {}
    try:
        leader = server.ctx.create_replica("topic", 0)
        side = Side(pkg)
        values = [b"payload-%04d-" % i + b"x" * 80 for i in range(300)]
        for lo in range(0, 300, 20):
            stamp = 1_000 if (case == "size" or lo < 40) else None
            batch = pkg.record.RecordSet(batches=[pkg.record.Batch.from_records(
                [pkg.record.Record(value=v) for v in values[lo:lo + 20]],
                first_timestamp=stamp)])
            await leader.write_record_set(batch)
        out["shed"] = [server.cleaner.sweep(), server.cleaner.sweep()]
        state = _storage_state(leader.storage)
        out["state"] = state[:5]
        client = await side.Fluvio.connect(server.public_addr)
        try:
            out["consumed"] = [(r.offset, bytes(r.value)) for r in
                               await _consume_all(side, client)]
        finally:
            await client.close()
    finally:
        await server.stop()
    return out


async def _consume_all(side, client):
    consumer = await client.partition_consumer("topic", 0)
    return [r async for r in consumer.stream(side.Offset.beginning(),
                                             side.ConsumerConfig(disable_continuous=True))]


@pytest.mark.parametrize("case", ["size", "age"])
def test_running_spu_sheds_as_the_reference(tmp_path, case):
    got, ref = (_run(_running_spu_case(pkg, tmp_path, case)) for pkg in (PORT, REF))
    assert got == ref
    start = got["state"][2]
    assert got["shed"][0] > 0 and got["shed"][1] == 0 and start > 0
    assert [o for o, _ in got["consumed"]] == list(range(start, 300))
    if case == "age":
        assert start == 40  # the two batches stamped 1970, a segment each
