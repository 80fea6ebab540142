"""The port's cluster path against the JAX package's, on the CPU.

The SC, the SPU's SC dispatcher, the admin client, the producer and the
SC-routed consumers of ``fluvio_tpu_torch`` are held to ``fluvio_tpu`` on
the same seeded inputs, tolerance 0:

- every request and response type of ``schema/admin.py`` and
  ``schema/controlplane.py`` encodes byte-equal in both packages, over
  values hypothesis draws;
- ``generate_replica_map`` gives the same maps, or the same
  ``SchedulingError``, over seeded SPU and rack sets, and
  ``validate_topic_spec`` the same verdicts;
- one admin / produce / consume sequence runs through the JAX package's
  ``boot_cluster`` (``tests/test_sc.py``) and the port's cluster
  (``boot_torch_cluster``, SPUs with ``smart_engine.device="cpu"``), and
  every observation is equal: topic statuses, partition leaders, produce
  offsets, values consumed through a pushed namespace-form module, the
  merged 2-partition stream, the SC's LRS offsets, the admin error codes;
- an SC of the port seeded from the JAX SC's stores
  (`interop.metadata_from_reference`) answers List and pushes replicas
  with the same bytes;
- an assignment in which an SPU follows another, which leads a replica
  set of two, and a topic that sets a retention window or a partition
  size, are served alike: the same roles, produce answers, stored bytes,
  offsets and LRS (the replication layer itself is held to the JAX
  package in ``tests/test_torch_replication.py``).

Pinned divergences (each test named for it):
- a topic with deduplication: the JAX SPU attaches its dedup chain; the
  port's answers the produce with ``SMARTMODULE_ERROR``;
- a pushed source that names the JAX package: the JAX SPU runs it; the
  port's stream answers ``SMARTMODULE_INVALID``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fluvio_tpu import metadata as ref_metadata
from fluvio_tpu.client import ConsumerConfig as RefConsumerConfig
from fluvio_tpu.client import Fluvio as RefFluvio
from fluvio_tpu.client import Offset as RefOffset
from fluvio_tpu.client import PartitionSelectionStrategy as RefStrategy
from fluvio_tpu.client import ProducerConfig as RefProducerConfig
from fluvio_tpu.client.admin import AdminError as RefAdminError
from fluvio_tpu.metadata import topic as ref_topic
from fluvio_tpu.protocol import api as ref_api
from fluvio_tpu.protocol import codec as ref_codec
from fluvio_tpu.protocol import error as ref_error
from fluvio_tpu.protocol.error import FluvioError as RefFluvioError
from fluvio_tpu.sc import scheduler as ref_scheduler
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.sc.controllers import validate_topic_spec as ref_validate
from fluvio_tpu.sc.services import private_service as ref_private
from fluvio_tpu.sc.services import public_service as ref_public
from fluvio_tpu.schema import admin as ref_admin_schema
from fluvio_tpu.schema import controlplane as ref_controlplane
from fluvio_tpu.schema import smartmodule as ref_sm_schema
from fluvio_tpu_torch import interop
from fluvio_tpu_torch.client import (
    AdminError,
    ConsumerConfig,
    Fluvio,
    Offset,
    PartitionSelectionStrategy,
    ProducerConfig,
)
from fluvio_tpu_torch.metadata import topic as port_topic
from fluvio_tpu_torch.metadata.spu import SpuSpec
from fluvio_tpu_torch.protocol import api as port_api
from fluvio_tpu_torch.protocol import codec as port_codec
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.protocol.record import Batch, Record, RecordSet
from fluvio_tpu_torch.sc import ScContext
from fluvio_tpu_torch.sc import scheduler as port_scheduler
from fluvio_tpu_torch.sc.controllers import validate_topic_spec
from fluvio_tpu_torch.sc.services import private_service as port_private
from fluvio_tpu_torch.sc.services import public_service as port_public
from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.schema import admin as port_admin_schema
from fluvio_tpu_torch.schema import controlplane as port_controlplane
from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocation, SmartModuleInvocationWasm
from fluvio_tpu_torch.schema.spu import (
    Isolation,
    PartitionProduceData,
    ProduceRequest,
    TopicProduceData,
)
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket
from tests.test_replication import boot_cluster as boot_replicated_cluster
from tests.test_sc import boot_cluster, shutdown_cluster
from tests.test_torch_isolation import (
    CLUSTER_WAIT_S,
    boot_torch_cluster,
    gen_json,
    namespace_invocations,
    produce_all,
    replica_log,
    shutdown_torch_cluster,
    wait_for_module,
    wait_for_replicas,
)
from tests.test_torch_chain import _assert_equal, _port_buffer, _ref_buffer
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

# ---------------------------------------------------------------------------
# Schema encodings
# ---------------------------------------------------------------------------

_REF_MODULES = (ref_admin_schema, ref_controlplane, ref_error)


def to_ref(value):
    """A port schema value rebuilt from the JAX package's classes of the
    same names, field by field (enums by value)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = next(getattr(m, type(value).__name__) for m in _REF_MODULES
                   if hasattr(m, type(value).__name__))
        return cls(**{f.name: to_ref(getattr(value, f.name)) for f in dataclasses.fields(value)})
    if isinstance(value, enum.Enum):
        cls = next(getattr(m, type(value).__name__) for m in _REF_MODULES
                   if hasattr(m, type(value).__name__))
        return cls(value.value)
    if isinstance(value, list):
        return [to_ref(v) for v in value]
    if isinstance(value, dict):
        return {k: to_ref(v) for k, v in value.items()}
    return value


_text = st.text(max_size=10)
_i32 = st.integers(-(2**31), 2**31 - 1)
_i64 = st.integers(-(2**63), 2**63 - 1)
_json = st.dictionaries(
    st.text(max_size=6),
    st.one_of(st.none(), st.booleans(), _i32, st.text(max_size=6),
              st.lists(st.integers(0, 9), max_size=3)),
    max_size=4,
)
_code = st.sampled_from(list(ErrorCode))

A, C = port_admin_schema, port_controlplane
_admin_object = st.builds(A.AdminObject, name=_text, kind=_text, spec=_json, status=_json)
_replica = st.builds(C.Replica, topic=_text, partition=_i32, leader=_i32,
                     replicas=st.lists(_i32, max_size=4), is_being_deleted=st.booleans(),
                     config=_json)
_spu_update = st.builds(C.SpuUpdate, id=_i32, name=_text, public_addr=_text, private_addr=_text,
                        rack=_text)
_sm_update = st.builds(C.SmartModuleUpdate, name=_text, payload=st.binary(max_size=24))
_rs_update = st.builds(C.ReplicaStatusUpdate, spu=_i32, hw=_i64, leo=_i64)

SCHEMA_TYPES = {
    "AdminObject": _admin_object,
    "AdminStatus": st.builds(A.AdminStatus, name=_text, error_code=_code, error_message=_text),
    "CreateRequest": st.builds(A.CreateRequest, name=_text, kind=_text, spec=_json,
                               dry_run=st.booleans(), timeout_ms=_i32),
    "DeleteRequest": st.builds(A.DeleteRequest, name=_text, kind=_text),
    "ListResponse": st.builds(A.ListResponse, error_code=_code, error_message=_text,
                              objects=st.lists(_admin_object, max_size=3)),
    "ListRequest": st.builds(A.ListRequest, kind=_text, name_filters=st.lists(_text, max_size=3),
                             summary=st.booleans()),
    "WatchResponse": st.builds(A.WatchResponse, epoch=_i64,
                               all_objects=st.lists(_admin_object, max_size=2),
                               changes=st.lists(_admin_object, max_size=2),
                               deleted=st.lists(_text, max_size=3), is_sync_all=st.booleans(),
                               error_code=_code),
    "WatchRequest": st.builds(A.WatchRequest, kind=_text, summary=st.booleans()),
    "Replica": _replica,
    "SpuUpdate": _spu_update,
    "SmartModuleUpdate": _sm_update,
    "InternalUpdate": st.builds(C.InternalUpdate, kind=st.sampled_from(list(C.UpdateKind)),
                                epoch=_i64, sync_all=st.booleans(),
                                spus=st.lists(_spu_update, max_size=2),
                                replicas=st.lists(_replica, max_size=2),
                                smartmodules=st.lists(_sm_update, max_size=2),
                                deleted=st.lists(_text, max_size=2)),
    "RegisterSpuRequest": st.builds(C.RegisterSpuRequest, spu_id=_i32),
    "ReplicaStatusUpdate": _rs_update,
    "LrsStatus": st.builds(C.LrsStatus, topic=_text, partition=_i32, leader=_rs_update,
                           replicas=st.lists(_rs_update, max_size=3), size=_i64),
    "AckResponse": st.builds(C.AckResponse, error_code=_code),
    "UpdateLrsRequest": st.builds(C.UpdateLrsRequest, spu_id=_i32, updates=st.lists(
        st.builds(C.LrsStatus, topic=_text, partition=_i32, leader=_rs_update), max_size=3)),
    "ReplicaRemovedRequest": st.builds(C.ReplicaRemovedRequest, spu_id=_i32, topic=_text,
                                       partition=_i32, confirmed=st.booleans()),
}


def test_every_schema_type_is_drawn():
    """Every request and response type of both schema modules has a case."""
    for module in (port_admin_schema, port_controlplane):
        for name, cls in vars(module).items():
            if (isinstance(cls, type) and cls.__module__ == module.__name__
                    and issubclass(cls, port_api.Encodable)):
                assert name in SCHEMA_TYPES, name


def _encode(value, codec) -> bytes:
    w = codec.ByteWriter()
    value.encode(w, 0)
    return w.bytes()


@pytest.mark.parametrize("name", sorted(SCHEMA_TYPES))
def test_schema_encodes_byte_equal_to_the_reference(name):
    @settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(SCHEMA_TYPES[name])
    def check(value):
        ref = to_ref(value)
        got = _encode(value, port_codec)
        assert got == _encode(ref, ref_codec)
        back = type(value).decode(port_codec.ByteReader(got), 0)
        assert _encode(back, port_codec) == got
        if isinstance(value, port_api.ApiRequest):
            port_frame = port_api.RequestMessage.new_request(value).to_frame()
            assert port_frame == ref_api.RequestMessage.new_request(ref).to_frame()

    check()


# ---------------------------------------------------------------------------
# Scheduler and topic policy
# ---------------------------------------------------------------------------


def _spu_sets(seed: int):
    """Seeded SPU sets (ids, racks, some racks absent) with the scheduler's
    arguments, some of which must fail."""
    rng = random.Random(seed)
    for _ in range(12):
        n = rng.randint(0, 6)
        ids = rng.sample(range(100), n)
        racks = {i: rng.choice([None, "a", "b", "c"]) for i in ids}
        yield (ids, racks, rng.randint(-1, 5), rng.randint(-1, 4), rng.random() < 0.3,
               rng.choice([None, 0, rng.randint(0, 9)]))


def _replica_map(scheduler, spu_type, ids, racks, partitions, factor, ignore, start):
    spus = [spu_type(id=i, rack=racks[i]) for i in ids]
    try:
        return ("map", scheduler.generate_replica_map(spus, partitions, factor, ignore, start),
                scheduler.rack_interleaved_order(spus))
    except scheduler.SchedulingError as e:
        return ("error", str(e))


@pytest.mark.parametrize("seed", range(8))
def test_generate_replica_map_equals_the_reference(seed):
    errors = 0
    for ids, racks, partitions, factor, ignore, start in _spu_sets(seed):
        got = _replica_map(port_scheduler, SpuSpec, ids, racks, partitions, factor, ignore, start)
        want = _replica_map(ref_scheduler, ref_metadata.SpuSpec, ids, racks, partitions, factor,
                            ignore, start)
        assert got == want
        errors += got[0] == "error"
    assert 0 < errors < 12


def _topic_cases(t):
    """The cases of `tests/test_sc.py::TestTopicPolicy`, in the module ``t``."""
    return [
        ("t1", t.TopicSpec.computed(3)),
        ("bad name!", t.TopicSpec.computed(1)),
        ("", t.TopicSpec.computed(1)),
        ("-lead", t.TopicSpec.computed(1)),
        ("t", t.TopicSpec.computed(0)),
        ("t", t.TopicSpec(replicas=t.ReplicaSpec.assigned([t.PartitionMap(id=1, replicas=[0])]))),
        ("t", t.TopicSpec(replicas=t.ReplicaSpec.assigned([t.PartitionMap(id=0, replicas=[1, 1])]))),
        ("t", t.TopicSpec(replicas=t.ReplicaSpec.assigned([t.PartitionMap(id=0, replicas=[])]))),
        ("t", t.TopicSpec.computed(1, 0)),
        ("x" * 250, t.TopicSpec.computed(1)),
        ("a.b-C9", t.TopicSpec.computed(2, 2)),
    ]


@pytest.mark.parametrize("case", range(len(_topic_cases(port_topic))))
def test_validate_topic_spec_equals_the_reference(case):
    name, spec = _topic_cases(port_topic)[case]
    ref_name, ref_spec = _topic_cases(ref_topic)[case]
    assert validate_topic_spec(name, spec) == ref_validate(ref_name, ref_spec)


# ---------------------------------------------------------------------------
# The cluster: both packages through one sequence
# ---------------------------------------------------------------------------


def _run(coro, timeout: float = 90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _ref_invocations(invocations):
    out = []
    for inv in invocations:
        w = port_codec.ByteWriter()
        inv.encode(w)
        out.append(ref_sm_schema.SmartModuleInvocation.decode(ref_codec.ByteReader(w.bytes())))
    return out


class Side:
    """One package's cluster and client types, so one sequence drives
    both."""

    def __init__(self, port: bool):
        self.port = port
        self.topic = port_topic if port else ref_topic
        self.Fluvio = Fluvio if port else RefFluvio
        self.Offset = Offset if port else RefOffset
        self.ConsumerConfig = ConsumerConfig if port else RefConsumerConfig
        self.Strategy = PartitionSelectionStrategy if port else RefStrategy
        self.ProducerConfig = ProducerConfig if port else RefProducerConfig
        self.AdminError = AdminError if port else RefAdminError
        self.FluvioError = FluvioError if port else RefFluvioError

    async def boot(self, tmp_path, n_spus: int = 1, replicated: bool = False):
        """The side's cluster; ``replicated``: the JAX SPUs register
        their private addresses too (`tests/test_replication.py`'s
        `boot_cluster`), so a follower there syncs from its leader, as
        every port SPU's does."""
        if self.port:
            return await boot_torch_cluster(tmp_path / "port", n_spus, device="cpu")
        if replicated:
            return await boot_replicated_cluster(tmp_path / "ref", n_spus)
        return await boot_cluster(tmp_path / "ref", n_spus)

    async def shutdown(self, cluster):
        await (shutdown_torch_cluster if self.port else shutdown_cluster)(*cluster)

    def invocations(self, invocations):
        return list(invocations) if self.port else _ref_invocations(invocations)

    def config(self, invocations=()):
        return self.ConsumerConfig(disable_continuous=True,
                                   smartmodules=self.invocations(invocations))


SIDES = (Side(port=False), Side(port=True))


async def _status_code(side, call) -> int:
    try:
        status = await call
    except side.AdminError as e:
        status = e.status
    return int(status.error_code)


def _topic_view(obj):
    st_ = obj.status
    return (obj.key, st_.resolution.value, {int(k): list(v) for k, v in st_.replica_map.items()},
            st_.reason)


async def _admin_sequence(side, tmp_path):
    """Topics created, listed, refused and deleted through the admin API;
    a produce and a consume by name through SC routing; the LRS the SC
    holds after it."""
    sc, admin, spus = cluster = await side.boot(tmp_path)
    t = side.topic
    out = {}
    try:
        spec = t.TopicSpec.computed(1)
        spec.storage = t.TopicStorageConfig(segment_size=1 << 16)
        spec.retention_seconds = 3600
        out["create"] = await _status_code(side, admin.create_topic("events", spec))
        out["duplicate"] = await _status_code(side, admin.create_topic("events"))
        out["bad_name"] = await _status_code(side, admin.create_topic("bad topic!"))
        out["too_few_spus"] = await _status_code(side, admin.create(
            "wide", "topic", t.TopicSpec.computed(1, 2).to_dict(), timeout_ms=300))
        out["topics"] = sorted(_topic_view(o) for o in await admin.list_topics())
        out["partitions"] = sorted((o.key, o.spec.leader, list(o.spec.replicas))
                                   for o in await admin.list("partition"))
        await wait_for_replicas(spus[0], "events", [0])
        storage = spus[0].ctx.leader_for("events", 0).storage.config
        out["storage"] = (storage.segment_max_bytes, storage.retention_seconds)
        modules, invocations = namespace_invocations("north_star")
        for name, source in modules:
            await admin.create_smartmodule(name, source)
        for name, _ in modules:
            await wait_for_module(spus[0], name)
        client = await side.Fluvio.connect(sc.public_addr)
        try:
            values = gen_json(300, seed=71)
            items = [(None if i % 3 else b"k%d" % i, v) for i, v in enumerate(values)]
            out["offsets"] = await produce_all(client, "events", items)
            consumer = await client.partition_consumer("events", 0)
            for label, invs in (("plain", ()), ("by_name", invocations)):
                out[label] = [(r.offset, r.key, bytes(r.value)) async for r in
                              consumer.stream(side.Offset.beginning(), side.config(invs))]
        finally:
            await client.close()
        obj = await sc.ctx.partitions.wait_action(
            "events-0", lambda o: o is not None and o.status.leader.leo == 300,
            timeout=CLUSTER_WAIT_S)
        out["lrs"] = (obj.status.leader.spu, obj.status.leader.hw, obj.status.leader.leo)
        out["delete"] = await _status_code(side, admin.delete_topic("events"))
        out["after_delete"] = (sorted(o.key for o in await admin.list_topics()),
                               sorted(o.key for o in await admin.list("partition")))
    finally:
        await side.shutdown(cluster)
    return out


def test_admin_produce_and_consume_by_name_equal_the_reference(tmp_path):
    ref = _run(_admin_sequence(SIDES[0], tmp_path))
    got = _run(_admin_sequence(SIDES[1], tmp_path))
    assert got == ref
    assert got["duplicate"] == ErrorCode.TOPIC_ALREADY_EXISTS
    assert got["bad_name"] == ErrorCode.TOPIC_INVALID_CONFIGURATION
    assert got["too_few_spus"] == ErrorCode.NONE  # parked PENDING, as the reference does
    assert ("wide", "pending", {}, "waiting for SPUs") in got["topics"]
    assert got["offsets"] == [(0, i) for i in range(300)]
    assert 0 < len(got["by_name"]) < 300 and got["lrs"] == (5000, 300, 300)
    assert got["after_delete"] == (["wide"], [])
    assert got["storage"] == (1 << 16, 3600)


def test_sc_starts_without_a_card_and_builds_no_engine(tmp_path, monkeypatch):
    """The SC is host code: with no CUDA and every SmartEngine
    construction failing, it starts, provisions a topic and stops."""
    import torch

    from fluvio_tpu_torch.client import FluvioAdmin
    from fluvio_tpu_torch.sc import ScServer
    from fluvio_tpu_torch.smartengine import engine

    def no_engine(*args, **kw):
        raise AssertionError("the SC built a SmartEngine")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine.SmartEngine, "__init__", no_engine)

    async def body():
        sc = ScServer()
        await sc.start()
        try:
            admin = await FluvioAdmin.connect(sc.public_addr)
            try:
                await admin.register_custom_spu(7, "127.0.0.1:1")
                await admin.create_topic("t", port_topic.TopicSpec.computed(2), timeout_ms=100)
                return [(o.key, o.status.resolution.value) for o in await admin.list_topics()]
            finally:
                await admin.close()
        finally:
            await sc.stop()

    assert _run(body()) == [("t", "pending")]  # the SPU never registered


async def _merged_sequence(side, tmp_path):
    """A 2-partition topic produced keyed, consumed merged plain and
    through `3_aggregate`'s chain by name: each partition's records in the
    order they arrived."""
    sc, admin, spus = cluster = await side.boot(tmp_path)
    out = {}
    try:
        await admin.create_topic("multi", side.topic.TopicSpec.computed(2))
        await wait_for_replicas(spus[0], "multi", [0, 1])
        modules, invocations = namespace_invocations("3_aggregate")
        for name, source in modules:
            await admin.create_smartmodule(name, source)
        await wait_for_module(spus[0], modules[0][0])
        client = await side.Fluvio.connect(sc.public_addr)
        try:
            values = gen_json(400, seed=72)
            out["offsets"] = await produce_all(
                client, "multi", [(b"key-%d" % (i % 37), v) for i, v in enumerate(values)],
                side.ProducerConfig(batch_size=2048))
            consumer = await client.consumer(side.Strategy.all("multi"))
            out["consumers"] = len(consumer.consumers)
            for label, invs in (("plain", ()), ("aggregate", invocations)):
                parts = {}
                async for r in consumer.stream(side.Offset.beginning(), side.config(invs)):
                    parts.setdefault(r.partition, []).append((r.offset, r.key, bytes(r.value)))
                out[label] = parts
        finally:
            await client.close()
        for p in (0, 1):
            leo = sum(1 for q, _ in out["offsets"] if q == p)
            obj = await sc.ctx.partitions.wait_action(
                f"multi-{p}", lambda o, leo=leo: o is not None and o.status.leader.leo == leo,
                timeout=CLUSTER_WAIT_S)
            out[f"lrs-{p}"] = obj.status.leader.leo
    finally:
        await side.shutdown(cluster)
    return out


def test_merged_two_partition_stream_equals_the_reference(tmp_path):
    ref = _run(_merged_sequence(SIDES[0], tmp_path))
    got = _run(_merged_sequence(SIDES[1], tmp_path))
    assert got == ref
    assert got["consumers"] == 2 and set(got["plain"]) == {0, 1}
    for p, records in got["plain"].items():
        assert [o for o, _, _ in records] == list(range(len(records)))
        assert len(got["aggregate"][p]) == len(records)
    assert sorted(v for r in got["plain"].values() for _, _, v in r) == sorted(
        gen_json(400, seed=72))


def test_port_sc_seeded_from_the_reference_answers_alike(tmp_path):
    """`interop.metadata_from_reference` carries the JAX SC's stores into
    a port `ScContext`: its List answers and its replica pushes are the
    JAX SC's bytes."""

    async def body():
        sc, admin, spus = cluster = await boot_cluster(tmp_path, 2)
        try:
            await admin.create_topic("seeded", ref_topic.TopicSpec.computed(3))
            await admin.create_topic("pair", ref_topic.TopicSpec.computed(2, 2))
            await admin.create_smartmodule("m", b"payload")
            ctx = ScContext()
            for kind in ("spu", "topic", "partition", "smartmodule"):
                store = sc.ctx.store_for(kind).store
                for obj in interop.metadata_from_reference(o.to_dict() for o in store.values()):
                    ctx.store_for(kind).store.apply(obj)
            for kind in ("spu", "custom-spu", "topic", "partition", "smartmodule"):
                port = port_public.handle_list(ctx, port_admin_schema.ListRequest(kind=kind))
                ref = ref_public.handle_list(sc.ctx, ref_admin_schema.ListRequest(kind=kind))
                assert ref.objects and _encode(port, port_codec) == _encode(ref, ref_codec)
            for spu_id in (5000, 5001):
                port = port_controlplane.InternalUpdate(
                    kind=port_controlplane.UpdateKind.REPLICA, sync_all=True,
                    replicas=port_private.replicas_for_spu(ctx, spu_id))
                ref = ref_controlplane.InternalUpdate(
                    kind=ref_controlplane.UpdateKind.REPLICA, sync_all=True,
                    replicas=ref_private.replicas_for_spu(sc.ctx, spu_id))
                assert len(port.replicas) >= 3
                assert _encode(port, port_codec) == _encode(ref, ref_codec)
            for updates in (port_private.spu_updates, port_private.smartmodule_updates):
                ref_fn = getattr(ref_private, updates.__name__)
                assert [_encode(u, port_codec) for u in updates(ctx)] == [
                    _encode(u, ref_codec) for u in ref_fn(sc.ctx)]
        finally:
            await shutdown_cluster(*cluster)

    _run(body())


# ---------------------------------------------------------------------------
# Pinned divergences
# ---------------------------------------------------------------------------


async def _produce_direct(addr: str, topic: str, partition: int, values,
                          isolation=Isolation.READ_UNCOMMITTED) -> tuple:
    """One ProduceRequest straight to an SPU, its batch stamped 1,000:
    (error code, base offset, error message)."""
    socket = await VersionedSerialSocket.connect(addr)
    try:
        records = RecordSet().add(Batch.from_records(
            [Record(value=v) for v in values], first_timestamp=1_000))
        resp = await socket.send_receive(ProduceRequest(isolation=isolation, topics=[
            TopicProduceData(name=topic, partitions=[PartitionProduceData(partition, records)])]))
        p = resp.find_partition(topic, partition)
        return ErrorCode(p.error_code), p.base_offset, p.error_message
    finally:
        await socket.close()


async def _until(predicate, what: str, timeout: float = CLUSTER_WAIT_S):
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.02)


ASSIGNED = [(0, [5001, 5000]), (1, [5000])]


async def _assigned_sequence(side, tmp_path):
    """Two SPUs; topic ``assigned`` places partition 0 on [5001, 5000] (SPU
    5001 leads a replica set of two, 5000 follows it) and partition 1 on
    [5000]. Produces straight to each SPU (READ_COMMITTED to the leader of
    two); then each replica's role, quorum, offsets and stored bytes, and
    the SC's LRS."""
    sc, admin, (a, b) = cluster = await side.boot(tmp_path, 2, replicated=True)
    t, out = side.topic, {}
    try:
        spec = t.TopicSpec(replicas=t.ReplicaSpec.assigned(
            [t.PartitionMap(id=i, replicas=r) for i, r in ASSIGNED]))
        await admin.create_topic("assigned", spec)
        await _until(lambda: b.ctx.leader_for("assigned", 0) is not None
                     and a.ctx.follower_for("assigned", 0) is not None
                     and a.ctx.leader_for("assigned", 1) is not None, "replicas")
        out["roles"] = [(sorted(s_.ctx.leaders), sorted(s_.ctx.followers)) for s_ in (a, b)]
        out["quorum"] = b.ctx.leader_for("assigned", 0).in_sync_replica
        values = [b"v-%d" % i for i in range(7)]
        out["produce"] = [
            (await _produce_direct(spu.public_addr, "assigned", p, values, iso))[:2]
            for spu, p, iso in ((a, 0, Isolation.READ_UNCOMMITTED),
                                (b, 0, Isolation.READ_COMMITTED),
                                (a, 1, Isolation.READ_UNCOMMITTED))]
        leader, follower = b.ctx.leader_for("assigned", 0), a.ctx.follower_for("assigned", 0)
        out["acked_hw"] = leader.hw()
        await _until(lambda: follower.hw() == len(values), "follower HW")
        out["offsets"] = [(r.leo(), r.hw()) for r in (leader, follower)]
        logs = [replica_log(r.storage) for r in (leader, follower)]
        assert logs[0] == logs[1]  # the follower holds the leader's bytes
        out["log"] = logs[0]
        obj = await sc.ctx.partitions.wait_action(
            "assigned-0", lambda o: o is not None and [r.hw for r in o.status.replicas] == [7],
            timeout=CLUSTER_WAIT_S)
        st_ = obj.status
        out["lrs"] = (st_.leader.spu, st_.leader.hw, st_.leader.leo,
                      [(r.spu, r.leo, r.hw) for r in st_.replicas], st_.lsr)
    finally:
        await side.shutdown(cluster)
    return out


def test_follower_assignment_equals_the_reference(tmp_path):
    """Topic ``assigned`` on [5001, 5000] and [5000]: both packages'
    SPUs serve the leader of two and its follower alike. A produce to the
    follower answers NOT_LEADER_FOR_PARTITION; a READ_COMMITTED produce to
    the leader is answered once the follower holds the records; the
    follower's log is the leader's bytes, and the SC's LRS lists it in
    sync."""
    ref = _run(_assigned_sequence(SIDES[0], tmp_path))
    got = _run(_assigned_sequence(SIDES[1], tmp_path))
    assert got == ref
    assert got["roles"] == [(["assigned-1"], ["assigned-0"]), (["assigned-0"], [])]
    assert got["quorum"] == 2 and got["acked_hw"] == 7
    assert got["produce"] == [(ErrorCode.NOT_LEADER_FOR_PARTITION, -1), (ErrorCode.NONE, 0),
                              (ErrorCode.NONE, 0)]
    assert got["offsets"] == [(7, 7), (7, 7)]
    assert got["lrs"] == (5001, 7, 7, [(5000, 7, 7)], 2)


DEDUP_VALUES = [b"a", b"b", b"a", b"c", b"b", b"d"]


def _dedup(t, spec) -> None:
    spec.deduplication = t.Deduplication(
        bounds=t.Bounds(count=8), filter=t.Filter(transform=t.Transform(uses="dedup-filter")))


async def _configured_topic_sequence(side, tmp_path, configure, values=DEDUP_VALUES):
    """Topic ``configured`` created with ``configure(topic module, spec)``
    applied, then ``values`` produced to it through SC routing: the
    outcome (offsets, or the error), the records the leader stored and
    its storage's segment size, retention window and partition size."""
    sc, admin, spus = cluster = await side.boot(tmp_path)
    t = side.topic
    try:
        spec = t.TopicSpec.computed(1)
        configure(t, spec)
        await admin.create_topic("configured", spec)
        await wait_for_replicas(spus[0], "configured", [0])
        client = await side.Fluvio.connect(sc.public_addr)
        try:
            try:
                offsets = await produce_all(client, "configured", [(None, v) for v in values])
                outcome = ("ok", offsets)
            except side.FluvioError as e:
                outcome = ("error", int(e.code), str(e))
            leader = spus[0].ctx.leader_for("configured", 0)
            config = leader.storage.config
            stored = leader.leo()
        finally:
            await client.close()
    finally:
        await side.shutdown(cluster)
    return (outcome, stored,
            (config.segment_max_bytes, config.retention_seconds, config.max_partition_size))


def test_dedup_topic_divergence_is_pinned(tmp_path):
    """A topic whose config deduplicates through ``dedup-filter``: the JAX
    SPU attaches the filter (seeded by a look-back) to the leader and
    stores the first of each value; the port's answers the produce with
    SMARTMODULE_ERROR, the code a stream with that module gets, and
    stores nothing."""
    ref_outcome, ref_stored, _ = _run(_configured_topic_sequence(SIDES[0], tmp_path, _dedup))
    outcome, stored, _ = _run(_configured_topic_sequence(SIDES[1], tmp_path, _dedup))
    assert ref_outcome[0] == "ok" and ref_stored == 4
    assert outcome[:2] == ("error", ErrorCode.SMARTMODULE_ERROR) and "dedup-filter" in outcome[2]
    assert stored == 0


def _retention(t, spec) -> None:
    spec.retention_seconds = 3600


def _max_partition_size(t, spec) -> None:
    spec.storage = t.TopicStorageConfig(segment_size=1 << 16, max_partition_size=1 << 30)


@pytest.mark.parametrize("configure, storage", [
    (_retention, (1 << 30, 3600, None)),
    (_max_partition_size, (1 << 16, 7 * 24 * 3600, 1 << 30)),
], ids=["retention_seconds", "max_partition_size"])
def test_retention_topic_equals_the_reference(tmp_path, configure, storage):
    """A topic that sets a retention window or a partition size: both
    packages' SPUs store the records (their cleaners drop old segments by
    the setting; none here: an hour, a GiB) and give the leader's storage
    the setting."""
    ref = _run(_configured_topic_sequence(SIDES[0], tmp_path, configure))
    got = _run(_configured_topic_sequence(SIDES[1], tmp_path, configure))
    assert got == ref
    assert got[0] == ("ok", [(0, i) for i in range(len(DEDUP_VALUES))])
    assert got[1:] == (len(DEDUP_VALUES), storage)


JAX_SDK_SOURCE = (
    b"from fluvio_tpu.smartmodule.sdk import smartmodule\n"
    b"@smartmodule.filter\n"
    b"def fil(record):\n"
    b"    return b'keep' in bytes(record.value)\n"
)


async def _jax_source_sequence(side, tmp_path):
    sc, admin, spus = cluster = await side.boot(tmp_path)
    try:
        await admin.create_topic("src")
        await admin.create_smartmodule("keeper", JAX_SDK_SOURCE)
        await wait_for_replicas(spus[0], "src", [0])
        await wait_for_module(spus[0], "keeper")
        client = await side.Fluvio.connect(sc.public_addr)
        try:
            await produce_all(client, "src", [(None, b"keep-%d" % i if i % 2 else b"drop")
                                              for i in range(6)])
            consumer = await client.partition_consumer("src", 0)
            inv = [SmartModuleInvocation(wasm=SmartModuleInvocationWasm.predefined("keeper"))]
            try:
                return ("ok", [bytes(r.value) async for r in
                               consumer.stream(side.Offset.beginning(), side.config(inv))])
            except side.FluvioError as e:
                return ("error", int(e.code), e.message)
        finally:
            await client.close()
    finally:
        await side.shutdown(cluster)


def test_source_naming_the_jax_package_divergence_is_pinned(tmp_path):
    """A pushed source that imports the JAX package's SDK, as the sources
    `tests/test_sc.py` pushes do: the JAX SPU runs it; the port's never
    imports that package and answers the stream with SMARTMODULE_INVALID,
    naming the cause."""
    ref = _run(_jax_source_sequence(SIDES[0], tmp_path))
    got = _run(_jax_source_sequence(SIDES[1], tmp_path))
    assert ref == ("ok", [b"keep-1", b"keep-3", b"keep-5"])
    assert got[:2] == ("error", ErrorCode.SMARTMODULE_INVALID)
    assert "fluvio_tpu" in got[2] and "namespace form" in got[2]


NAMING_FILTER = (
    b"# written first for fluvio_tpu; matches the name fluvio_tpu\n"
    b"@smartmodule.filter(dsl=dsl.FilterProgram(predicate=dsl.Contains(\n"
    b"    arg=dsl.Value(), literal=b'fluvio_tpu')))\n"
    b"def fil(record):\n"
    b"    '''keeps records naming fluvio_tpu'''\n"
    b"    return b'fluvio_tpu' in bytes(record.value)\n"
)


@pytest.mark.parametrize("head, refused", [
    (b"", False),
    (b"import fluvio_tpu\n", True),
    (b"import fluvio_tpu.smartmodule.sdk as sdk\n", True),
    (b"from fluvio_tpu.smartmodule import dsl as ref_dsl\n", True),
    (b"sdk = __import__('fluvio_tpu.smartmodule.sdk')\n", True),
    (b"import fluvio_tpu_torch\n", False),
    (b"import json\n", False),
], ids=["mentions_only", "import", "import_submodule", "from_import", "dunder_import",
        "port_import", "stdlib_import"])
def test_load_source_refuses_exactly_imports_of_the_jax_package(head, refused):
    """The refusal is the import itself, not the name in the text: a
    namespace-form source that only mentions ``fluvio_tpu`` in a comment,
    a docstring or a literal loads in both packages and keeps the same
    records; any import of the JAX package or its submodules, dynamic
    ones included, raises ``ValueError`` naming the module."""
    from fluvio_tpu.smartmodule.sdk import load_source as ref_load_source
    from fluvio_tpu_torch.smartmodule.sdk import load_source

    source = head + NAMING_FILTER
    if refused:
        with pytest.raises(ValueError, match=r"fluvio_tpu\b.*namespace form"):
            load_source(source, name="naming")
        return
    port = load_source(source, name="naming")
    ref = ref_load_source(source, name="naming")
    assert port.transform_kind().value == ref.transform_kind().value == "filter"
    ref_buf = _ref_buffer([b'{"name":"fluvio_tpu"}', b'{"name":"fluvio"}', b"fluvio_tpu_torch"])
    ref_chain = RefEngine(backend="tpu").builder().add_smart_module(
        RefConfig(), ref).initialize().tpu_chain
    chain = SmartEngine(device="cpu").builder().add_smart_module(
        SmartModuleConfig(), port).initialize().gpu_chain
    (ref_out,), (out,) = ref_chain.process_stream([ref_buf]), chain.process_stream(
        [_port_buffer(ref_buf)])
    _assert_equal(ref_out, out)
    assert out.value_list() == [b'{"name":"fluvio_tpu"}', b"fluvio_tpu_torch"]
