"""The port's durable, secure cluster against the JAX package's, on the
CPU (tolerance 0).

- TLS (`transport/tls.py`): a port SPU's public endpoint in verified and
  anonymous mode, a plaintext client refused, mTLS without a CA refused,
  the client certificate's x509 identity; the port's client to a JAX SC
  and the JAX package's client to a port SPU, both over TLS. The
  certificates are the committed test material under ``tests/data/tls``.
- `metadata/yaml_subset.py`: ``yaml.safe_dump`` of hypothesis-drawn
  documents of the subset reads back as ``yaml.safe_load`` reads it, and
  what the port writes ``yaml.safe_load`` reads back to the document;
  every metadata kind's ``to_dict()`` round-trips across the packages;
  anchors, aliases, tags, block and multi-line scalars raise.
- The profile file (`client/config.py`): written by either package, read
  by the other; ``Fluvio.connect()`` with no address takes its endpoint
  and TLS policy.
- Persistent SC metadata (`metadata/client.py`, `metadata/dispatcher.py`):
  the port's counterpart of ``tests/test_sc.py``'s
  ``test_metadata_survives_sc_restart``, the port's SC restarted from a
  directory the JAX SC wrote, and the JAX SC from one the port wrote.
- Authorization: the read-only, root and RBAC decisions over a table of
  (identity, action, object type) equal the JAX package's, and a refused
  admin request answers the JAX SC's status.
- Phase 17 of ``chip_smoke.py`` at a small size on the CPU.

Pinned divergences (reference faults, `ROADMAP.md` §3): an SC with
``auth_policy_path`` judges each connection by its client certificate in
the port; the JAX SC passes its policy no authenticator, so every
connection is anonymous there and a certificate the policy names is
refused (`test_rbac_by_certificate_divergence_is_pinned`). The JAX
client's ``admin()`` dials a TLS SC without its TLS policy and is
refused; the port's passes it (`test_admin_over_tls_divergence_is_pinned`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import json
import math

import pytest
import yaml
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from fluvio_tpu import auth as ref_auth
from fluvio_tpu.client import ConsumerConfig as RefConsumerConfig
from fluvio_tpu.client import Fluvio as RefFluvio
from fluvio_tpu.client import Offset as RefOffset
from fluvio_tpu.client import TlsPolicy as RefTlsPolicy
from fluvio_tpu.client import config as ref_config
from fluvio_tpu.client.admin import AdminError as RefAdminError
from fluvio_tpu.client.admin import FluvioAdmin as RefFluvioAdmin
from fluvio_tpu.metadata.topic import TopicSpec as RefTopicSpec
from fluvio_tpu.sc import ScConfig as RefScConfig
from fluvio_tpu.sc import ScServer as RefScServer
from fluvio_tpu.transport import tls as ref_tls
from fluvio_tpu.transport.versioned import VersionedSerialSocket as RefSocket
from fluvio_tpu_torch import auth
from fluvio_tpu_torch.client import AdminError, ConsumerConfig, Fluvio, FluvioAdmin, Offset
from fluvio_tpu_torch.client import config as port_config
from fluvio_tpu_torch.metadata import yaml_subset
from fluvio_tpu_torch.metadata.topic import TopicSpec
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.sc import ScConfig, ScServer
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.server import SpuServer
from fluvio_tpu_torch.storage.config import ReplicaConfig
from fluvio_tpu_torch.transport import tls as port_tls
from fluvio_tpu_torch.transport.socket import SocketClosed
from tests.test_sc import boot_cluster, shutdown_cluster
from tests.test_torch_isolation import (
    CLUSTER_WAIT_S,
    _secure_cluster_sequence,
    boot_torch_cluster,
    client_tls,
    cluster_snapshot,
    gen_json,
    rbac_policy,
    secure_sc_config,
    server_tls,
    shutdown_torch_cluster,
    tls_files,
    wait_for_module,
    wait_for_replicas,
    write_profile,
    write_rbac_policy,
)
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

REFUSED = (ConnectionError, OSError, EOFError, asyncio.TimeoutError, asyncio.IncompleteReadError,
           SocketClosed)


def run(coro, timeout: float = 120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _tls_spu(tmp_path, require_client_cert: bool = False) -> SpuServer:
    config = SpuConfig(public_addr="127.0.0.1:0", log_base_dir=str(tmp_path),
                       replication=ReplicaConfig(base_dir=str(tmp_path)),
                       private_addr="", cleaner_interval_seconds=0,
                       tls=server_tls(port_tls.ServerTlsConfig, require_client_cert))
    config.smart_engine.device = "cpu"
    return SpuServer(config)


def _addr(server) -> str:
    # bound on 127.0.0.1; dialled by the certificate's DNS name
    return "localhost:" + server.public_addr.rsplit(":", 1)[1]


async def _produce_and_consume(client, topic: str, values, consumer_config, offset_cls):
    producer = await client.topic_producer(topic)
    futs = [await producer.send(None, v) for v in values]
    await producer.flush()
    for f in futs:
        await f.wait()
    consumer = await client.partition_consumer(topic, 0)
    return [r.value async for r in consumer.stream(offset_cls.beginning(), consumer_config)]


# -- TLS ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["verified", "anonymous", "client_certificate"])
def test_tls_spu_round_trip_and_the_client_identity(mode, tmp_path):
    values = [f"tls-{i}".encode() for i in range(20)]
    seen = {}

    async def body():
        server = _tls_spu(tmp_path, require_client_cert=mode == "client_certificate")
        service = server.public_server.service
        respond = service.respond

        async def spy(ctx, socket):
            seen["identity"] = auth.Identity.from_socket(socket)
            await respond(ctx, socket)

        service.respond = spy
        await server.start()
        try:
            server.ctx.create_replica("topic", 0)
            tls = {"verified": client_tls(port_config.TlsPolicy, None),
                   "anonymous": port_config.TlsPolicy(mode="anonymous"),
                   "client_certificate": client_tls(port_config.TlsPolicy, "admin")}[mode]
            client = await Fluvio.connect(_addr(server), tls=tls)
            try:
                return await _produce_and_consume(
                    client, "topic", values, ConsumerConfig(disable_continuous=True), Offset)
            finally:
                await client.close()
        finally:
            await server.stop()

    assert run(body()) == values
    ident = seen["identity"]
    if mode == "client_certificate":
        assert (ident.principal, ident.scopes) == ("alice", ["admins"])
    else:
        assert (ident.principal, ident.scopes) == ("anonymous", [])


@pytest.mark.parametrize("endpoint", ["spu", "sc"])
def test_a_plaintext_client_is_refused_by_a_tls_endpoint(endpoint, tmp_path):
    async def body():
        server = (_tls_spu(tmp_path) if endpoint == "spu"
                  else ScServer(secure_sc_config(tmp_path)))
        await server.start()
        try:
            with pytest.raises(REFUSED):
                await asyncio.wait_for(Fluvio.connect(server.public_addr), 5)
        finally:
            await server.stop()

    run(body())


def test_mtls_without_a_ca_raises_in_both_packages():
    f = tls_files()
    for tls, cfg in ((port_tls, port_tls.ServerTlsConfig), (ref_tls, ref_tls.ServerTlsConfig)):
        with pytest.raises(ValueError, match="ca_cert"):
            tls.server_ssl(cfg(enabled=True, server_cert=f["server_cert"],
                               server_key=f["server_key"], require_client_cert=True))
        assert tls.server_ssl(cfg()) is None


def test_the_port_client_to_a_jax_sc_over_tls(tmp_path):
    """The port's client (SC mode, its admin API) dials a JAX SC whose
    public endpoint speaks TLS."""
    async def body():
        sc = RefScServer(RefScConfig(tls=server_tls(ref_tls.ServerTlsConfig)))
        await sc.start()
        try:
            client = await Fluvio.connect(sc.public_addr,
                                          tls=client_tls(port_config.TlsPolicy, "admin"))
            try:
                admin = await client.admin()
                await admin.create_topic("tls-topic", TopicSpec.computed(2))
                listed = [t.key for t in await admin.list_topics()]
                await admin.close()
            finally:
                await client.close()
            return listed, sorted(o.key for o in sc.ctx.topics.store.values())
        finally:
            await sc.stop()

    listed, stored = run(body())
    assert listed == stored == ["tls-topic"]


def test_the_jax_client_to_a_port_spu_over_tls(tmp_path):
    values = [f"ref-{i}".encode() for i in range(20)]

    async def body():
        server = _tls_spu(tmp_path)
        await server.start()
        try:
            leader = server.ctx.create_replica("topic", 0)
            client = await RefFluvio.connect(_addr(server),
                                             tls=client_tls(RefTlsPolicy, "admin"))
            try:
                got = await _produce_and_consume(
                    client, "topic", values, RefConsumerConfig(disable_continuous=True),
                    RefOffset)
            finally:
                await client.close()
            return got, leader.leo()
        finally:
            await server.stop()

    got, leo = run(body())
    assert got == values and leo == len(values)


# -- the YAML subset ----------------------------------------------------------

_KEYS = st.one_of(st.text("abcxyz019 -_", min_size=1, max_size=6), st.integers(-99, 99))
_TEXT = st.text(st.sampled_from(list("abz09 -_:#'\"\\/.,!?{}[]&*@%|>~\t") +
                                ["\u00e9", "\u4e2d", "\U0001f600", "\x7f", "\x85", "\u2028"]),
                max_size=4)
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
                     st.floats(allow_nan=False, allow_infinity=False), _TEXT,
                     st.sampled_from(["yes", "no", "on", "0x1f", "1e5", "0o7", "1_000", ".5",
                                      "2024-01-02", "null", "~", "-", "- a", "a: b", "a #b"]))
_DOCS = st.recursive(_SCALARS, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_KEYS, inner, max_size=4)), max_leaves=12)


def _json_form(doc):
    """``doc`` as JSON gives it back: int keys as strings."""
    return json.loads(json.dumps(doc))


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(doc=_DOCS)
def test_the_subset_reads_what_safe_dump_writes(doc):
    text = yaml.safe_dump(doc, sort_keys=False)
    # a scalar folded over lines is outside the subset: keep the drawn
    # documents that the default width does not fold
    assume(text == yaml.safe_dump(doc, sort_keys=False, width=math.inf))
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(doc=_DOCS)
def test_what_the_subset_writes_safe_load_reads(doc):
    text = yaml_subset.dumps(doc, sort_keys=False)
    assert yaml.safe_load(text) == yaml_subset.loads(text) == _json_form(doc)


def _metadata_samples(pkg: str):
    """One object of every metadata kind, each with non-default fields,
    built from package ``pkg``'s own classes: [(spec class, object)]."""
    md = {m: importlib.import_module(f"{pkg}.metadata.{m}")
          for m in ("topic", "partition", "spu", "spg", "smartmodule", "tableformat")}
    core = importlib.import_module(f"{pkg}.stream_model.core")
    t, p, s = md["topic"], md["partition"], md["spu"]
    obj = core.MetadataStoreObject
    topic = t.TopicSpec(replicas=t.ReplicaSpec.assigned(
        [t.PartitionMap(id=0, replicas=[5001, 5000]), t.PartitionMap(id=1, replicas=[5000])]),
        retention_seconds=3600, compression_type="lz4",
        storage=t.TopicStorageConfig(segment_size=1 << 20))
    sm = md["smartmodule"]
    return [
        (t.TopicSpec, obj("events", topic, t.TopicStatus(
            resolution=t.TopicResolution.PROVISIONED, replica_map={0: [5001, 5000], 1: [5000]},
            reason="provisioned: 2 partitions"), revision=3)),
        (t.TopicSpec, obj("pending", t.TopicSpec.computed(2), t.TopicStatus(
            resolution=t.TopicResolution.PENDING, reason="waiting for SPUs"))),
        (p.PartitionSpec, obj("events-0", p.PartitionSpec(
            leader=5001, replicas=[5001, 5000], retention_seconds=3600,
            compression_type="snappy"), p.PartitionStatus(
            resolution=p.PartitionResolution.ONLINE, leader=p.ReplicaStatus(5001, 10, 12),
            replicas=[p.ReplicaStatus(5000, 10, 11)], lsr=2, size=4096))),
        (s.SpuSpec, obj("5000", s.SpuSpec(
            id=5000, public_endpoint=s.Endpoint("127.0.0.1", 9010),
            private_endpoint=s.Endpoint("localhost", 9011), rack="rack-1"),
            s.SpuStatus(resolution=s.SpuResolution.ONLINE))),
        (md["spg"].SpuGroupSpec, obj("main", md["spg"].SpuGroupSpec(
            replicas=3, min_id=6000, spu_config=md["spg"].SpuGroupConfig(
                storage_size=1 << 30, log_base_dir="/var/lib/fluvio")))),
        (sm.SmartModuleSpec, obj("keeper", sm.SmartModuleSpec.from_source(
            b"from smartmodule import dsl\n\n# keep it: 'all' of it\n" * 8, name="keeper"))),
        (md["tableformat"].TableFormatSpec, obj("tf", md["tableformat"].TableFormatSpec(
            name="tf", columns=[md["tableformat"].TableFormatColumnConfig(
                key_path="/name", header="Name", width=12, primary_key=True)],
            smartmodule="keeper"))),
    ]


@pytest.mark.parametrize("kind", range(len(_metadata_samples("fluvio_tpu_torch"))))
def test_every_metadata_kind_round_trips_across_the_packages(kind):
    """The JAX store's file (``yaml.safe_dump(sort_keys=True)``) reads into
    the port's object; the port's file reads into the JAX package's; the
    plain dicts equal throughout."""
    from fluvio_tpu.stream_model.core import MetadataStoreObject as RefObject
    from fluvio_tpu_torch.stream_model.core import MetadataStoreObject as PortObject

    ref_spec, ref_obj = _metadata_samples("fluvio_tpu")[kind]
    port_spec, port_obj = _metadata_samples("fluvio_tpu_torch")[kind]
    assert ref_obj.to_dict() == port_obj.to_dict()
    ref_text = yaml.safe_dump(ref_obj.to_dict(), sort_keys=True)
    assert yaml_subset.loads(ref_text) == yaml.safe_load(ref_text)
    assert PortObject.from_dict(port_spec, yaml_subset.loads(ref_text)).to_dict() == \
        port_obj.to_dict()
    port_text = yaml_subset.dumps(port_obj.to_dict(), sort_keys=True)
    assert RefObject.from_dict(ref_spec, yaml.safe_load(port_text)).to_dict() == \
        ref_obj.to_dict()


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: *x\n", "a: |\n  text\n", "a: >\n  text\n", "a: !!str 1\n",
    "a: folded plain\n  scalar\n", "a: 'quoted\n  over lines'\n", "a: \"quoted \\\n  on\"\n",
    "a: {b: 1}\n", "a: [1, 2]\n", "a: 1 # note\n", "? complex\n: key\n", "a: 1\n---\nb: 2\n",
    "a:\n\tb: 1\n", "a: 1e5x: 2\n", '{"a": 1e5}', '{"a": NaN}', "a: .inf\n", "a: 0x1f\n",
    "a: yes\n", "a: 2024-01-02\n",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.loads(text)


@pytest.mark.parametrize("value", [math.inf, -math.inf, math.nan, {1.5: 1}, {True: 1},
                                   b"bytes", {"a": object()}])
def test_the_writer_refuses_what_it_cannot_write(value):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.dumps(value)


# -- the profile --------------------------------------------------------------


def _profile_config(cfg_module):
    cfg = cfg_module.Config()
    f = tls_files()
    cfg.add_cluster("secure", cfg_module.FluvioClusterConfig(
        endpoint="127.0.0.1:9003", tls=cfg_module.TlsPolicy(
            mode="verified", domain="localhost", ca_cert=f["ca"],
            client_cert=f["admin_cert"], client_key=f["admin_key"])))
    cfg.add_cluster("anon", cfg_module.FluvioClusterConfig(
        endpoint="sc.example:9003", tls=cfg_module.TlsPolicy(mode="anonymous", domain="sc")),
        make_current=False)
    cfg.add_cluster("plain", cfg_module.FluvioClusterConfig(endpoint="localhost:9003"),
                    make_current=False)
    cfg.profiles["local"] = cfg.profiles.pop("plain")
    return cfg


def test_the_profile_file_reads_across_the_packages(tmp_path):
    ref = ref_config.ConfigFile(str(tmp_path / "jax"))
    ref.config = _profile_config(ref_config)
    ref.save()
    got = port_config.ConfigFile.load(str(tmp_path / "jax")).config
    assert got.to_dict() == ref.config.to_dict()
    assert got.current_cluster().tls.client_cert == tls_files()["admin_cert"]
    port = port_config.ConfigFile(str(tmp_path / "port"))
    port.config = _profile_config(port_config)
    port.save()
    back = ref_config.ConfigFile.load(str(tmp_path / "port")).config
    assert back.to_dict() == port.config.to_dict() == ref.config.to_dict()
    assert port_config.ConfigFile.load(str(tmp_path / "missing")).config.to_dict() == \
        port_config.Config().to_dict()


def test_connect_with_no_address_takes_the_profile(tmp_path):
    """``Fluvio.connect()`` resolves the profile's endpoint and its TLS
    policy; a profile without TLS to the same endpoint is refused."""
    values = [b"profile-%d" % i for i in range(5)]

    async def body():
        server = _tls_spu(tmp_path / "spu")
        await server.start()
        try:
            server.ctx.create_replica("topic", 0)
            path = write_profile(tmp_path / "config", _addr(server), "admin")
            client = await Fluvio.connect(config_path=path)
            try:
                got = await _produce_and_consume(
                    client, "topic", values, ConsumerConfig(disable_continuous=True), Offset)
            finally:
                await client.close()
            plain = port_config.ConfigFile(str(tmp_path / "plain"))
            plain.config.add_cluster("plain", port_config.FluvioClusterConfig(
                endpoint=_addr(server)))
            plain.save()
            with pytest.raises(REFUSED):
                await asyncio.wait_for(Fluvio.connect(config_path=str(tmp_path / "plain")), 5)
            return got
        finally:
            await server.stop()

    assert run(body()) == values
    with pytest.raises(port_config.ConfigError):
        port_config.current_cluster(str(tmp_path / "missing"))


# -- persistent metadata and SC restarts ----------------------------------------

_SOURCE = b"from smartmodule import dsl\n\n@smartmodule.filter\ndef f(record):\n    return True\n"


def _store_dicts(sc) -> dict:
    """What a restart keeps, as plain dicts: every topic and SmartModule
    (spec and status) and every partition's spec. A partition's status is
    the live cluster's (the restarted SC finds no SPU online), and the
    revisions are each SC's own count."""
    ctx = sc.ctx
    return {
        "topics": {o.key: (o.spec.to_dict(), o.status.to_dict()) for o in ctx.topics.store.values()},
        "partitions": {o.key: o.spec.to_dict() for o in ctx.partitions.store.values()},
        "smartmodules": {o.key: (o.spec.to_dict(), o.status.to_dict())
                         for o in ctx.smartmodules.store.values()},
    }


async def _settled(sc, want, timeout: float = CLUSTER_WAIT_S):
    deadline = asyncio.get_running_loop().time() + timeout
    while _store_dicts(sc) != want:
        if asyncio.get_running_loop().time() > deadline:
            return _store_dicts(sc)
        await asyncio.sleep(0.02)
    return want


def test_the_dispatcher_persists_writes_and_resyncs_from_its_backend():
    """A `MetadataDispatcher` over the in-memory backend: a controller's
    write reaches the backend through the writer loop, and a change made
    in the backend reaches the store through the watch loop; a store
    without a dispatcher queues no write."""
    from fluvio_tpu_torch.metadata.client import InMemoryMetadataClient
    from fluvio_tpu_torch.metadata.dispatcher import MetadataDispatcher
    from fluvio_tpu_torch.stream_model.core import MetadataStoreObject
    from fluvio_tpu_torch.stream_model.store import StoreContext

    async def body():
        bare = StoreContext(TopicSpec)
        await bare.apply(MetadataStoreObject("bare", TopicSpec.computed(1)))
        assert bare.pending_actions() == 0
        client = InMemoryMetadataClient()
        ctx = StoreContext(TopicSpec)
        d = MetadataDispatcher(client, ctx, reconcile_interval=0.05)
        await d.resync()
        d.start()
        try:
            await ctx.apply(MetadataStoreObject("written", TopicSpec.computed(2)))
            for _ in range(200):
                if [o.key for o in await client.retrieve_items(TopicSpec)] == ["written"]:
                    break
                await asyncio.sleep(0.01)
            await client.apply(MetadataStoreObject("external", TopicSpec.computed(3)))
            for _ in range(200):
                if "external" in ctx.store:
                    break
                await asyncio.sleep(0.01)
            await client.delete_item(TopicSpec, "written")
            for _ in range(200):
                if "written" not in ctx.store:
                    break
                await asyncio.sleep(0.01)
            return sorted(o.key for o in ctx.store.values()), ctx.pending_actions()
        finally:
            await d.stop()

    assert run(body()) == (["external"], 0)


def test_metadata_survives_sc_restart(tmp_path):
    """The port's counterpart of ``tests/test_sc.py``'s test of this name."""
    async def body():
        meta_dir = tmp_path / "metadata"
        sc, admin, spus = await boot_torch_cluster(tmp_path, device="cpu",
                                                   metadata_dir=meta_dir)
        try:
            await admin.create_topic("durable")
            await wait_for_replicas(spus[0], "durable", [0])
            before = cluster_snapshot(sc)
        finally:
            await shutdown_torch_cluster(sc, admin, spus)
        sc2 = ScServer(ScConfig(metadata_dir=str(meta_dir)))
        await sc2.start()
        try:
            admin2 = await FluvioAdmin.connect(sc2.public_addr)
            topics = await admin2.list_topics()
            await admin2.close()
            return [t.key for t in topics], before, cluster_snapshot(sc2)
        finally:
            await sc2.stop()

    keys, before, after = run(body())
    assert keys == ["durable"]
    assert after["topics"] == before["topics"]
    assert {k: v[0] for k, v in after["partitions"].items()} == \
        {k: v[0] for k, v in before["partitions"].items()}


async def _jax_written(tmp_path, meta_dir):
    """A JAX cluster with ``metadata_dir`` that made a topic of two
    partitions and a SmartModule, then stopped: its stores' dicts."""
    sc, admin, spus = await boot_cluster(tmp_path / "jax", metadata_dir=meta_dir)
    try:
        await admin.create_topic("durable", RefTopicSpec.computed(2))
        await admin.create_smartmodule("keeper", _SOURCE)
        await sc.ctx.partitions.wait_action(
            "durable-1", lambda o: o is not None and o.status.is_online(), timeout=5)
        await asyncio.sleep(0.3)  # the dispatchers' writer loops drain
        return _store_dicts(sc)
    finally:
        await shutdown_cluster(sc, admin, spus)


async def _port_written(tmp_path, meta_dir):
    sc, admin, spus = await boot_torch_cluster(tmp_path / "port", device="cpu",
                                               metadata_dir=meta_dir)
    try:
        await admin.create_topic("durable", TopicSpec.computed(2))
        await admin.create_smartmodule("keeper", _SOURCE)
        await wait_for_module(spus[0], "keeper")
        await sc.ctx.partitions.wait_action(
            "durable-1", lambda o: o is not None and o.status.is_online(), timeout=5)
        await asyncio.sleep(0.3)
        return _store_dicts(sc)
    finally:
        await shutdown_torch_cluster(sc, admin, spus)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_an_sc_restarts_from_a_directory_the_other_package_wrote(writer, reader, tmp_path):
    async def body():
        meta_dir = tmp_path / "metadata"
        before = await (_jax_written if writer == "jax" else _port_written)(tmp_path, meta_dir)
        server_cls, config_cls, admin_cls = (
            (ScServer, ScConfig, FluvioAdmin) if reader == "port"
            else (RefScServer, RefScConfig, RefFluvioAdmin))
        sc = server_cls(config_cls(metadata_dir=str(meta_dir)))
        await sc.start()
        try:
            after = await _settled(sc, before)
            admin = await admin_cls.connect(sc.public_addr)
            listed = sorted(t.key for t in await admin.list_topics())
            await admin.close()
            return before, after, listed
        finally:
            await sc.stop()

    before, after, listed = run(body())
    assert listed == ["durable"]
    assert sorted(before["partitions"]) == ["durable-0", "durable-1"]
    assert after == before


# -- authorization --------------------------------------------------------------

_IDENTITIES = [("anonymous", []), ("root", ["Root"]), ("alice", ["admins"]),
               ("bob", ["viewers"]), ("carol", ["viewers", "Operator"]), ("dan", ["nobody"])]
_POLICIES = {
    "secure": rbac_policy,
    "mixed": lambda: {"Viewer": {"Topic": ["Read"]},
                      "Operator": {"Topic": ["All"], "SmartModule": ["Create", "Read"],
                                   "Partition": ["Delete"]},
                      "viewers": {"Spu": ["Read", "Create"]}},
}


def _decisions(pkg, policy_name: str):
    """Every (identity, action, object type) decision of one policy in
    package ``pkg``: RBAC (the policy), read-only and root."""
    table = {}
    for principal, scopes in _IDENTITIES:
        ident = pkg.Identity(principal, list(scopes))
        ways = {
            "rbac": pkg.BasicAuthorization(pkg.BasicRbacPolicy(roles=_POLICIES[policy_name]()),
                                           authenticator=lambda s, i=ident: i),
            "read_only": pkg.ReadOnlyAuthorization(),
            "root": pkg.RootAuthorization(),
        }
        for way, authz in ways.items():
            ctx = authz.create_auth_context(None)
            for ty in pkg.ObjectType:
                for action in pkg.TypeAction:
                    table[(principal, way, ty.value, action.value)] = ctx.allow_type_action(
                        ty, action)
                table[(principal, way, ty.value, "Delete")] = ctx.allow_instance_action(
                    ty, pkg.InstanceAction.DELETE, "key")
    return table


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_authorization_decisions_equal_the_reference(policy, tmp_path):
    port, ref = _decisions(auth, policy), _decisions(ref_auth, policy)
    assert port == ref and any(port.values()) and not all(port.values())
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(_POLICIES[policy]()))
    assert auth.BasicRbacPolicy.load(str(path)).roles == \
        ref_auth.BasicRbacPolicy.load(str(path)).roles
    cert = {"subject": ((("commonName", "alice"),), (("organizationName", "admins"),),
                        (("organizationName", "ops"),))}
    for c in (cert, None, {"subject": ((("organizationName", "x"),),)}):
        a, b = auth.Identity.from_peer_cert(c), ref_auth.Identity.from_peer_cert(c)
        assert (a.principal, a.scopes) == (b.principal, b.scopes)


@pytest.mark.parametrize("request_kind", ["create", "delete"])
def test_a_refused_admin_request_answers_the_reference_status(request_kind):
    """A read-only SC refuses a create and a delete with the JAX SC's
    status: name, code and message."""
    async def refused(server_cls, config_cls, admin_cls, error_cls, spec):
        sc = server_cls(config_cls(read_only=True))
        await sc.start()
        try:
            admin = await admin_cls.connect(sc.public_addr)
            try:
                with pytest.raises(error_cls) as e:
                    if request_kind == "create":
                        await admin.create_topic("t1", spec)
                    else:
                        await admin.delete_topic("t1")
                assert await admin.list_topics() == []
            finally:
                await admin.close()
            s = e.value.status
            return s.name, int(s.error_code), s.error_message
        finally:
            await sc.stop()

    port = run(refused(ScServer, ScConfig, FluvioAdmin, AdminError, TopicSpec.computed(1)))
    ref = run(refused(RefScServer, RefScConfig, RefFluvioAdmin, RefAdminError,
                      RefTopicSpec.computed(1)))
    assert port == ref and port[1] == ErrorCode.PERMISSION_DENIED


def test_rbac_by_certificate_divergence_is_pinned(tmp_path):
    """With TLS and ``auth_policy_path``, the admins certificate may create
    a topic on the port's SC; the JAX SC sees the same connection as
    anonymous and refuses it (PERMISSION_DENIED)."""
    async def create(sc, tls):
        await sc.start()
        try:
            socket = await RefSocket.connect(sc.public_addr, tls=tls)
            admin = RefFluvioAdmin(socket)
            try:
                await admin.create_topic("by-cert", RefTopicSpec.computed(1), timeout_ms=0)
                return "created"
            except RefAdminError as e:
                return e.status.error_code.name
            finally:
                await admin.close()
        finally:
            await sc.stop()

    policy = write_rbac_policy(tmp_path / "policy.json")
    port_sc = ScServer(dataclasses.replace(secure_sc_config(tmp_path / "port"),
                                           metadata_dir=None))
    ref_sc = RefScServer(RefScConfig(auth_policy_path=policy,
                                     tls=server_tls(ref_tls.ServerTlsConfig)))
    tls = client_tls(RefTlsPolicy, "admin")
    assert run(create(port_sc, tls)) == "created"
    assert run(create(ref_sc, tls)) == "PERMISSION_DENIED"


def test_admin_over_tls_divergence_is_pinned():
    """On an SC whose public endpoint speaks TLS, the JAX client's
    ``admin()`` dials without its TLS policy and is refused; the port's
    passes the policy and lists the topics."""
    async def body():
        sc = ScServer(ScConfig(tls=server_tls(port_tls.ServerTlsConfig)))
        await sc.start()
        try:
            ref = await RefFluvio.connect(sc.public_addr, tls=client_tls(RefTlsPolicy, "admin"))
            try:
                with pytest.raises(REFUSED):
                    await asyncio.wait_for(ref.admin(), 5)
            finally:
                await ref.close()
            port = await Fluvio.connect(sc.public_addr,
                                        tls=client_tls(port_config.TlsPolicy, "admin"))
            try:
                admin = await port.admin()
                listed = await admin.list_topics()
                await admin.close()
            finally:
                await port.close()
            return listed
        finally:
            await sc.stop()

    assert run(body()) == []


# -- phase 17 at a small size ---------------------------------------------------


def test_secure_cluster_sequence_on_the_cpu(tmp_path):
    """`chip_smoke.py`'s phase 17 at 2,000 records with the SPU's engine on
    the CPU (the card test runs it on both): both compressed topics serve
    the north star's outputs after the SC restart; the viewer is refused."""
    values = gen_json(2000, seed=3)
    got, code, launches = run(_secure_cluster_sequence(tmp_path, "cpu", values), 300)
    want = [(i, None, json.loads(v)["name"].upper().encode())
            for i, v in enumerate(values) if b"fluvio" in v]
    assert got["lz4"] == got["snappy"] == want
    assert code == ErrorCode.PERMISSION_DENIED
    assert set(launches) >= {"json_span", "dfa_scan"}
