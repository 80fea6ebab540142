"""Isolation of the GPU port from the JAX package, and its device rules.

- No file of ``fluvio_tpu_torch/`` and not ``chip_smoke.py`` imports jax,
  anything of ``fluvio_tpu`` or yaml (an AST scan of every import), and no module
  of the port names a path under ``fluvio_tpu/`` in its code (the port
  builds its own copy of the glz compressor, never the JAX package's) or
  reads the environment (``os.environ``, ``os.getenv``: every setting is
  a field, the telemetry's included).
- With no device given and no CUDA, `SmartEngine()` raises instead of
  drifting to the CPU.
- On a machine with a card (marker ``cuda``; skipped elsewhere), each CUDA
  kernel equals its plain torch version exactly on the same inputs, and
  the aggregate and explode chains, the windowed runtime, the
  partition runtime, the broker's consume slice, the SPU server, the
  cluster (an SC, its SPU, the producer), replication and the secure
  cluster (TLS, RBAC, compressed topics, an SC restart) give the card the
  CPU's outputs.

The bench corpora and the DFA scan's cases live here, free of jax, so
that the CPU tests, the card tests and ``chip_smoke.py`` share them.
"""

from __future__ import annotations

import ast
import asyncio
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


# The bench corpora, seeded, shared by the port's tests and `chip_smoke.py`
# (jax-free, since the card's machine has no jax).
def gen_json(n: int, seed: int = 2024):
    """`bench.gen_json`: ~half the names contain "fluvio", ``n`` up to 99,999."""
    rng = np.random.default_rng(seed)
    names = ["fluvio", "kafka", "pulsar", "fluvio-tpu", "redpanda", "flink"]
    picks = rng.integers(0, len(names), size=n)
    nums = rng.integers(0, 100000, size=n)
    return [
        f'{{"name":"{names[picks[i]]}-{i & 1023}","n":{nums[i]}}}'.encode()
        for i in range(n)
    ]


def gen_arrays(n: int, seed: int = 7):
    """`bench.gen_arrays`: a JSON array of ~6 elements a record."""
    rng = np.random.default_rng(seed)
    nums = rng.integers(0, 10000, size=(n, 3))
    return [
        f'["a{i & 255}","b{nums[i][0]}",{nums[i][1]},{nums[i][2]},"x","y"]'.encode()
        for i in range(n)
    ]


def gen_ints(n: int, seed: int = 11):
    """`bench.gen_ints`: decimal ints 0..999, one a record (the windowed
    configs `5_windowed` and `11_windowed_sliding`)."""
    rng = np.random.default_rng(seed)
    nums = rng.integers(0, 1000, size=n)
    return [str(nums[i]).encode() for i in range(n)]


def gen_keyed_ints(n: int, seed: int = 13):
    """`bench.gen_keyed_ints`: ``"<key> <value>"`` records, 64 keys, values
    0..999 (the windowed config `12_windowed_keyed`)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 64, size=n)
    vals = rng.integers(0, 1000, size=n)
    return [f"{keys[i]} {vals[i]}".encode() for i in range(n)]


FAT_NAMES = ("fluvio", "kafka", "fluVio", "pulsar")  # `flu[vV]io` keeps half


def gen_fat_numbers(n: int, seed: int = 21, body: int = 70 * 1024):
    """The striped aggregate's corpus: a signed integer and a space, then
    `bench.gen_fat_70k`'s record (71,709 bytes at the default ``body``)
    with the name cycling over `FAT_NAMES`."""
    rng = np.random.default_rng(seed)
    nums = rng.integers(-10**9, 10**9, size=n)
    pad = "x" * body
    return [f'{nums[i]} {{"name":"{FAT_NAMES[i % 4]}-{i & 7}","body":"{pad}"}}'.encode()
            for i in range(n)]


def gen_fat_lines(n: int, seed: int = 23, size: int = 71_709):
    """The striped explode's corpus: a log file shipped as one record of
    ``size`` bytes, lines of 40-100 bytes (newline included) of lowercase
    letters, one in twenty followed by a run of one to three empty lines;
    the first line names one of `FAT_NAMES`."""
    rng = np.random.default_rng(seed)
    out = []
    m = size // 40 + 2
    for i in range(n):
        lens = rng.integers(40, 101, size=m)
        chunk = lens + np.where(rng.random(m) < 0.05, rng.integers(1, 4, size=m), 0)
        ends = np.cumsum(chunk)
        rec = rng.integers(97, 123, size=int(ends[-1])).astype(np.uint8)
        starts = ends - chunk
        nl = np.repeat(starts + lens - 1, chunk - lens + 1) + (
            np.arange(int((chunk - lens + 1).sum())) - np.repeat(
                np.cumsum(chunk - lens + 1) - (chunk - lens + 1), chunk - lens + 1))
        rec[nl] = ord("\n")
        head = f"{FAT_NAMES[i % 4]} log {i}".encode()
        rec[: len(head)] = np.frombuffer(head, dtype=np.uint8)
        out.append(rec[:size].tobytes())
    return out


# The broker's consume configuration (`bench.run_broker_e2e`), jax-free,
# shared by the CPU tests, the card test below and `chip_smoke.py`: the
# bench's two AdHoc SmartModule payloads, a log of stored batches and the
# storage's read slices.
NORTH_STAR_FILTER_SM = b"""
@smartmodule.filter(dsl=dsl.FilterProgram(
    predicate=dsl.RegexMatch(arg=dsl.Value(), pattern="fluvio")))
def f(record):
    import re
    return re.search(b"fluvio", record.value) is not None
"""

NORTH_STAR_MAP_SM = b"""
@smartmodule.map(dsl=dsl.MapProgram(
    value=dsl.Upper(arg=dsl.JsonGet(arg=dsl.Value(), key="@param:field=name"))))
def m(record):
    return dsl.ascii_upper(dsl.json_get_bytes(record.value, "name"))
"""


# a Python map hook with no DSL program: the host segment between two card
# segments of `MIXED_CHAIN` (phase 20 of the chip smoke)
HOOK_TAG_SM = b"""
@smartmodule.map
def tag(record):
    return record.value.replace(b'"name":"', b'"name":"hook/', 1)
"""

# phase 20's chains: an explode, a non-literal regex over its elements and a
# count (a record that is no JSON array ends its batch: the first error);
# a card filter, the host hook, a card map
FIRST_ERROR_CHAIN = [("array-map-json", {}), ("regex-filter", {"regex": "a1[0-9]"}),
                     ("aggregate-count", {})]
MIXED_CHAIN = [("regex-filter", {"regex": "fluvio"}), (HOOK_TAG_SM, {}),
               ("json-map", {"field": "name"})]
FIRST_ERROR_RECORD = b'{"no":1}'

# `FIRST_ERROR_CHAIN` as AdHoc sources, for a consumer of the SPU server
# (DSL programs: each module runs on the card)
FIRST_ERROR_SMS = (
    (b"""
@smartmodule.array_map(dsl=dsl.ArrayMapProgram(mode="json_array"))
def explode(record):
    import json
    return [i.encode() if isinstance(i, str) else json.dumps(i).encode()
            for i in json.loads(record.value)]
""", "ARRAY_MAP"),
    (b"""
@smartmodule.filter(dsl=dsl.FilterProgram(
    predicate=dsl.RegexMatch(arg=dsl.Value(), pattern="a1[0-9]")))
def f(record):
    import re
    return re.search(b"a1[0-9]", record.value) is not None
""", "FILTER"),
    (b"""
@smartmodule.aggregate(dsl=dsl.AggregateProgram(kind="count"))
def count(acc, record):
    return str(int(acc or b"0") + 1).encode()
""", "AGGREGATE"),
)

# a DSL `flu[vV]io` filter that exports a look_back hook, which keeps what it
# sees in ``SEEN`` (phase 20's look-back stream)
LOOK_BACK_SEEN_SM = b"""
SEEN = []


@smartmodule.filter(dsl=dsl.FilterProgram(
    predicate=dsl.RegexMatch(arg=dsl.Value(), pattern="flu[vV]io")))
def f(record):
    import re
    return re.search(b"flu[vV]io", record.value) is not None


@smartmodule.look_back
def look_back(record):
    SEEN.append(record.value)
"""


def first_error_invocations():
    """`FIRST_ERROR_SMS` as a consumer's AdHoc invocations."""
    from fluvio_tpu_torch.schema.smartmodule import (
        SmartModuleInvocation,
        SmartModuleInvocationKind,
        SmartModuleInvocationWasm,
    )

    return [SmartModuleInvocation(wasm=SmartModuleInvocationWasm.adhoc(src),
                                  kind=getattr(SmartModuleInvocationKind, kind))
            for src, kind in FIRST_ERROR_SMS]


def hook_chain(specs, device: str, hook_budget_ms: int = 5000):
    """A chain instance on ``device`` from [(registry name | source bytes,
    params)]: DSL modules on the card's segments, hooks on the host."""
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig

    b = SmartEngine(device=device, hook_budget_ms=hook_budget_ms).builder()
    for k, (spec, params) in enumerate(specs):
        module = lookup(spec) if isinstance(spec, str) else spec
        b.add_smart_module(SmartModuleConfig(params=dict(params)), module, name=f"hook{k}")
    return b.initialize()


def north_star_invocations():
    """The bench's broker chain as a consumer sends it: the two AdHoc
    invocations, encoded and decoded with the port's codec."""
    from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter
    from fluvio_tpu_torch.schema.smartmodule import (
        SmartModuleInvocation,
        SmartModuleInvocationKind,
        SmartModuleInvocationWasm,
    )

    out = []
    for payload, kind, params in (
        (NORTH_STAR_FILTER_SM, SmartModuleInvocationKind.FILTER, {}),
        (NORTH_STAR_MAP_SM, SmartModuleInvocationKind.MAP, {"field": "name"}),
    ):
        w = ByteWriter()
        SmartModuleInvocation(wasm=SmartModuleInvocationWasm.adhoc(payload), kind=kind,
                              params=params).encode(w)
        out.append(SmartModuleInvocation.decode(ByteReader(w.bytes())))
    return out


def broker_log(values, batch_records: int, first_timestamp: int = 1_000_000):
    """The bench's stored log (`bench.run_broker_e2e`): ``values`` in
    batches of ``batch_records``, offsets from 0, each batch's records
    encoded by the port's native encoder (offset deltas 0.., timestamp
    deltas 0) under ``first_timestamp``. Returns (the wire bytes of each
    batch, the batches decoded raw as storage hands them over)."""
    from fluvio_tpu_torch.native import records as native_records
    from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter
    from fluvio_tpu_torch.protocol.record import Batch

    wires, batches = [], []
    for lo in range(0, len(values), batch_records):
        chunk = values[lo: lo + batch_records]
        m = len(chunk)
        val_off = np.zeros(m + 1, dtype=np.int64)
        np.cumsum([len(v) for v in chunk], out=val_off[1:])
        raw = native_records.encode_record_columns(
            np.frombuffer(b"".join(chunk), dtype=np.uint8), val_off, np.zeros(0, np.uint8),
            np.zeros(m + 1, np.int64), np.zeros(m, np.uint8), np.arange(m, dtype=np.int64),
            np.zeros(m, np.int64))
        b = Batch(base_offset=lo, raw_records=raw, raw_record_count=m)
        b.header.first_timestamp = b.header.max_time_stamp = first_timestamp
        b.header.last_offset_delta = m - 1
        w = ByteWriter()
        b.encode(w)
        wires.append(w.bytes())
        batches.append(Batch.decode(ByteReader(wires[-1]), parse_records=False))
    return wires, batches


def slice_reader(wires, batches, max_bytes: int):
    """``read(offset)``: the storage's read slice at ``offset``, whole
    stored batches from the one that holds it while their stored bytes
    stay within ``max_bytes`` (at least one batch; none past the end)."""
    ends = np.array([b.computed_last_offset() for b in batches])
    sizes = np.cumsum([len(w) for w in wires])

    def read(offset: int):
        first = int(np.searchsorted(ends, offset, side="right"))
        if first == len(batches):
            return []
        room = (sizes[first] - len(wires[first])) + max_bytes
        last = max(int(np.searchsorted(sizes, room, side="right")), first + 1)
        return batches[first:last]

    return read


# The SPU server's consume (`bench.run_broker_e2e` over its socket),
# jax-free, shared by the CPU test, the card test below and
# `chip_smoke.py`: start the port's server with the stored log, and one
# consume pass through its client.
FLU_REGEX_SM = b"""
@smartmodule.filter(dsl=dsl.FilterProgram(
    predicate=dsl.RegexMatch(arg=dsl.Value(), pattern="flu[vV]io")))
def f(record):
    import re
    return re.search(b"flu[vV]io", record.value) is not None
"""

AGGREGATE_SM = b"""
@smartmodule.aggregate(dsl=dsl.AggregateProgram(
    contribution=dsl.ParseInt(arg=dsl.JsonGet(arg=dsl.Value(), key="@param:field=n")),
    combine="@param:combine=add"))
def a(acc, record):
    import json
    return str(int(acc or b"0") + int(json.loads(record.value)["n"])).encode()
"""


def server_invocations(name: str):
    """A broker chain as a consumer sends it, AdHoc: ``north_star`` (the
    bench's), ``flu_regex_filter`` (``regex-filter("flu[vV]io")``) or
    ``3_aggregate`` (``aggregate-field(field="n", combine="add")``)."""
    from fluvio_tpu_torch.schema.smartmodule import (
        SmartModuleInvocation,
        SmartModuleInvocationKind,
        SmartModuleInvocationWasm,
    )

    if name == "north_star":
        return north_star_invocations()
    payload, kind, params = {
        "flu_regex_filter": (FLU_REGEX_SM, SmartModuleInvocationKind.FILTER, {}),
        "3_aggregate": (AGGREGATE_SM, SmartModuleInvocationKind.AGGREGATE,
                        {"field": "n", "combine": "add"}),
    }[name]
    return [SmartModuleInvocation(wasm=SmartModuleInvocationWasm.adhoc(payload), kind=kind,
                                  params=params)]


async def start_spu_server(log_dir, batches, device=None, topic: str = "bench",
                           monitoring_path=None, telemetry=None, admission=None):
    """The port's `SpuServer` on ``127.0.0.1:0`` logging under
    ``log_dir``, its SmartEngine on ``device`` (None: the card), with one
    replica of ``topic`` holding ``batches``, each written as its own
    record set through the leader's `write_record_set`; its monitoring
    socket at ``monitoring_path`` (None: none), ``telemetry`` (a
    `TelemetryConfig`) and ``admission`` (an `AdmissionConfig`) applied.
    Returns the started server."""
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.server import SpuServer
    from fluvio_tpu_torch.storage.config import ReplicaConfig

    config = SpuConfig(public_addr="127.0.0.1:0", log_base_dir=str(log_dir),
                       replication=ReplicaConfig(base_dir=str(log_dir)),
                       monitoring_path=monitoring_path, telemetry=telemetry,
                       admission=admission)
    config.smart_engine.device = device
    server = SpuServer(config)
    await server.start()
    await write_topic(server, topic, batches)
    return server


async def write_topic(server, topic: str, batches):
    """A replica of ``topic`` on ``server`` holding ``batches``, each
    written as its own record set through the leader's
    `write_record_set`."""
    from fluvio_tpu_torch.protocol.record import RecordSet

    leader = server.ctx.create_replica(topic, 0)
    for batch in batches:
        records = RecordSet()
        records.add(batch)
        await leader.write_record_set(records)


def server_consumer_config(invocations, max_bytes: int):
    """The bench's `ConsumerConfig`: stop at the log's end, ``max_bytes``
    a slice, the chain's invocations."""
    from fluvio_tpu_torch.client import ConsumerConfig

    return ConsumerConfig(disable_continuous=True, max_bytes=max_bytes,
                          smartmodules=list(invocations))


async def consume_once(consumer, config, offset=None):
    """One `stream_batches` pass of a `PartitionConsumer` from ``offset``
    (default: the beginning): (the batches, each batch's arrival time on
    ``time.perf_counter``)."""
    from fluvio_tpu_torch.client import Offset

    batches, arrivals = [], []
    async for batch in consumer.stream_batches(offset or Offset.beginning(), config):
        arrivals.append(time.perf_counter())
        batches.append(batch)
    return batches, arrivals


# The cluster (an SC, its SPUs, the admin client and the producer),
# jax-free, shared by the CPU test `tests/test_torch_cluster.py`, the card
# test below and `chip_smoke.py`, as the JAX package's tests share
# `boot_cluster` (`tests/test_sc.py`). Every wait has a timeout.
CLUSTER_WAIT_S = 10.0


async def wait_spu_online(sc, spu_id: int, online: bool = True, timeout: float = CLUSTER_WAIT_S):
    """Wait until the SC sees SPU ``spu_id`` online (or offline)."""
    obj = await sc.ctx.spus.wait_action(
        str(spu_id), lambda o: o is not None and o.status.is_online() == online, timeout=timeout)
    if obj is None or obj.status.is_online() != online:
        raise TimeoutError(f"SPU {spu_id} never went {'on' if online else 'off'}line at the SC")


async def boot_torch_cluster(log_dir, n_spus: int = 1, device=None, first_id: int = 5000,
                             metadata_dir=None):
    """The port's `ScServer` (its metadata in memory, or in
    ``metadata_dir``) and ``n_spus`` `SpuServer`s (ids from ``first_id``,
    public and private endpoints on ``127.0.0.1:0``, each logging under
    ``log_dir/spu-<id>``, its SmartEngine on ``device``; None: the card),
    each registered through ``admin.register_custom_spu`` with both
    addresses and online at the SC. Returns (sc, admin, spus)."""
    from pathlib import Path as _Path

    from fluvio_tpu_torch.client import FluvioAdmin
    from fluvio_tpu_torch.sc import ScConfig, ScServer
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.server import SpuServer
    from fluvio_tpu_torch.storage.config import ReplicaConfig

    sc = ScServer(ScConfig(metadata_dir=str(metadata_dir) if metadata_dir else None))
    await sc.start()
    admin = await FluvioAdmin.connect(sc.public_addr)
    spus = []
    try:
        for spu_id in range(first_id, first_id + n_spus):
            spu_dir = str(_Path(log_dir) / f"spu-{spu_id}")
            config = SpuConfig(id=spu_id, public_addr="127.0.0.1:0", private_addr="127.0.0.1:0",
                               sc_addr=sc.private_addr, log_base_dir=spu_dir,
                               replication=ReplicaConfig(base_dir=spu_dir))
            config.smart_engine.device = device
            server = SpuServer(config)
            await server.start()
            spus.append(server)
            await admin.register_custom_spu(spu_id, server.public_addr,
                                            private_addr=server.private_addr)
        for server in spus:
            await wait_spu_online(sc, server.config.id)
    except BaseException:
        await shutdown_torch_cluster(sc, admin, spus)
        raise
    return sc, admin, spus


async def restart_spu(sc, server, make_server):
    """Start a stopped SPU again: ``make_server(server.config)`` builds it
    on the same id, config and log directory, its endpoints on
    ``127.0.0.1:0`` anew (a stopped SPU's ports may be taken); the SPU's
    spec at the SC takes the new addresses, as a re-registration would,
    and the SPU comes online there. Serves both packages' clusters (their
    SCs are one design). Returns the new server."""
    import dataclasses

    new = make_server(server.config)
    await new.start()
    try:
        key = str(server.config.id)
        spec = sc.ctx.spus.store.value(key).spec
        endpoint = type(spec.public_endpoint)
        await sc.ctx.spus.update_spec(key, dataclasses.replace(
            spec, public_endpoint=endpoint.from_addr(new.public_addr),
            private_endpoint=endpoint.from_addr(new.private_addr)))
        await wait_spu_online(sc, server.config.id)
    except BaseException:
        await new.stop()
        raise
    return new


async def restart_torch_spu(sc, server):
    """`restart_spu` for a port SPU of `boot_torch_cluster`."""
    from fluvio_tpu_torch.spu.server import SpuServer

    return await restart_spu(sc, server, SpuServer)


async def shutdown_torch_cluster(sc, admin, spus) -> None:
    """Close the admin client, stop every SPU in ``spus`` (leave out one
    stopped already) and the SC."""
    await admin.close()
    for server in spus:
        await server.stop()
    await sc.stop()


async def wait_for_replicas(spu, topic: str, partitions, timeout: float = CLUSTER_WAIT_S):
    """Wait until ``spu`` leads every partition of ``topic`` listed."""
    deadline = time.monotonic() + timeout
    while not all(spu.ctx.leader_for(topic, p) is not None for p in partitions):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{topic} {list(partitions)} never provisioned on the SPU")
        await asyncio.sleep(0.02)


async def wait_for_module(spu, name: str, timeout: float = CLUSTER_WAIT_S):
    """Wait until the SC has pushed SmartModule ``name`` to ``spu``."""
    deadline = time.monotonic() + timeout
    while spu.ctx.smartmodules.get(name) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"SmartModule {name!r} never reached the SPU")
        await asyncio.sleep(0.02)


async def produce_all(client, topic: str, items, config=None):
    """``items`` ((key, value) pairs) through ``client.topic_producer``
    with ``send_all`` and ``flush``: [(partition, offset)] a record, in
    order."""
    producer = await client.topic_producer(topic, config=config)
    try:
        futs = await producer.send_all(items)
        await producer.flush()
        metas = [await f.wait() for f in futs]
    finally:
        await producer.close()
    return [(m.partition, m.offset) for m in metas]


def replica_log(storage, max_bytes: int = 16 << 20) -> bytes:
    """A replica's stored batches from its log start to its LEO, the bytes
    of each `read_partition_slice` joined (either package's
    `FileReplica`)."""
    out, offset = [], storage.get_log_start_offset()
    while offset < storage.get_leo():
        sl = storage.read_partition_slice(offset, max_bytes)
        out.append(sl.file_slice.read_bytes())
        offset = sl.next_offset
    return b"".join(out)


def namespace_invocations(name: str):
    """A broker chain as a consumer sends it by name, Predefined: the
    modules of `server_invocations(name)` pushed to the SC under
    ``<name>-<k>``. Returns ([(module name, source)], invocations)."""
    from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocationWasm

    modules, out = [], []
    for k, inv in enumerate(server_invocations(name)):
        module = f"{name.replace('_', '-')}-{k}"
        modules.append((module, inv.wasm.payload))
        inv.wasm = SmartModuleInvocationWasm.predefined(module)
        out.append(inv)
    return modules, out


# The secure cluster (TLS on both public endpoints, the SC's metadata in a
# directory, an RBAC policy over the client certificates' identities),
# jax-free, shared by `tests/test_torch_secure_cluster.py`, the card test
# below and `chip_smoke.py`'s phase 17. The certificates are committed test
# material (`tests/data/tls/README.md`); nothing generates them.
TLS_DIR = REPO / "tests" / "data" / "tls"
# role (a certificate's O) -> the action it may take on every object type
SECURE_ROLES = {"admins": "All", "viewers": "Read"}
SECURE_OBJECT_TYPES = ("Spu", "CustomSpu", "SpuGroup", "Topic", "Partition", "SmartModule",
                       "TableFormat")


def tls_files(tls_dir=TLS_DIR) -> dict:
    """Paths of the test CA, the server's certificate and key, and the two
    client certificates and keys (``admin``: CN=alice, O=admins;
    ``viewer``: CN=bob, O=viewers)."""
    names = {"ca": "ca.crt", "server_cert": "server.crt", "server_key": "server.key",
             "admin_cert": "admin.crt", "admin_key": "admin.key",
             "viewer_cert": "viewer.crt", "viewer_key": "viewer.key"}
    return {k: str(Path(tls_dir) / v) for k, v in names.items()}


def server_tls(config_cls, require_client_cert: bool = False):
    """An endpoint's TLS (either package's `ServerTlsConfig`): the server
    certificate, client certificates verified against the test CA."""
    f = tls_files()
    return config_cls(enabled=True, server_cert=f["server_cert"], server_key=f["server_key"],
                      ca_cert=f["ca"], require_client_cert=require_client_cert)


def client_tls(policy_cls, who: str = "admin"):
    """A verified client `TlsPolicy` (either package's) presenting ``who``'s
    certificate; None presents none."""
    f = tls_files()
    cert = {"client_cert": f[f"{who}_cert"], "client_key": f[f"{who}_key"]} if who else {}
    return policy_cls(mode="verified", domain="localhost", ca_cert=f["ca"], **cert)


def rbac_policy() -> dict:
    """The secure cluster's `BasicRbacPolicy` roles: admins may do all,
    viewers may read, on every object type."""
    return {role: {ty: [action] for ty in SECURE_OBJECT_TYPES}
            for role, action in SECURE_ROLES.items()}


def write_rbac_policy(path) -> str:
    """`rbac_policy` as the JSON file ``auth_policy_path`` names."""
    Path(path).write_text(json.dumps(rbac_policy()))
    return str(path)


def write_profile(path, endpoint: str, who: str = "admin") -> str:
    """A profile file, written by the port's `ConfigFile`, whose current
    profile reaches ``endpoint`` with ``who``'s certificate."""
    from fluvio_tpu_torch.client.config import ConfigFile, FluvioClusterConfig, TlsPolicy

    cf = ConfigFile(str(path))
    cf.config.add_cluster("secure", FluvioClusterConfig(endpoint=endpoint,
                                                        tls=client_tls(TlsPolicy, who)))
    cf.save()
    return str(path)


def secure_sc_config(work_dir, public_addr: str = "127.0.0.1:0",
                     private_addr: str = "127.0.0.1:0"):
    """The port's `ScConfig` of the secure cluster under ``work_dir``:
    ``metadata/``, ``policy.json``, TLS on the public endpoint."""
    from fluvio_tpu_torch.sc import ScConfig
    from fluvio_tpu_torch.transport.tls import ServerTlsConfig

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    return ScConfig(public_addr=public_addr, private_addr=private_addr,
                    metadata_dir=str(work / "metadata"),
                    auth_policy_path=write_rbac_policy(work / "policy.json"),
                    tls=server_tls(ServerTlsConfig))


async def boot_secure_torch_cluster(work_dir, device=None, spu_id: int = 5000):
    """The port's secure `ScServer` (`secure_sc_config`) and one `SpuServer`
    (TLS on its public endpoint, its SmartEngine on ``device``; None: the
    card), registered by the admin identity through a client of its
    profile and online at the SC. Returns (sc, spu, profiles: who -> the
    profile file of ``admin`` and ``viewer``)."""
    from fluvio_tpu_torch.client import Fluvio
    from fluvio_tpu_torch.sc import ScServer
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.server import SpuServer
    from fluvio_tpu_torch.storage.config import ReplicaConfig
    from fluvio_tpu_torch.transport.tls import ServerTlsConfig

    work = Path(work_dir)
    sc = ScServer(secure_sc_config(work))
    await sc.start()
    spu = None
    try:
        profiles = {who: write_profile(work / f"config-{who}", sc.public_addr, who)
                    for who in ("admin", "viewer")}
        spu_dir = str(work / f"spu-{spu_id}")
        config = SpuConfig(id=spu_id, public_addr="127.0.0.1:0", private_addr="127.0.0.1:0",
                           sc_addr=sc.private_addr, log_base_dir=spu_dir,
                           replication=ReplicaConfig(base_dir=spu_dir),
                           tls=server_tls(ServerTlsConfig))
        config.smart_engine.device = device
        spu = SpuServer(config)
        await spu.start()
        client = await Fluvio.connect(config_path=profiles["admin"])
        try:
            admin = await client.admin()
            await admin.register_custom_spu(spu_id, spu.public_addr,
                                            private_addr=spu.private_addr)
            await admin.close()
        finally:
            await client.close()
        await wait_spu_online(sc, spu_id)
    except BaseException:
        if spu is not None:
            await spu.stop()
        await sc.stop()
        raise
    return sc, spu, profiles


async def restart_secure_sc(sc, spu_ids, timeout: float = CLUSTER_WAIT_S):
    """Stop ``sc`` and start the port's SC again on its config, its
    metadata directory and the addresses it had bound; wait until every
    SPU of ``spu_ids`` has registered again (the new SC's health bus) and
    shows online in its SPU store. Returns the new SC."""
    import dataclasses

    from fluvio_tpu_torch.sc import ScServer

    config = dataclasses.replace(sc.config, public_addr=sc.public_addr,
                                 private_addr=sc.private_addr)
    await sc.stop()
    new = ScServer(config)
    await new.start()
    try:
        deadline = time.monotonic() + timeout
        while not all(new.ctx.health.is_online(i) for i in spu_ids):
            if time.monotonic() > deadline:
                raise TimeoutError(f"SPUs {list(spu_ids)} never registered with the new SC")
            await asyncio.sleep(0.005)
        for i in spu_ids:
            await wait_spu_online(new, i, timeout=timeout)
    except BaseException:
        await new.stop()
        raise
    return new


def cluster_snapshot(sc) -> dict:
    """What an SC restart must keep: every topic's spec and resolution,
    every partition's spec (leader, replicas) and resolution, and the
    SmartModules' names and payloads."""
    return {
        "topics": {o.key: (o.spec.to_dict(), o.status.resolution.value)
                   for o in sc.ctx.topics.store.values()},
        "partitions": {o.key: (o.spec.to_dict(), o.status.resolution.value)
                       for o in sc.ctx.partitions.store.values()},
        "smartmodules": {o.key: o.spec.artifact.payload
                         for o in sc.ctx.smartmodules.store.values()},
    }


# The DFA scan's cases, shared by the card test below and the CPU spec of
# the kernel's walk (`tests/test_torch_dfa_redesign.py`); jax-free, since
# the card's machine has no jax.
DFA_SCAN_WIDTHS = (1, 15, 16, 17, 64)
BIG_PATTERN = "(a|b)*a(a|b){6}c|x" + "d" * 125  # 257 states: two-byte state ids
DFA_SCAN_PATTERNS = (("flu[vV]io", True), ("^fluvio$", True),
                     ("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False),
                     (BIG_PATTERN, True), (BIG_PATTERN, False))
_DFA_TOKENS = (b"fluvio", b"fluVio", b"kafka-2", b"pulsar-3", b"fluvio-1", b"aabababc",
               b"abbbbbbc", b"xdd", b"a")


def dfa_scan_lengths(width: int):
    """The edge lengths: padded rows (-1), empty, one byte, around one
    16-byte chunk, one short of the width, the width, past it."""
    return (-1, 0, 1, 15, 16, 17, width - 1, width, width + 5)


def dfa_scan_inputs(rng, width: int, per_length: int = 16):
    """values u8[N, width], lengths i32[N]: ``per_length`` rows at each edge
    length and one row a token of exactly the token's length; bytes from
    the patterns' alphabets with a token planted at 0 or further in, and
    garbage past every length."""
    lens = list(np.repeat(dfa_scan_lengths(width), per_length))
    lens += [len(t) for t in _DFA_TOKENS]
    alphabet = np.frombuffer(b"fluvioVkapsr-0123abcxd", dtype=np.uint8)
    values = alphabet[rng.integers(0, len(alphabet), size=(len(lens), width))]
    exact = len(lens) - len(_DFA_TOKENS)
    for i, length in enumerate(lens):
        live = min(max(int(length), 0), width)
        token = _DFA_TOKENS[i % len(_DFA_TOKENS)] if i < exact else _DFA_TOKENS[i - exact]
        if live and (i % 3 or i >= exact):
            at = int(rng.integers(0, live)) if i % 2 and i < exact else 0
            seg = token[: live - at]
            values[i, at: at + len(seg)] = np.frombuffer(seg, dtype=np.uint8)
    return np.ascontiguousarray(values), np.array(lens, dtype=np.int32)


def non_invariant_tables():
    """Hand-built DFAs whose PAD column changes acceptance (the compiler
    never emits one), as ``CompiledDfa`` keyword arguments:

    - parity: PAD toggles between a rejecting and an accepting state, so
      the verdict hangs on how many PAD columns follow the record; ``a``
      toggles too, ``x`` falls into a dead sink and ``y`` into an
      absorbing accept that PAD sends to the sink;
    - flu[vV]io whose PAD column sends its accepting state to the dead
      state: a match survives only in a record at least as long as the row.
    """
    byte_class = np.zeros(256, dtype=np.int16)
    byte_class[ord("a")], byte_class[ord("x")], byte_class[ord("y")] = 1, 2, 3
    #                   other  a  x  y  EOS PAD
    parity = np.array([[0, 1, 2, 3, 0, 1],   # 0: even, rejects
                       [1, 0, 2, 3, 1, 0],   # 1: odd, accepts
                       [2, 2, 2, 2, 2, 2],   # 2: dead sink
                       [3, 3, 3, 3, 3, 2]],  # 3: absorbing accept, PAD -> sink
                      dtype=np.int16)
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex

    flu = compile_regex("flu[vV]io")
    # PAD gets a column of its own (packed, it shares one with bytes)
    table = np.concatenate([flu.table, flu.table[:, [flu.pad_class]]], axis=1)
    table[flu.accept, -1] = flu.n_states - 1
    return [
        dict(table=parity, byte_class=byte_class, eos_class=4, pad_class=5,
             accept=np.array([False, True, False, True]), start=0, pattern="parity"),
        dict(table=table, byte_class=flu.byte_class.copy(), eos_class=flu.eos_class,
             pad_class=flu.n_classes, accept=flu.accept.copy(), start=flu.start,
             pattern="flu[vV]io, PAD kills the match"),
    ]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value)


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "fluvio_tpu", "yaml")  # the card's machine has no yaml


def test_port_imports_no_jax_and_nothing_of_fluvio_tpu():
    files = sorted((REPO / "fluvio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for module in ("types.py", "partition/runtime.py", "partition/placement.py",
                   "partition/rebalancer.py", "partition/failover.py", "windows/engine.py",
                   "protocol/record.py", "protocol/compression.py", "protocol/lz4_py.py",
                   "schema/smartmodule.py", "spu/smart_chain.py", "native/records.py",
                   "smartmodule/sdk.py", "smartengine/metrics.py", "protocol/api.py",
                   "schema/spu.py", "storage/__init__.py", "storage/config.py",
                   "storage/checkpoint.py", "storage/index.py", "storage/segment.py",
                   "storage/replica.py", "transport/__init__.py", "transport/socket.py",
                   "transport/sink.py", "transport/multiplexing.py", "transport/service.py",
                   "transport/versioned.py", "client/__init__.py", "client/offset.py",
                   "client/consumer.py", "client/fluvio.py", "spu/config.py",
                   "spu/metrics.py", "spu/replica.py", "spu/context.py",
                   "spu/public_service.py", "spu/server.py", "models/dedup_filter.py",
                   "stream_model/core.py", "stream_model/epoch.py", "stream_model/store.py",
                   "metadata/topic.py", "metadata/partition.py", "metadata/spu.py",
                   "metadata/smartmodule.py", "metadata/spg.py", "metadata/tableformat.py",
                   "schema/admin.py", "schema/controlplane.py", "auth/policy.py",
                   "sc/scheduler.py", "sc/context.py", "sc/controllers/topics.py",
                   "sc/controllers/partitions.py", "sc/controllers/spus.py",
                   "sc/services/private_service.py", "sc/services/public_service.py",
                   "sc/start.py", "spu/sc_dispatcher.py", "client/sync.py", "client/admin.py",
                   "client/producer.py", "schema/internal_spu.py", "storage/cleaner.py",
                   "spu/follower.py", "spu/internal_service.py",
                   "spu/cleaner_controller.py", "protocol/native_codecs.py",
                   "transport/tls.py", "client/config.py", "metadata/yaml_subset.py",
                   "metadata/client.py", "metadata/dispatcher.py", "auth/basic.py",
                   "auth/identity.py", "telemetry/__init__.py", "telemetry/histogram.py",
                   "telemetry/spans.py", "telemetry/flow.py", "telemetry/registry.py",
                   "telemetry/prometheus.py", "telemetry/trace.py", "telemetry/timeseries.py",
                   "telemetry/slo.py", "telemetry/memory.py", "telemetry/lag.py",
                   "telemetry/compiles.py", "spu/monitoring.py", "admission/__init__.py",
                   "admission/types.py", "admission/fairness.py", "admission/controller.py",
                   "admission/batcher.py", "admission/warmup.py", "analysis/__init__.py",
                   "analysis/spec.py", "cluster/__init__.py", "cluster/check.py",
                   "smartengine/engine.py", "smartengine/metering.py",
                   "smartengine/hooks.py", "smartengine/gpu/executor.py"):
        assert REPO / "fluvio_tpu_torch" / module in files, module
    bad = [
        f"{path.relative_to(REPO)}:{line}: {module}"
        for path in files
        for line, module in _imported_modules(path)
        if _forbidden(module)
    ]
    assert not bad, bad


def _code_strings(path: Path):
    """(line, text) of every string literal in a module except docstrings."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            yield node.lineno, node.value


def test_port_names_no_path_under_fluvio_tpu():
    files = sorted((REPO / "fluvio_tpu_torch").rglob("*.py"))
    under = re.compile(r"(^|[/\\])fluvio_tpu([/\\]|$)")
    bad = [
        f"{path.relative_to(REPO)}:{line}: {text!r}"
        for path in files
        for line, text in _code_strings(path)
        if under.search(text)
    ]
    assert not bad, bad
    from fluvio_tpu_torch.smartengine.gpu import glz

    assert glz._SOURCE == REPO / "fluvio_tpu_torch" / "native" / "glz.cpp"


def _environment_reads(source: str):
    """(line, text) of every read of the process environment in a module's
    source: ``os.environ`` / ``os.environb`` / ``os.getenv`` /
    ``os.getenvb`` / ``os.putenv``, and those names imported from ``os``."""
    names = ("environ", "environb", "getenv", "getenvb", "putenv")
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.Attribute) and node.attr in names
                and isinstance(node.value, ast.Name) and node.value.id == "os"):
            yield node.lineno, f"os.{node.attr}"
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            for alias in node.names:
                if alias.name in names:
                    yield node.lineno, f"from os import {alias.name}"


def test_port_reads_no_environment():
    # the scan sees each form it looks for
    probe = "import os\nfrom os import getenv\na = os.environ.get('A')\nb = os.getenv('B')\n"
    assert sorted(t for _, t in _environment_reads(probe)) == [
        "from os import getenv", "os.environ", "os.getenv"]
    files = sorted((REPO / "fluvio_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    bad = [
        f"{path.relative_to(REPO)}:{line}: {text}"
        for path in files
        for line, text in _environment_reads(path.read_text(encoding="utf-8"))
    ]
    assert not bad, bad


def test_engine_without_cuda_raises(monkeypatch):
    from fluvio_tpu_torch.smartengine import EngineError, SmartEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError):
        SmartEngine()
    with pytest.raises(EngineError):
        SmartEngine(device="cuda")
    assert SmartEngine(device="cpu").device == "cpu"


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels

    rng = np.random.default_rng(3)
    n, width = 4096, 64
    names = [b"fluvio", b"kafka", b"pulsar", b"flink"]
    docs = [
        b'{"name":"%s-%d","n":%d}' % (names[i % 4], i % 7, i) if i % 5 else
        rng.integers(32, 127, size=int(rng.integers(0, width + 1))).astype(np.uint8).tobytes()
        for i in range(n)
    ]
    values = np.zeros((n, width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, d in enumerate(docs):
        values[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    v = torch.from_numpy(values).cuda()
    ln = torch.from_numpy(lengths).cuda()
    st_k, vl_k = cuda_kernels.json_get_span(v, ln, "name")
    st_p, vl_p = kernels.json_get_span(v, ln, "name")
    assert torch.equal(st_k, st_p) and torch.equal(vl_k, vl_p)
    # both designs of the span kernel: a thread a record up to 512-byte rows,
    # a warp a record past them; widths off the 16-byte grid take byte loads
    alphabet = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)
    for span_width in (64, 100, 512, 544, 1000, 1024):
        span_docs = [
            b'{"pad":"%s","name":"kafka-%d","n":%d}' % (b"p" * int(rng.integers(0, span_width - 40)),
                                                        i, i) if i % 3 == 0 else
            b'{"pad":"%s","n":%d}' % (b"q" * int(rng.integers(0, span_width - 20)), i) if i % 3 == 1
            else alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(0, span_width + 1)))]
            .tobytes()
            for i in range(300)
        ] + [(b'{"name":"' + b"y" * span_width)[:span_width], (b'{"name":' + b"7" * span_width)[:span_width]]
        sv_, sl_ = np.zeros((len(span_docs), span_width), np.uint8), np.zeros(len(span_docs), np.int32)
        for i, d in enumerate(span_docs):
            sv_[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
            sl_[i] = len(d)
        sv_t, sl_t = torch.from_numpy(sv_).cuda(), torch.from_numpy(sl_).cuda()
        for key in ("name", "n", ""):
            got = cuda_kernels.json_get_span(sv_t, sl_t, key)
            want = kernels.json_get_span(sv_t, sl_t, key)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (span_width, key)
    # a 45,000-byte key: the needle takes the kernels past 48 KB of shared memory
    from fluvio_tpu_torch.smartmodule import dsl

    long_key = "k" * 45000
    long_docs = [b'{"' + long_key.encode() + b'":"v"}', b'{"a":1}', b'{"' + long_key.encode() + b'x":2}']
    for span_width in (64, 45016):
        lv = np.zeros((len(long_docs), span_width), np.uint8)
        ll = np.array([min(len(d), span_width) for d in long_docs], np.int32)
        for i, d in enumerate(long_docs):
            lv[i, : ll[i]] = np.frombuffer(d[: ll[i]], dtype=np.uint8)
        st_l, vl_l = cuda_kernels.json_get_span(torch.from_numpy(lv).cuda(),
                                                torch.from_numpy(ll).cuda(), long_key)
        got = [bytes(lv[i, a: a + b]) for i, (a, b) in enumerate(zip(st_l.tolist(), vl_l.tolist()))]
        assert got == [dsl.json_get_bytes(bytes(lv[i, : ll[i]]), long_key) for i in range(3)]
    assert torch.equal(cuda_kernels.extract_span(v, st_k, vl_k), kernels.extract_span(v, st_k, vl_k))
    # extract: random spans (overruns, negative starts, lengths past the
    # width) at widths on and off the 16-byte grid, aligned rows and not
    for ex_width in (1, 3, 15, 16, 17, 63, 64, 65, 100, 1000):
        ev = rng.integers(0, 256, size=(512, ex_width)).astype(np.uint8)
        est = torch.from_numpy(rng.integers(-ex_width - 2, 2 * ex_width + 2, 512).astype(np.int32))
        evl = torch.from_numpy(rng.integers(-2, 2 * ex_width + 2, 512).astype(np.int32))
        buf = torch.zeros(ev.size + 1, dtype=torch.uint8).cuda()
        buf[1:] = torch.from_numpy(ev.reshape(-1)).cuda()
        for vv in (torch.from_numpy(ev).cuda(), buf[1:].view(ev.shape)):
            assert torch.equal(cuda_kernels.extract_span(vv, est.cuda(), evl.cuda()),
                               kernels.extract_span(vv, est.cuda(), evl.cuda())), ex_width
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False)):
        dfa = compile_regex(pattern, packed=packed)
        assert torch.equal(cuda_kernels.dfa_match(v, ln, dfa), kernels.dfa_match(v, ln, dfa))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_long_keys_through_the_engine_on_the_card():
    """A 49,151-byte key (its needle past 48 KB) gives b'1' through
    ``SmartEngine(device="cuda")`` on the narrow and the striped span paths;
    a 240,000-byte key (past a block's shared memory) on the striped path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    for klen, paths in ((49151, ("json_span", "json_span_striped")),
                        (240000, ("json_span_striped",))):
        kb = b"a" * klen
        for path in paths:
            pad = b',"pad":"' + b"x" * 70000 + b'"' if path == "json_span_striped" else b""
            docs = [b'{"' + kb + b'":1' + pad + b"}", b'{"a":2' + pad + b"}"]
            b = SmartEngine(device="cuda").builder()
            b.add_smart_module(SmartModuleConfig(params={"field": kb.decode()}),
                               lookup("json-map"))
            chain = b.initialize().gpu_chain
            cuda_kernels.reset_launches()
            out = chain.process_buffer(RecordBuffer.from_values(docs)).value_list()
            assert cuda_kernels.LAUNCHES[path] > 0, (klen, path)
            assert out[0] == b"1", (klen, path)


@pytest.mark.cuda
def test_striped_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels, stripes
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    rng = np.random.default_rng(4)
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False),
                            ("(a|b)*a(a|b){6}c|x" + "d" * 125, False)):
        dfa = compile_regex(pattern, packed=packed)
        cls = rng.integers(-1, dfa.n_classes, size=(301, 77)).astype(np.int32)
        cls[:, 10:50] = -1
        c = torch.from_numpy(cls).cuda()
        table_t = torch.from_numpy(np.ascontiguousarray(dfa.table.T, dtype=np.int32)).cuda()
        assert torch.equal(cuda_kernels.dfa_compose_columns(c, table_t),
                           kernels.dfa_compose_columns(c, table_t))
    docs = [b'{"pad":"' + b"p" * int(rng.integers(0, 600)) + b'","name":"fluvio-%d"}' % i
            for i in range(200)] + [b'{"name":' + b"7" * 500, b'{"pad":"' + b"q" * 700 + b'"}']
    # late keys over many stripes, missing keys, garbage
    docs += [b'{"pad":"' + b"p" * int(rng.integers(500, 1500)) + b'","name":"late-%d"}' % i
             for i in range(40)]
    docs += [b'{"pad":"' + b"p" * int(rng.integers(500, 1500)) + b'","n":%d}' % i for i in range(20)]
    alphabet = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)
    docs += [alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(40, 800)))].tobytes()
             for _ in range(40)]
    buf = RecordBuffer.from_values(docs)
    flat, _ = buf.ragged_values()
    # 64-byte stripes (16-byte loads) and 68-byte ones (byte loads)
    for width, overlap in ((64, 16), (68, 20)):
        params = stripes.StripeParams(threshold=64, width=width, overlap=overlap)
        lengths = torch.from_numpy(buf.lengths).cuda()
        plan, sv, kmax = stripes.stage_rows(
            torch.from_numpy(np.ascontiguousarray(flat).view(np.int32)).cuda(), lengths,
            buf.lengths, buf.count, params,
            stripes.plan_rows(buf.lengths, buf.count, width, overlap) + 8,
        )
        args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], lengths)
        for key in ("name", "n", ""):
            got = cuda_kernels.striped_json_span(*args, key, kmax, params.step)
            want = kernels.striped_json_span(*args, key, kmax, params.step)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (width, key)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_glz_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
    from fluvio_tpu_torch.smartengine.gpu.executor import pad_glz_tokens

    rng = np.random.default_rng(6)
    docs = b"".join(b'{"name":"fluvio-%d","n":%d}' % (i & 63, rng.integers(0, 9999))
                    for i in range(20000))
    raw = np.frombuffer(docs, np.uint8)
    for chunk in (4096, 16384, 262144):
        comp, reason = glz.compress_link(raw, max_ratio=1.0, chunk=chunk)
        assert comp is not None, reason
        ll, ml, srcs, lits = (torch.from_numpy(a).cuda() for a in pad_glz_tokens(comp))
        base, midx = glz.byte_plan_device(ll, ml, srcs, lits, comp.out_len)
        got = cuda_kernels.glz_resolve(base, midx, chunk)
        assert torch.equal(got, kernels.glz_resolve(base, midx, chunk))
        assert torch.equal(got.cpu(), torch.from_numpy(raw.copy()))
    stream = torch.from_numpy(raw[: len(raw) // 8 * 8].copy()).cuda()
    w0, w1 = glz.enc_group_words(stream)
    # a period-2 stream: every chain crosses every tile border of its chunk
    p0 = torch.from_numpy(np.where(np.arange(150000) % 2 == 0, 7, 9).astype(np.int32)).cuda()
    p1 = torch.zeros_like(p0)
    for a, b in ((w0, w1), (p0, p1)):
        for chunk_groups in (128, 512, 2048, 2176, 32768, 65536, 131072):
            const_m, _ = glz.enc_const_runs(a, b, chunk_groups)
            assert torch.equal(cuda_kernels.glz_encode_match(a, b, const_m, chunk_groups),
                               kernels.glz_encode_match(a, b, const_m, chunk_groups))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_redesigned_kernels_on_the_card():
    """The column-split composition at the geometries its segment length
    gives (T < L, T not a multiple of L, several segments a warp, a
    segment over several warps, several segments a row), and the fused
    token-to-byte decode on padded and bare tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
    from fluvio_tpu_torch.smartengine.gpu.executor import pad_glz_tokens

    rng = np.random.default_rng(44)
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", True),
                            ("(a|b)*a(a|b){2}c", True), ("x" + "d" * 40, True),
                            ("(a|b)*a(a|b){5}c", False),
                            ("(a|b)*a(a|b){6}c|x" + "d" * 125, False)):
        dfa = compile_regex(pattern, packed=packed)
        table_t = torch.from_numpy(np.ascontiguousarray(dfa.table.T, dtype=np.int32)).cuda()
        for rows, t_len in ((301, 77), (40, 20), (17, 1000), (64, 8192)):
            cls = rng.integers(0, dfa.n_classes, size=(rows, t_len)).astype(np.int32)
            cls[::3, t_len // 4: t_len // 2] = -1
            cls[0] = -1
            c = torch.from_numpy(cls).cuda()
            assert torch.equal(cuda_kernels.dfa_compose_columns(c, table_t),
                               kernels.dfa_compose_columns(c, table_t))
    docs = b"".join(b'{"name":"fluvio-%d","n":%d}' % (i & 63, rng.integers(0, 9999))
                    for i in range(20000))
    raw = np.frombuffer(docs, np.uint8)
    for chunk in (4096, 65536, 262144):
        comp, _ = glz.compress_link(raw, max_ratio=1.0, chunk=chunk)
        for arrays in (pad_glz_tokens(comp), comp[:4]):
            ll, ml, srcs, lits = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
            got = cuda_kernels.glz_decode(ll, ml, srcs, lits, comp.out_len, chunk, comp.depth)
            assert torch.equal(got, glz.decode_plain(ll, ml, srcs, lits, comp.out_len, chunk))
            assert torch.equal(got.cpu(), torch.from_numpy(raw.copy()))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dfa_scan_redesign_on_the_card():
    """The DFA scan kernel against its plain version on the cases of its
    CPU spec: the compiled patterns (8 to 257 states, packed and unpacked)
    and the hand-built tables whose PAD column changes acceptance (the
    kernel's tail walk), at every edge length, at widths 1 to 64, on
    16-byte aligned rows and on rows one byte off; a table the kernel does
    not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa, compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels

    dfas = [compile_regex(p, packed=packed) for p, packed in DFA_SCAN_PATTERNS]
    dfas += [CompiledDfa(**t) for t in non_invariant_tables()]
    rng = np.random.default_rng(70)
    for width in DFA_SCAN_WIDTHS:
        values, lengths = dfa_scan_inputs(rng, width)
        v, ln = torch.from_numpy(values).cuda(), torch.from_numpy(lengths).cuda()
        buf = torch.zeros(values.size + 1, dtype=torch.uint8).cuda()
        buf[1:] = v.reshape(-1)
        for dfa in dfas:
            for vv in (v, buf[1:].view(values.shape)):
                assert torch.equal(cuda_kernels.dfa_match(vv, ln, dfa),
                                   kernels.dfa_match(vv, ln, dfa)), (dfa.pattern[:24], width)
    bad = CompiledDfa(**non_invariant_tables()[0])
    bad.table[0, 0] = 9  # a state id past the table
    with pytest.raises(ValueError):
        cuda_kernels.dfa_match(v, ln, bad)
    torch.cuda.synchronize()


def _slice_chain(device: str, *names: str):
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig

    b = SmartEngine(device=device).builder()
    for name in names:
        b.add_smart_module(SmartModuleConfig(params={"field": "n"}), lookup(name))
    return b.initialize().gpu_chain


@pytest.mark.cuda
def test_aggregate_and_explode_chains_on_the_card():
    """`3_aggregate`'s chain (the JSON span and extract kernels launched
    every batch) and ``array-map-json -> aggregate-count`` (the first batch
    overflows and runs again) over three batches through
    ``SmartEngine(device="cuda")``: outputs, keys and carries equal the
    same chains on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    cases = (
        (("aggregate-field",), gen_json, (5000, 17, 3000)),
        (("array-map-json", "aggregate-count"), gen_arrays, (4000, 9, 2500)),
        (("array-map-json",), gen_arrays, (4000, 9, 2500)),
    )
    for names, gen, sizes in cases:
        outs = {}
        for device in ("cpu", "cuda"):
            chain = _slice_chain(device, *names)
            cuda_kernels.reset_launches()
            bufs = [RecordBuffer.from_values(gen(n, seed=n)) for n in sizes]
            outs[device] = [(o.value_list(), o.key_list(), o.offset_deltas[: o.count].tolist())
                            for o in chain.process_stream(bufs)]
            chain._ensure_host_state()
            outs[device].append((chain.carries, chain.redispatches))
        assert outs["cuda"] == outs["cpu"], names
        if names == ("aggregate-field",):
            assert cuda_kernels.LAUNCHES["json_span"] == cuda_kernels.LAUNCHES["extract"] == 3
        else:
            assert outs["cuda"][-1][1] >= 1


@pytest.mark.cuda
def test_first_error_and_mixed_chains_on_the_card():
    """Phase 20's chains through ``SmartEngine(device="cuda")``, each against
    the same chain on the CPU: `FIRST_ERROR_CHAIN` over four ``gen_arrays``
    batches with `FIRST_ERROR_RECORD` planted at the first row of one and a
    middle row of another (outputs, errors, and the count's carry on the
    batches after), and `MIXED_CHAIN` (a card filter, a host hook, a card
    map) over two ``gen_json`` batches. The card re-dispatched each error
    batch and launched the DFA scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.protocol.record import Record
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartmodule.types import SmartModuleInput

    def run(device, specs, batches):
        chain = hook_chain(specs, device)
        outs = []
        for k, values in enumerate(batches):
            out = chain.process(SmartModuleInput.from_records(
                [Record(value=v, offset_delta=i) for i, v in enumerate(values)],
                base_offset=10_000 * k))
            e = out.error
            outs.append(([r.value for r in out.successes],
                         None if e is None else (e.hint, e.offset, e.record_value)))
        return outs, chain

    arrays = [gen_arrays(3000, seed=s) for s in (1, 2, 3, 4)]
    arrays[0][0] = FIRST_ERROR_RECORD
    arrays[2][1700] = FIRST_ERROR_RECORD
    cuda_kernels.reset_launches()
    got, chain = run("cuda", FIRST_ERROR_CHAIN, arrays)
    assert cuda_kernels.LAUNCHES["dfa_scan"] >= 1 and chain.gpu_chain.error_redispatches == 2
    want, _ = run("cpu", FIRST_ERROR_CHAIN, arrays)
    assert got == want
    assert [o[1][1] if o[1] else None for o in got] == [0, None, 21_700, None]
    docs = [gen_json(5000, seed=s) for s in (5, 6)]
    got, chain = run("cuda", MIXED_CHAIN, docs)
    assert chain.backend_in_use == "mixed"
    assert got == run("cpu", MIXED_CHAIN, docs)[0] and all(o[0] for o in got)


STRIPED_SLICE = {
    "striped_aggregate": [("regex-filter", {"regex": "flu[vV]io"}), ("aggregate-sum", {})],
    "striped_explode": [("regex-filter", {"regex": "flu[vV]io"}), ("array-map-lines", {})],
}


DOWN_LINK_MAX = [("aggregate-field", {"field": "n", "combine": "max"})]


def striped_slice_chain(device: str, specs, stripes=None, link=None):
    """A chain on ``device``: a name of `STRIPED_SLICE` or a list of
    (registry name, params)."""
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import (
        LinkParams,
        SmartEngine,
        SmartModuleConfig,
        StripeParams,
    )

    b = SmartEngine(device=device, stripes=stripes or StripeParams(),
                    link=link or LinkParams()).builder()
    for module, params in (STRIPED_SLICE[specs] if isinstance(specs, str) else specs):
        b.add_smart_module(SmartModuleConfig(params=dict(params)), lookup(module))
    return b.initialize().gpu_chain


@pytest.mark.cuda
def test_striped_slice_and_byte_mode_down_link_on_the_card():
    """Both striped slice chains on small stripes (256 bytes overlapping by
    64, records of ~3 KB) over three batches, the explode's first batch
    overflowing, and one byte-mode batch of a settled running max with
    the down link on: the card's outputs, carries and re-runs equal the
    CPU's, `dfa_compose.cu` and `glz_encode.cu` launched, the tokens won."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.smartengine import LinkParams, StripeParams
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    small = StripeParams(threshold=256, width=256, overlap=64)
    corpora = {"striped_aggregate": lambda s: gen_fat_numbers(300, seed=s, body=3000),
               "striped_explode": lambda s: gen_fat_lines(300, seed=s, size=3000)}
    for name, gen in corpora.items():
        outs = {}
        for device in ("cpu", "cuda"):
            chain = striped_slice_chain(device, name, stripes=small)
            cuda_kernels.reset_launches()
            bufs = [RecordBuffer.from_values(gen(s)) for s in (1, 2, 3)]
            outs[device] = [(o.value_list(), o.offset_deltas[: o.count].tolist())
                            for o in chain.process_stream(bufs)]
            chain._ensure_host_state()
            outs[device].append((chain.carries, chain.redispatches))
            assert chain._striped is not None
        assert outs["cuda"] == outs["cpu"], name
        assert cuda_kernels.LAUNCHES["dfa_compose"] == 3, name
    assert outs["cuda"][-1][1] >= 1  # the explode's first batch ran again

    link = LinkParams(result_compress=True, chunk=64 * 1024)
    buf = RecordBuffer.from_values(gen_json(50_000, seed=4))
    got = {}
    for device in ("cpu", "cuda"):
        chain = striped_slice_chain(device, DOWN_LINK_MAX, link=link)
        cuda_kernels.reset_launches()
        out = chain.process_buffer(buf)
        got[device] = (out.value_list(), chain.link_counts["down-glz"])
    assert got["cuda"] == got["cpu"] and got["cuda"][1] == 1
    assert cuda_kernels.LAUNCHES["glz_enc_match"] == 1


def _windowed_rows(values, ts, keyed: bool):
    """(key, contrib, ts) host rows of pure-ASCII int records."""
    if keyed:
        return [(int(v.split(b" ")[0]), int(v.split(b" ")[1]), int(t)) for v, t in zip(values, ts)]
    return [(0, int(v), int(t)) for v, t in zip(values, ts)]


@pytest.mark.cuda
def test_windowed_runtime_on_the_card():
    """The windowed-state engine on the card over a few batches of the
    bench corpora (tumbling and sliding over `gen_ints`, keyed over
    `gen_keyed_ints`; the buffer path and the array seam): the bank equals
    the port's `HostWindowReference` after every batch, the view's table
    at the end, and every delta equals the same runtime's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the windowed runtime runs there")
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
    from fluvio_tpu_torch.windows import (
        HostWindowReference, MaterializedView, WindowSpec, WindowedRuntime)

    cases = (
        (WindowSpec(window_ms=1000), gen_ints, "buffer"),
        (WindowSpec(window_ms=1000, slide_ms=250), gen_ints, "arrays"),
        (WindowSpec(window_ms=1000, keyed=True, emit_capacity=4096), gen_keyed_ints, "buffer"),
    )
    for spec, gen, seam in cases:
        card, cpu = WindowedRuntime(spec), WindowedRuntime(spec, device="cpu")
        ref, view = HostWindowReference(spec), MaterializedView(spec)
        t0 = 1_000_000
        for k, n in enumerate((4096, 1000, 4096)):
            values = gen(n, seed=k)
            ts = t0 + np.arange(n, dtype=np.int64) * 4
            t0 = int(ts[-1]) + 4
            rows = _windowed_rows(values, ts, spec.keyed)
            deltas = []
            for rt in (card, cpu):
                if seam == "buffer":
                    buf = RecordBuffer.from_values(values, base_timestamp=int(ts[0]))
                    buf.timestamp_deltas[:n] = ts - ts[0]
                    deltas.append(rt.process_buffer(buf))
                else:
                    cols = np.array([(c, key, t) for key, c, t in rows], dtype=np.int64).T
                    deltas.append(rt.ingest_arrays(*cols))
            ref.process_batch(rows)
            assert card.bank.snapshot() == ref.bank_entries() == cpu.bank.snapshot(), spec
            for f in ("kind", "watermark", "n_open", "n_closed", "n_late", "delta_bytes"):
                assert getattr(deltas[0], f) == getattr(deltas[1], f), (spec, f)
            for f in ("ids", "accs", "counts", "closed"):
                assert np.array_equal(getattr(deltas[0], f), getattr(deltas[1], f)), (spec, f)
            view.apply_delta(deltas[0])
        assert view.table() == ref.table(), spec
        assert card.bank.device.type == "cuda"


def partitioned_truth(values) -> int:
    """`9_partitioned`'s host truth (`bench.py`): the sum of ``n`` over the
    records holding ``fluvio``, the ones its regex filter keeps."""
    return sum(json.loads(v).get("n", 0) for v in values if b"fluvio" in v)


class _Leader:
    """A stand-in leader replica: its log end offset, which `lag` reads."""

    def __init__(self):
        self.end = 0

    def leo(self) -> int:
        return self.end


def run_partitioned(runtime, bufs, rebalancer_cls, config_cls, topic: str = "bench"):
    """`bench._run_partitioned_config`'s sequence over one partition runtime
    (either package's): a first pass over every partition
    (``process_interleaved``), the lag rebalancer's two ticks (injected
    clock; partition 0's backlog the only lag) moving partition 0 to the
    colder group, then three passes with ``fail_group(0)`` before the
    second, each partition's leader advancing by its batch before a pass
    and its offset after each batch. Returns {outs, moves (the second
    tick's), first_s, pass_s, lags}."""
    stream = [(topic, p, buf) for p, buf in enumerate(bufs)]
    leaders = [_Leader() for _ in bufs]
    for p, leader in enumerate(leaders):
        runtime.offsets.attach_leader(f"{topic}/{p}", leader)

    def one_pass(outs, commit: bool):
        t0 = time.perf_counter()
        for t, p, buf, out in runtime.process_interleaved(list(stream)):
            if commit:
                key = f"{t}/{p}"
                runtime.offsets.advance(key, runtime.offsets.committed(key) + buf.count)
            outs.append(out)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    outs = []
    first_s = one_pass(outs, commit=False)
    clock = [0.0]
    lags = {f"{topic}/0": float(bufs[0].count)}

    def mover(key, group, reason):
        t, _, part = key.rpartition("/")
        return runtime.move_partition(t, int(part), group)

    reb = rebalancer_cls(lambda: runtime.plan, mover,
                         config=config_cls(interval_s=0.0, burn=1.0, cooldown_s=0.0, max_moves=1,
                                           hysteresis=4.0),
                         clock=lambda: clock[0], lag_reader=lambda: dict(lags))
    reb.tick()  # the first sighting seeds the burn baseline
    clock[0] += 1.0
    moves = reb.tick()  # a stalled backlog: hot, so it moves
    pass_s = []
    for r in range(3):
        if r == 1:
            runtime.fail_group(0)
        for leader, buf in zip(leaders, bufs):
            leader.end += buf.count
        pass_s.append(one_pass(outs, commit=True))
    return {"outs": outs, "moves": moves, "first_s": first_s, "pass_s": pass_s,
            "lags": [runtime.offsets.lag(f"{topic}/{p}") for p in range(len(bufs))]}


@pytest.mark.cuda
def test_partitioned_runtime_on_the_card():
    """`9_partitioned`'s sequence on the card (4 partitions of 4,096
    `gen_json` records, 2 groups folded onto the card, the rebalancer's
    move and ``fail_group(0)``): each partition's sum is its host truth
    times 4, outputs and carries equal the same runtime on the CPU, and
    the JSON span and extract kernels launched every batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.partition import (
        PartitionRebalancer, PartitionRuntime, RebalanceConfig, parse_placement_rules,
        plan_placement)
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    values = gen_json(4 * 4096)
    per_part = [values[p::4] for p in range(4)]
    results = {}
    for device in ("cpu", "cuda"):
        b = SmartEngine(device=device).builder()
        b.add_smart_module(SmartModuleConfig(params={"regex": "fluvio"}), lookup("regex-filter"))
        b.add_smart_module(SmartModuleConfig(params={"field": "n", "combine": "add"}),
                           lookup("aggregate-field"))
        plan = plan_placement(parse_placement_rules(".*=spread"),
                              [f"bench/{p}" for p in range(4)], 2)
        runtime = PartitionRuntime(b.initialize().gpu_chain, plan,
                                   devices=["cpu"] if device == "cpu" else None)
        cuda_kernels.reset_launches()
        run = run_partitioned(runtime, [RecordBuffer.from_values(v) for v in per_part],
                              PartitionRebalancer, RebalanceConfig)
        results[device] = ([(o.value_list(), o.offset_deltas[: o.count].tolist())
                            for o in run["outs"]],
                           [runtime.carry_snapshot("bench", p) for p in range(4)],
                           runtime.to_dict(), [m["to"] for m in run["moves"]])
        launches = dict(cuda_kernels.LAUNCHES)
    assert results["cuda"] == results["cpu"]
    assert results["cuda"][3] == [1]
    assert results["cuda"][2]["plan"]["failed"] == [0]
    for p in range(4):
        assert results["cuda"][1][p] == [(4 * partitioned_truth(per_part[p]), 0, True)]
    assert launches["json_span"] == launches["extract"] == 16
    assert runtime.device_of(0) == runtime.device_of(1) and runtime.device_of(0).type == "cuda"


_LOAD_SOURCE_PROBE = """
import builtins, sys
sys.path.insert(0, sys.argv[1])
from tests.test_torch_isolation import NORTH_STAR_FILTER_SM, NORTH_STAR_MAP_SM
from fluvio_tpu_torch.smartmodule import dsl, load_source, sdk
for payload, program in ((NORTH_STAR_FILTER_SM, dsl.FilterProgram),
                         (NORTH_STAR_MAP_SM, dsl.MapProgram)):
    m = load_source(payload)
    assert isinstance(m.dsl_program(m.transform_kind()), program), m
builtins._seen = {}
load_source(
    "__import__('builtins')._seen.update(dsl=dsl, smartmodule=smartmodule)\\n"
    "@smartmodule.filter(dsl=dsl.FilterProgram(predicate=dsl.Value()))\\n"
    "def f(record):\\n"
    "    return True\\n")
assert builtins._seen == {"dsl": dsl, "smartmodule": sdk.smartmodule}, builtins._seen
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "fluvio_tpu")]
assert not bad, bad
print("ok")
"""


def test_load_source_binds_the_port_in_a_fresh_process():
    """An AdHoc payload loads in a process that imports only the port: the
    source sees the port's ``dsl`` and ``smartmodule``, and afterwards
    ``sys.modules`` holds neither the JAX package nor jax."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _LOAD_SOURCE_PROBE, str(REPO)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_broker_payloads_are_the_bench_payloads():
    import bench

    assert NORTH_STAR_FILTER_SM == bench.NORTH_STAR_FILTER_SM
    assert NORTH_STAR_MAP_SM == bench.NORTH_STAR_MAP_SM


@pytest.mark.cuda
def test_broker_slice_on_the_card():
    """The bench's broker chain (from its wire invocations) over one read
    slice of 8 stored batches of 4,096 records, cut into chunks: the card
    encodes the CPU's bytes, through the JSON span kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.protocol.codec import ByteWriter
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleChainMetrics
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.spu import smart_chain

    wires, batches = broker_log(gen_json(8 * 4096), 4096)
    read = slice_reader(wires, batches, 16 << 20)
    got = {}
    for device in ("cpu", "cuda"):
        chain = smart_chain.build_chain(north_star_invocations(), SmartEngine(device=device))
        metrics = SmartModuleChainMetrics()
        cuda_kernels.reset_launches()
        results = list(smart_chain.stream_slices(chain, read, 0, 8 * 4096, 16 << 20, metrics))
        launches = dict(cuda_kernels.LAUNCHES)
        w = ByteWriter()
        for r in results:
            r.records.encode(w)
        got[device] = (w.bytes(), [r.next_offset for r in results])
        assert metrics.fallback_slices == 0 and metrics.fastpath_slices == 1
    assert got["cuda"] == got["cpu"] and got["cuda"][1] == [8 * 4096]
    assert launches["json_span"] >= 1


@pytest.mark.cuda
def test_admission_warm_up_and_batcher_on_the_card():
    """The warm-up on the card pays the chain's first dispatch (builds,
    launches, the allocator's growth for the bucket) and reports no error;
    a real dispatch after `warm_buffer` books no build event; four
    tenants' slices coalesced by the batcher into the warmed bucket and
    split back give the CPU chain's records and offset deltas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch import admission
    from fluvio_tpu_torch.smartengine import SmartEngine
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
    from fluvio_tpu_torch.spu import smart_chain
    from fluvio_tpu_torch.telemetry import TELEMETRY

    chains = {d: smart_chain.build_chain(north_star_invocations(), SmartEngine(device=d))
              for d in ("cpu", "cuda")}
    ex = chains["cuda"].gpu_chain
    report = admission.warm_executor(ex, widths=(100, 70_000), rows=(8, 4096))
    assert report.errors == [] and report.buckets == (128, 81920)
    assert report.launches.get("json_span") and report.launches.get("json_span_striped")
    slices = [RecordBuffer.from_values(gen_json(4096, seed=k)) for k in range(4)]
    twin = admission.warm_buffer(ex, admission.coalesce_buffers(slices)[0])
    assert twin.errors == []
    builds = TELEMETRY.compile_totals()["compiles"]
    got = {}
    for device, chain in chains.items():
        flushes = []
        bt = admission.ShapeBucketBatcher(
            lambda f, c=chain: flushes.append(
                admission.split_output(c.gpu_chain.process_buffer(f.buffer), f.bases)),
            row_target=4 * 4096)
        bt.note_warm("ns", [128])
        cuda_kernels.reset_launches()
        for buf in slices:
            bt.add("ns", buf)
        got[device] = flushes
    assert TELEMETRY.compile_totals()["compiles"] == builds
    assert got["cuda"] == got["cpu"] and len(got["cuda"]) == 1
    assert sum(map(len, got["cuda"][0])) > 0 and cuda_kernels.LAUNCHES["json_span"] >= 1


@pytest.mark.cuda
def test_server_stream_on_the_card(tmp_path):
    """The bench's broker chain through the port's SPU server and client
    over a socket, 8 stored batches of 4,096 records in slices of 64 KiB:
    the server on the card pushes the batches the server on the CPU
    pushes, every slice on the coalesced path, through the JSON span
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    import asyncio

    from fluvio_tpu_torch.client import Fluvio
    from fluvio_tpu_torch.protocol.codec import ByteWriter
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    n = 8 * 4096
    _, batches = broker_log(gen_json(n), 4096)

    async def serve(device: str):
        server = await start_spu_server(tmp_path / device, batches, device=device)
        try:
            client = await Fluvio.connect(server.public_addr)
            consumer = await client.partition_consumer("bench", 0)
            cuda_kernels.reset_launches()
            got, _ = await consume_once(
                consumer, server_consumer_config(north_star_invocations(), 64 << 10))
            launches = dict(cuda_kernels.LAUNCHES)
            await client.close()
        finally:
            await server.stop()
        m = server.ctx.metrics.smartmodule
        assert m.fallback_slices == 0 and m.fastpath_slices == len(got) > 1
        out = []
        for b in got:
            w = ByteWriter()
            b.encode(w)
            out.append(w.bytes())
        return out, launches

    cpu, _ = asyncio.run(serve("cpu"))
    card, launches = asyncio.run(serve("cuda"))
    assert card == cpu
    assert launches["json_span"] >= 1


@pytest.mark.cuda
def test_cluster_consume_by_name_on_the_card(tmp_path):
    """Arm (b) of the smoke's cluster phase at a small size: a port SC and
    SPU, 8 x 4,096 records produced through the SC-routed producer, the
    bench's broker chain pushed by name (namespace form) and consumed by
    name through SC routing in slices of 64 KiB. The cluster on the card
    stores and pushes the records the cluster on the CPU does, every slice
    on the coalesced path, through the JSON span kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.client import Fluvio
    from fluvio_tpu_torch.metadata.topic import TopicSpec
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    values = gen_json(8 * 4096)

    async def run(device: str):
        sc, admin, spus = await boot_torch_cluster(tmp_path / device, device=device)
        try:
            await admin.create_topic("bench", TopicSpec.computed(1))
            await wait_for_replicas(spus[0], "bench", [0])
            modules, invocations = namespace_invocations("north_star")
            for name, source in modules:
                await admin.create_smartmodule(name, source)
                await wait_for_module(spus[0], name)
            client = await Fluvio.connect(sc.public_addr)
            try:
                offsets = await produce_all(client, "bench", [(None, v) for v in values])
                consumer = await client.partition_consumer("bench", 0)
                cuda_kernels.reset_launches()
                got, _ = await consume_once(
                    consumer, server_consumer_config(invocations, 64 << 10))
                launches = dict(cuda_kernels.LAUNCHES)
            finally:
                await client.close()
            m = spus[0].ctx.metrics.smartmodule
            assert m.fallback_slices == 0 and m.fastpath_slices == len(got) > 1
        finally:
            await shutdown_torch_cluster(sc, admin, spus)
        # the producer stamps each batch with the wall clock: compare the
        # records without their timestamps
        records = [(b.base_offset + r.offset_delta, r.key, r.value)
                   for b in got for r in b.memory_records()]
        return offsets, records, launches

    cpu = asyncio.run(asyncio.wait_for(run("cpu"), 300))
    card = asyncio.run(asyncio.wait_for(run("cuda"), 300))
    assert card[0] == cpu[0] == [(0, i) for i in range(len(values))]
    assert card[1] == cpu[1] and 0 < len(card[1]) < len(values)
    assert card[2]["json_span"] >= 1


@pytest.mark.cuda
def test_replicated_failover_on_the_card(tmp_path):
    """Phase 16 of the smoke at a small size: a port SC and three SPUs,
    ``repl`` at rf 3, 8 x 4,096 records produced READ_COMMITTED through
    the SC; both followers hold the leader's bytes; the leader's SPU
    stopped, a follower promoted, the north star consumed by name from it
    through a fresh client. The cluster on the card stores, elects and
    pushes what the cluster on the CPU does, through the JSON span
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.client import Fluvio, ProducerConfig
    from fluvio_tpu_torch.metadata.topic import TopicSpec
    from fluvio_tpu_torch.schema.spu import Isolation
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    values = gen_json(8 * 4096)

    async def run(device: str):
        sc, admin, spus = await boot_torch_cluster(tmp_path / device, 3, device=device)
        live = list(spus)
        try:
            await admin.create_topic("repl", TopicSpec.computed(1, 3))
            obj = await sc.ctx.partitions.wait_action(
                "repl-0", lambda o: o is not None and o.status.resolution.value == "online",
                timeout=CLUSTER_WAIT_S)
            first = next(s for s in spus if s.config.id == obj.spec.leader)
            others = [s for s in spus if s is not first]
            modules, invocations = namespace_invocations("north_star")
            for name, source in modules:
                await admin.create_smartmodule(name, source)
                for s in spus:
                    await wait_for_module(s, name)
            client = await Fluvio.connect(sc.public_addr)
            try:
                offsets = await produce_all(client, "repl", [(None, v) for v in values],
                                            ProducerConfig(isolation=Isolation.READ_COMMITTED,
                                                           timeout_ms=60_000))
            finally:
                await client.close()
            leader = first.ctx.leader_for("repl", 0)
            assert leader.hw() == leader.leo() == len(values), (leader.hw(), leader.leo())
            deadline = time.monotonic() + CLUSTER_WAIT_S
            while not all(s.ctx.follower_for("repl", 0).hw() == len(values) for s in others):
                assert time.monotonic() < deadline, "the followers' HW never reached the LEO"
                await asyncio.sleep(0.02)
            log = replica_log(leader.storage)
            assert all(replica_log(s.ctx.follower_for("repl", 0).storage) == log for s in others)
            await first.stop()
            live.remove(first)
            obj = await sc.ctx.partitions.wait_action(
                "repl-0", lambda o: o is not None and o.spec.leader != first.config.id
                and o.status.resolution.value == "online", timeout=CLUSTER_WAIT_S)
            new = next(s for s in others if s.config.id == obj.spec.leader)
            deadline = time.monotonic() + CLUSTER_WAIT_S
            while new.ctx.leader_for("repl", 0) is None:
                assert time.monotonic() < deadline, "the elected SPU never promoted its replica"
                await asyncio.sleep(0.02)
            client = await Fluvio.connect(sc.public_addr)
            try:
                consumer = await client.partition_consumer("repl", 0)
                cuda_kernels.reset_launches()
                got, _ = await consume_once(
                    consumer, server_consumer_config(invocations, 64 << 10))
                launches = dict(cuda_kernels.LAUNCHES)
            finally:
                await client.close()
            m = new.ctx.metrics.smartmodule
            assert m.fallback_slices == 0 and m.fastpath_slices == len(got) > 1
        finally:
            await shutdown_torch_cluster(sc, admin, live)
        records = [(b.base_offset + r.offset_delta, r.key, r.value)
                   for b in got for r in b.memory_records()]
        return offsets, records, launches

    cpu = asyncio.run(asyncio.wait_for(run("cpu"), 300))
    card = asyncio.run(asyncio.wait_for(run("cuda"), 300))
    assert card[0] == cpu[0] == [(0, i) for i in range(len(values))]
    assert card[1] == cpu[1] and 0 < len(card[1]) < len(values)
    assert card[2]["json_span"] >= 1


async def _secure_cluster_sequence(work, device: str, values):
    """Phase 17 of the smoke at a small size, on ``device``: the secure
    cluster; ``bench-lz4`` and ``bench-snappy`` produced through a profile
    client over TLS; the viewer's create refused; the SC restarted on its
    metadata directory with its metadata intact; the north star consumed
    by name from both topics through a fresh profile client. Returns
    ({topic: the consumed records without timestamps}, the viewer's error
    code, launches)."""
    from fluvio_tpu_torch.client import AdminError, Fluvio
    from fluvio_tpu_torch.metadata.topic import TopicSpec
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels

    sc, spu, profiles = await boot_secure_torch_cluster(work, device=device)
    try:
        client = await Fluvio.connect(config_path=profiles["admin"])
        try:
            admin = await client.admin()
            for codec in ("lz4", "snappy"):
                spec = TopicSpec.computed(1)
                spec.compression_type = codec
                await admin.create_topic(f"bench-{codec}", spec)
                await wait_for_replicas(spu, f"bench-{codec}", [0])
            modules, invocations = namespace_invocations("north_star")
            for name, source in modules:
                await admin.create_smartmodule(name, source)
                await wait_for_module(spu, name)
            await admin.close()
            for codec in ("lz4", "snappy"):
                offsets = await produce_all(client, f"bench-{codec}", [(None, v) for v in values])
                assert offsets == [(0, i) for i in range(len(values))]
        finally:
            await client.close()
        viewer = await Fluvio.connect(config_path=profiles["viewer"])
        try:
            vadmin = await viewer.admin()
            with pytest.raises(AdminError) as refused:
                await vadmin.create_topic("bench-viewer", TopicSpec.computed(1))
            await vadmin.close()
        finally:
            await viewer.close()
        before = cluster_snapshot(sc)
        sc = await restart_secure_sc(sc, [spu.config.id])
        deadline = time.monotonic() + CLUSTER_WAIT_S
        while cluster_snapshot(sc) != before:
            assert time.monotonic() < deadline, "the restarted SC lost metadata"
            await asyncio.sleep(0.02)
        fresh = await Fluvio.connect(config_path=profiles["admin"])
        got = {}
        try:
            cuda_kernels.reset_launches()
            for codec in ("lz4", "snappy"):
                consumer = await fresh.partition_consumer(f"bench-{codec}", 0)
                batches, _ = await consume_once(consumer,
                                                server_consumer_config(invocations, 64 << 10))
                got[codec] = [(b.base_offset + r.offset_delta, r.key, r.value)
                              for b in batches for r in b.memory_records()]
            launches = dict(cuda_kernels.LAUNCHES)
        finally:
            await fresh.close()
        m = spu.ctx.metrics.smartmodule
        assert m.fallback_slices == 0 and m.fastpath_slices >= 2  # a slice or more a topic
    finally:
        await spu.stop()
        await sc.stop()
    return got, refused.value.status.error_code, launches


@pytest.mark.cuda
def test_secure_cluster_restart_on_the_card(tmp_path):
    """Phase 17 of the smoke at a small size: 8 x 4,096 records produced
    over TLS into an lz4 and a snappy topic, the viewer's create refused,
    the SC restarted from its metadata directory, the north star consumed
    by name from both topics. The secure cluster on the card refuses,
    keeps and serves what the one on the CPU does, through the JSON span
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.protocol.error import ErrorCode

    values = gen_json(8 * 4096)
    cpu = asyncio.run(asyncio.wait_for(_secure_cluster_sequence(tmp_path / "cpu", "cpu", values),
                                       300))
    card = asyncio.run(asyncio.wait_for(
        _secure_cluster_sequence(tmp_path / "cuda", "cuda", values), 300))
    assert card[0] == cpu[0] and 0 < len(card[0]["lz4"]) < len(values)
    assert card[0]["lz4"] == card[0]["snappy"]
    assert card[1] == cpu[1] == ErrorCode.PERMISSION_DENIED
    assert card[2]["json_span"] >= 2
