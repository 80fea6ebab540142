"""The port's SPU server and consumer client against the JAX package's, on
the CPU, over real sockets.

Both servers run in one process on ``127.0.0.1:0``, each with its own log
directory: the port's `SpuServer` with ``smart_engine.device="cpu"`` (the
kernels' plain torch versions) and the JAX package's with
``smart_engine.backend="tpu"`` (JAX on the CPU). The same stored batches
(encoded once by the JAX package from seeded corpora: ``gen_json``, keyed
records, an empty batch) are written to both through each leader's
``write_record_set``, and each package's own client consumes with the
same `ConsumerConfig`. Tolerance 0: every pushed batch has the same wire
bytes, and its decoded records the same offsets, timestamps, keys and
values, slice by slice.

Pinned divergences (each test named for it):
- a transform error: the JAX server reruns the slice in its interpreter
  and sends the records before the failing one with the error; the port
  sends the same ``ErrorCode`` with no records;
- a look-back invocation on a module with a DSL program: the JAX server
  serves it (the module has no look_back hook to seed); the port refuses
  every look-back invocation with ``SMARTMODULE_ERROR``, the code the
  JAX server sends for a hook module its TPU backend cannot run.
"""

from __future__ import annotations

import asyncio
import time

import pytest
import torch

from fluvio_tpu.client import ConsumerConfig as RefConsumerConfig
from fluvio_tpu.client import Fluvio as RefFluvio
from fluvio_tpu.client import Offset as RefOffset
from fluvio_tpu.client import ProducerConfig as RefProducerConfig
from fluvio_tpu.protocol import codec as ref_codec
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.protocol.error import ErrorCode as RefErrorCode
from fluvio_tpu.protocol.error import FluvioError as RefFluvioError
from fluvio_tpu.schema import smartmodule as ref_schema
from fluvio_tpu.schema.spu import StreamFetchRequest as RefStreamFetchRequest
from fluvio_tpu.spu import SpuConfig as RefSpuConfig
from fluvio_tpu.spu import SpuServer as RefSpuServer
from fluvio_tpu.spu import smart_chain as ref_sc
from fluvio_tpu.storage.config import ReplicaConfig as RefReplicaConfig
from fluvio_tpu_torch.client import ConsumerConfig, Fluvio, Offset
from fluvio_tpu_torch.protocol import codec, record
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.schema.smartmodule import (
    SmartModuleInvocation,
    SmartModuleInvocationKind,
    SmartModuleInvocationWasm,
)
from fluvio_tpu_torch.schema.spu import StreamFetchRequest
from fluvio_tpu_torch.smartengine import EngineError
from fluvio_tpu_torch.spu import smart_chain as sc
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.server import SpuServer
from tests.test_torch_isolation import (
    FLU_REGEX_SM,
    gen_arrays,
    gen_json,
    north_star_invocations,
    server_consumer_config,
    server_invocations,
    start_spu_server,
)
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401

TOPIC = "bench"

EXPLODE_SM = b"""
@smartmodule.array_map(dsl=dsl.ArrayMapProgram(mode="json_array"))
def explode(record):
    import json
    items = json.loads(record.value)
    if not isinstance(items, list):
        raise ValueError("not a JSON array")
    return [(record.key, i.encode() if isinstance(i, str) else json.dumps(i).encode())
            for i in items]
"""

UPPER_MAP_SM = b"""
@smartmodule.map(dsl=dsl.MapProgram(value=dsl.Upper(arg=dsl.Value())))
def m(record):
    return record.value.upper()
"""


@pytest.fixture(autouse=True, scope="module")
def _leaked_spin_threads_stopped():
    """`tests/test_smartengine.py` can leave a hook thread spinning when its
    kill switch (``FLUVIO_TEST_SPIN_A`` / ``_B`` = ``stop``) is removed
    before the thread reads it; in the same xdist worker that thread
    starves this file's event loops of the GIL. Before this file runs the
    switch is on for half a second (such a thread reads it and returns),
    then off again."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLUVIO_TEST_SPIN_A", "stop")
        mp.setenv("FLUVIO_TEST_SPIN_B", "stop")
        time.sleep(0.5)
    yield


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(ref_sc, "_DISPATCH_CHUNK_ROWS", 64)
    monkeypatch.setattr(sc, "_DISPATCH_CHUNK_ROWS", 64)


def _adhoc(payload: bytes, kind: SmartModuleInvocationKind, **kw) -> SmartModuleInvocation:
    return SmartModuleInvocation(wasm=SmartModuleInvocationWasm.adhoc(payload), kind=kind, **kw)


def _flu_regex():
    """`flu[vV]io` as a Predefined module both servers hold in their local
    store under ``flu-regex``."""
    return [SmartModuleInvocation(wasm=SmartModuleInvocationWasm.predefined("flu-regex"),
                                  kind=SmartModuleInvocationKind.FILTER)]


def _aggregate():
    """`3_aggregate`'s chain, ``aggregate-field(field="n", combine="add")``."""
    return server_invocations("3_aggregate")


def _ref_invocations(invocations):
    """The same invocations as the JAX package decodes them off the wire."""
    out = []
    for inv in invocations:
        w = codec.ByteWriter()
        inv.encode(w)
        out.append(ref_schema.SmartModuleInvocation.decode(ref_codec.ByteReader(w.bytes())))
    return out


def _stored(sizes, seed: int, values=None, keyed: bool = True, ts0: int = 1_000_000):
    """Wire bytes of one stored batch per size, encoded by the JAX package:
    ``gen_json`` values (or ``values``), every third record keyless and
    the others keyed, offset deltas 0.., timestamp deltas ``3 * i`` from
    ``ts0 + 7 * k`` (a size of 0 is an empty batch)."""
    values = values if values is not None else gen_json(sum(sizes), seed=seed)
    wires, pos = [], 0
    for k, n in enumerate(sizes):
        recs = [ref_record.Record(value=values[pos + i],
                                  key=(None if not keyed or i % 3 == 0 else b"k%d" % (i % 17)),
                                  offset_delta=i, timestamp_delta=3 * i) for i in range(n)]
        pos += n
        b = ref_record.Batch.from_records(recs, base_offset=0, first_timestamp=ts0 + 7 * k,
                                          preserve_offsets=True)
        w = ref_codec.ByteWriter()
        b.encode(w)
        wires.append(w.bytes())
    return wires


async def _write_ref(leader, wires):
    for w in wires:
        rs = ref_record.RecordSet()
        rs.add(ref_record.Batch.decode(ref_codec.ByteReader(w), parse_records=False))
        await leader.write_record_set(rs)


def _port_batches(wires):
    return [record.Batch.decode(codec.ByteReader(w), parse_records=False) for w in wires]


async def _write_port(leader, wires):
    for b in _port_batches(wires):
        rs = record.RecordSet()
        rs.add(b)
        await leader.write_record_set(rs)


class Servers:
    """The JAX and the port's servers over the same stored log."""

    def __init__(self, ref: RefSpuServer, port: SpuServer):
        self.ref = ref
        self.port = port

    @classmethod
    async def start(cls, tmp_path, wires, topic: str = TOPIC) -> "Servers":
        ref_dir = tmp_path / "ref"
        config = RefSpuConfig(public_addr="127.0.0.1:0", private_addr="",
                              log_base_dir=str(ref_dir),
                              replication=RefReplicaConfig(base_dir=str(ref_dir)),
                              cleaner_interval_seconds=0)
        config.smart_engine.backend = "tpu"
        ref = RefSpuServer(config)
        await ref.start()
        await _write_ref(ref.ctx.create_replica(topic, 0), wires)
        port = await start_spu_server(tmp_path / "port", _port_batches(wires), device="cpu",
                                      topic=topic)
        for server in (ref, port):
            server.ctx.smartmodules.insert("flu-regex", FLU_REGEX_SM)
        return cls(ref, port)

    async def add_topic(self, topic: str, wires) -> None:
        await _write_ref(self.ref.ctx.create_replica(topic, 0), wires)
        await _write_port(self.port.ctx.create_replica(topic, 0), wires)

    async def append(self, wires, topic: str = TOPIC) -> None:
        await _write_ref(self.ref.ctx.leader_for(topic, 0), wires)
        await _write_port(self.port.ctx.leader_for(topic, 0), wires)

    async def stop(self) -> None:
        await self.port.stop()
        await self.ref.stop()


def _run(tmp_path, wires, body):
    async def main():
        servers = await Servers.start(tmp_path, wires)
        try:
            return await asyncio.wait_for(body(servers), timeout=120)
        finally:
            await servers.stop()

    return asyncio.run(main())


def _view(batch):
    """A pushed batch decoded: (base offset, last offset delta, first
    timestamp, [(offset, timestamp, key, value)])."""
    h = batch.header
    return (batch.base_offset, h.last_offset_delta, h.first_timestamp,
            [(batch.base_offset + r.offset_delta, h.first_timestamp + r.timestamp_delta,
              r.key, r.value) for r in batch.memory_records()])


def _wire(batch, writer) -> bytes:
    w = writer()
    batch.encode(w)
    return w.bytes()


async def _consume(addr, invocations, max_bytes=1 << 20, offset=None, topic=TOPIC,
                   port_client: bool = True):
    """One ``stream_batches`` pass to the log's end with a client of the
    port (or of the JAX package): [(view, wire bytes)] a pushed batch."""
    if port_client:
        client, cfg = await Fluvio.connect(addr), server_consumer_config(invocations, max_bytes)
        start, writer = offset or Offset.beginning(), codec.ByteWriter
    else:
        client = await RefFluvio.connect(addr)
        cfg = RefConsumerConfig(disable_continuous=True, max_bytes=max_bytes,
                                smartmodules=_ref_invocations(invocations))
        start = RefOffset.absolute(offset.inner) if offset is not None else RefOffset.beginning()
        writer = ref_codec.ByteWriter
    try:
        consumer = await client.partition_consumer(topic, 0)
        return [(_view(b), _wire(b, writer))
                async for b in consumer.stream_batches(start, cfg)]
    finally:
        await client.close()


async def _both(servers, invocations, **kw):
    """(the JAX client's pass on the JAX server, the port client's pass on
    the port's server), asserted equal batch by batch."""
    want = await _consume(servers.ref.public_addr, invocations, port_client=False, **kw)
    got = await _consume(servers.port.public_addr, invocations, **kw)
    assert [v for v, _ in got] == [v for v, _ in want]
    assert [b for _, b in got] == [b for _, b in want]
    return got


SIZES = [300, 0, 250, 280, 310, 200]  # an empty batch second


def _fastpath_only(servers, slices_at_least: int):
    m = servers.port.ctx.metrics.smartmodule.to_dict()
    assert m["fallback_slices"] == 0, m
    assert m["fastpath_slices"] >= slices_at_least, m


def test_north_star_stream_equals_the_reference(tmp_path, small_chunks):
    """The bench's broker chain (its AdHoc payloads) in read slices of ~2
    stored batches, each cut into chunks of 64 rows; the port's handler
    dispatches slice k+1 before it pushes slice k."""
    wires = _stored(SIZES, seed=51)

    async def body(servers):
        got = await _both(servers, north_star_invocations(), max_bytes=16_000)
        assert len(got) >= 3
        assert any(r[2] is not None for v, _ in got for r in v[3])  # keys survive
        assert got[-1][0][0] + got[-1][0][1] + 1 == sum(SIZES) + 1  # the empty batch: one offset
        _fastpath_only(servers, len(got))
        phases = list(servers.port.ctx.metrics.slice_phases)
        assert len(phases) == len(got)
        assert {"read", "decode", "stage", "dispatch", "finish", "encode", "push",
                "ack_wait"} <= set(phases[0])

    _run(tmp_path, wires, body)


def test_predefined_regex_filter_equals_the_reference(tmp_path):
    wires = _stored(SIZES, seed=52)

    async def body(servers):
        got = await _both(servers, _flu_regex(), max_bytes=16_000)
        assert sum(len(v[3]) for v, _ in got) > 100
        _fastpath_only(servers, len(got))

    _run(tmp_path, wires, body)


def test_aggregate_across_two_streams_equals_the_reference(tmp_path):
    """`3_aggregate` (stateful, one slice at a time in a worker thread):
    each stream gets a fresh chain, so two streams serve the same running
    sums, on both servers."""
    wires = _stored(SIZES, seed=53)

    async def body(servers):
        first = await _both(servers, _aggregate(), max_bytes=16_000)
        second = await _both(servers, _aggregate(), max_bytes=16_000)
        assert first == second and len(first) >= 3
        assert sum(len(v[3]) for v, _ in first) == sum(SIZES)
        _fastpath_only(servers, 2 * len(first))

    _run(tmp_path, wires, body)


def test_max_bytes_cut_discards_the_speculative_slice(tmp_path, small_chunks, monkeypatch):
    """A ``max_bytes`` that cuts every slice mid-batch: the consume point
    moves inside the slice, the speculative slice read behind it is
    discarded, and the next read starts at the cut."""
    wires = _stored(SIZES, seed=54)
    discarded = []
    real_discard = sc.PendingSlice.discard

    def discard(self, gpu):
        discarded.append(self.read_from)
        real_discard(self, gpu)

    monkeypatch.setattr(sc.PendingSlice, "discard", discard)

    async def body(servers):
        got = await _both(servers, north_star_invocations(), max_bytes=600)
        ends = {sum(SIZES[:k + 1]) + (1 if k >= 1 else 0) for k in range(len(SIZES))}
        cut_ends = [v[0] + v[1] + 1 for v, _ in got]
        assert len(got) > len(SIZES) and set(cut_ends) - ends  # cuts inside stored batches
        assert discarded  # speculative slices dropped unread

    _run(tmp_path, wires, body)


def _stored_offsets(sizes):
    """The offset of each stored value of `_stored(sizes)` in the log (an
    empty batch holds one offset)."""
    out, base = [], 0
    for n in sizes:
        out += range(base, base + n)
        base += max(n, 1)
    return out


def test_absolute_offset_and_a_continuous_stream(tmp_path):
    """Consume from an absolute offset inside a stored batch, then keep a
    continuous stream open while two more batches are written: the
    records after it arrive on both servers alike."""
    values, more_values = gen_json(sum(SIZES), seed=55), gen_json(210, seed=56)
    wires = _stored(SIZES, seed=55, values=values)
    more = _stored([120, 90], seed=56, values=more_values, ts0=2_000_000)
    start, leo = 401, sum(SIZES) + 1  # 401: inside the third stored batch
    initial = sum(b"fluvio" in v for v, o in zip(values, _stored_offsets(SIZES)) if o >= start)
    total = initial + sum(b"fluvio" in v for v in more_values)

    async def collect(consumer, offset, config, out: list):
        async for rec in consumer.stream(offset, config):
            out.append((rec.offset, rec.timestamp, rec.key, rec.value))

    async def until(cond):
        while not cond():
            await asyncio.sleep(0.02)

    async def body(servers):
        got = await _both(servers, _flu_regex(), offset=Offset.absolute(start))
        assert got[0][0][0] < start  # a slice starts at its stored batch's base
        ref_client = await RefFluvio.connect(servers.ref.public_addr)
        port_client = await Fluvio.connect(servers.port.public_addr)
        ref_out, port_out = [], []
        tasks = [
            asyncio.ensure_future(collect(
                await ref_client.partition_consumer(TOPIC, 0), RefOffset.absolute(start),
                RefConsumerConfig(smartmodules=_ref_invocations(north_star_invocations())),
                ref_out)),
            asyncio.ensure_future(collect(
                await port_client.partition_consumer(TOPIC, 0), Offset.absolute(start),
                ConsumerConfig(smartmodules=north_star_invocations()), port_out)),
        ]
        try:
            await until(lambda: len(ref_out) == len(port_out) == initial)
            await servers.append(more)
            await until(lambda: len(ref_out) == len(port_out) == total)
            await asyncio.sleep(0.1)  # nothing more arrives
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await ref_client.close()
            await port_client.close()
        assert port_out == ref_out and len(port_out) == total > initial
        assert port_out[0][0] >= start and port_out[-1][0] >= leo

    _run(tmp_path, wires, body)


def test_plain_consume_fetch_and_fetch_offsets(tmp_path):
    """No chain: the stored batches go out as they are (the file slice),
    a one-shot Fetch, and the offsets, alike on both servers."""
    from fluvio_tpu.schema.spu import FetchRequest as RefFetchRequest
    from fluvio_tpu_torch.schema.spu import FetchRequest

    wires = _stored(SIZES, seed=57)

    async def body(servers):
        got = await _both(servers, [])
        values = [r[3] for v, _ in got for r in v[3]]
        assert values == gen_json(sum(SIZES), seed=57)
        ref_client = await RefFluvio.connect(servers.ref.public_addr)
        port_client = await Fluvio.connect(servers.port.public_addr)
        try:
            ref_c = await ref_client.partition_consumer(TOPIC, 0)
            port_c = await port_client.partition_consumer(TOPIC, 0)
            ro, po = await ref_c.fetch_offsets(), await port_c.fetch_offsets()
            assert (po.start_offset, po.hw, po.leo) == (ro.start_offset, ro.hw, ro.leo) == (
                0, sum(SIZES) + 1, sum(SIZES) + 1)
            rf = await ref_c._socket.send_receive(RefFetchRequest(topic=TOPIC, fetch_offset=300,
                                                                  max_bytes=20_000))
            pf = await port_c._socket.send_receive(FetchRequest(topic=TOPIC, fetch_offset=300,
                                                                max_bytes=20_000))
            assert pf.partition.high_watermark == rf.partition.high_watermark
            assert [_wire(b, codec.ByteWriter) for b in pf.partition.records.batches] == [
                _wire(b, ref_codec.ByteWriter) for b in rf.partition.records.batches]
            assert len(pf.partition.records.batches) == 2  # the empty batch and the next
        finally:
            await ref_client.close()
            await port_client.close()

    _run(tmp_path, wires, body)


async def _stream_error(addr, invocations, partition: int = 0, port_client: bool = True,
                        topic: str = TOPIC):
    """The client's error on a stream with ``invocations``, and its
    connection still answering fetch_offsets afterwards."""
    if port_client:
        client, cfg = await Fluvio.connect(addr), server_consumer_config(invocations, 1 << 20)
        start, err = Offset.beginning(), FluvioError
    else:
        client = await RefFluvio.connect(addr)
        cfg = RefConsumerConfig(disable_continuous=True,
                                smartmodules=_ref_invocations(invocations))
        start, err = RefOffset.beginning(), RefFluvioError
    try:
        consumer = await client.partition_consumer(topic, partition)
        with pytest.raises(err) as e:
            async for _ in consumer.stream_batches(start, cfg, start=0, end_at=None):
                pass
        if partition == 0:
            await consumer.fetch_offsets()  # the connection stays up
        return int(e.value.code), e.value.message
    finally:
        await client.close()


async def _both_errors(servers, invocations, **kw):
    ref_code, _ = await _stream_error(servers.ref.public_addr, invocations, port_client=False,
                                      **kw)
    code, message = await _stream_error(servers.port.public_addr, invocations, **kw)
    assert code == ref_code
    return ErrorCode(code), message


def test_unknown_partition_and_missing_module_errors(tmp_path):
    wires = _stored([40], seed=58)

    async def body(servers):
        code, _ = await _both_errors(servers, [], partition=3)
        assert code == ErrorCode.NOT_LEADER_FOR_PARTITION
        missing = [SmartModuleInvocation(wasm=SmartModuleInvocationWasm.predefined("nope"),
                                         kind=SmartModuleInvocationKind.FILTER)]
        code, message = await _both_errors(servers, missing)
        assert code == ErrorCode.SMARTMODULE_NOT_FOUND and "nope" in message
        for lookback_last in (0, 4):  # the seeded dedup-filter: hooks only, no DSL
            dedup = [SmartModuleInvocation(
                wasm=SmartModuleInvocationWasm.predefined("dedup-filter"),
                kind=SmartModuleInvocationKind.FILTER, lookback_last=lookback_last)]
            code, _ = await _both_errors(servers, dedup)
            assert code == ErrorCode.SMARTMODULE_ERROR

    _run(tmp_path, wires, body)


def test_look_back_divergence_is_pinned(tmp_path):
    """A DSL module invoked with a look-back: the JAX server serves it (the
    module exports no look_back hook to seed); the port refuses the
    look-back with SMARTMODULE_ERROR rather than serve without it."""
    wires = _stored([60, 40], seed=59)
    invocations = _flu_regex()
    invocations[0].lookback_last = 3

    async def body(servers):
        served = await _consume(servers.ref.public_addr, invocations, port_client=False)
        assert served and served[0][0][3]
        code, message = await _stream_error(servers.port.public_addr, invocations)
        assert code == ErrorCode.SMARTMODULE_ERROR and "look-back" in message

    _run(tmp_path, wires, body)


def test_transform_error_divergence_is_pinned(tmp_path):
    """An explode meets a record that is no JSON array: both clients get
    SMARTMODULE_RUNTIME_ERROR and their connections stay up. On the wire
    the JAX server's error response carries the 30 records before the
    failing one (its interpreter's rerun) and their next offset; the
    port's carries no records and no next offset."""
    arrays = gen_arrays(10, seed=37)
    wires = _stored([10], seed=0, values=arrays[:5] + [b'{"no":1}'] + arrays[5:9], keyed=False)
    invocations = [_adhoc(EXPLODE_SM, SmartModuleInvocationKind.ARRAY_MAP)]

    async def raw(addr, port_client: bool):
        if port_client:
            client, req = await Fluvio.connect(addr), StreamFetchRequest(
                topic="arrays", smartmodules=invocations)
        else:
            client, req = await RefFluvio.connect(addr), RefStreamFetchRequest(
                topic="arrays", smartmodules=_ref_invocations(invocations))
        try:
            consumer = await client.partition_consumer("arrays", 0)
            stream = await consumer._socket.create_stream(req)
            resp = await stream.next()
            await stream.close()
            return resp.partition
        finally:
            await client.close()

    async def body(servers):
        await servers.add_topic("arrays", wires)
        code, message = await _both_errors(servers, invocations, topic="arrays")
        assert code == ErrorCode.SMARTMODULE_RUNTIME_ERROR and message
        ref_part = await raw(servers.ref.public_addr, port_client=False)
        port_part = await raw(servers.port.public_addr, port_client=True)
        assert int(port_part.error_code) == int(ref_part.error_code) == int(
            RefErrorCode.SMARTMODULE_RUNTIME_ERROR)
        assert ref_part.records.total_records() == 30 and ref_part.next_filter_offset == 10
        assert port_part.records.total_records() == 0 and port_part.next_filter_offset == -1
        assert port_part.error_message

    _run(tmp_path, wires, body)


def test_acquire_stream_chain_caches_stateless_chains_only(tmp_path):
    """The SPU's chain cache: a second stateless stream gets the cached
    instance, a stateful one a fresh instance each time, on both
    packages; a look-back invocation raises on the port."""
    wires = _stored([20], seed=60)

    async def body(servers):
        for ctx, acquire, convert in ((servers.port.ctx, sc.acquire_stream_chain, list),
                                      (servers.ref.ctx, ref_sc.acquire_stream_chain,
                                       _ref_invocations)):
            a = acquire(convert(north_star_invocations()), ctx, 23)
            b = acquire(convert(north_star_invocations()), ctx, 23)
            c = acquire(convert(north_star_invocations()), ctx, 22)
            assert a is b and c is not a
            s1 = acquire(convert(_aggregate()), ctx, 23)
            s2 = acquire(convert(_aggregate()), ctx, 23)
            assert s1 is not s2 and len(ctx.stream_chains) == 2
        look = _flu_regex()
        look[0].lookback_age_ms = 1000
        with pytest.raises(EngineError, match="look-back"):
            sc.acquire_stream_chain(look, servers.port.ctx)

    _run(tmp_path, wires, body)


def test_wire_compatibility_both_ways(tmp_path, small_chunks):
    """The JAX client consumes from the port's server and the port's
    client from the JAX server, alike; the JAX producer writes through
    the port's `handle_produce` with a map chain (on the card's path) and
    the port's client reads back what the JAX server stores for the same
    produce."""
    wires = _stored(SIZES, seed=61)

    async def produce(addr):
        client = await RefFluvio.connect(addr)
        try:
            producer = await client.topic_producer(TOPIC, config=RefProducerConfig(
                smartmodules=_ref_invocations([_adhoc(UPPER_MAP_SM,
                                                      SmartModuleInvocationKind.MAP)])))
            futs = [await producer.send(None if i % 2 else b"key%d" % i, b"value-%d" % i)
                    for i in range(25)]
            await producer.flush()
            offsets = [(await f.wait()).offset for f in futs]
            await producer.close()
            return offsets
        finally:
            await client.close()

    async def body(servers):
        ns = north_star_invocations()
        port_on_ref = await _consume(servers.ref.public_addr, ns, max_bytes=16_000)
        ref_on_port = await _consume(servers.port.public_addr, ns, max_bytes=16_000,
                                     port_client=False)
        native = await _both(servers, ns, max_bytes=16_000)
        assert port_on_ref == native and [v for v, _ in ref_on_port] == [v for v, _ in native]
        assert await produce(servers.port.public_addr) == await produce(servers.ref.public_addr)
        leo = sum(SIZES) + 1
        after = []
        for addr, port_client in ((servers.port.public_addr, True),
                                  (servers.ref.public_addr, True),
                                  (servers.port.public_addr, False)):
            got = await _consume(addr, [], offset=Offset.absolute(leo), port_client=port_client)
            after.append([(o, k, v) for view, _ in got for o, _, k, v in view[3] if o >= leo])
        assert after[0] == after[1] == after[2]
        assert [v for _, _, v in after[0]] == [b"VALUE-%d" % i for i in range(25)]
        assert servers.port.ctx.metrics.inbound.to_dict()["records"] == 25

    _run(tmp_path, wires, body)


def test_leader_chain_transforms_every_produce(tmp_path):
    """A chain attached to a leader (``sm_chain``) runs over every produced
    record set before the append, on the port as on the JAX package."""
    wires = _stored([30], seed=62)

    async def body(servers):
        inv = [_adhoc(FLU_REGEX_SM, SmartModuleInvocationKind.FILTER)]
        servers.port.ctx.leader_for(TOPIC, 0).sm_chain = sc.build_chain(
            inv, servers.port.ctx.engine)
        servers.ref.ctx.leader_for(TOPIC, 0).sm_chain = ref_sc.build_chain(
            _ref_invocations(inv), servers.ref.ctx)
        await servers.append(_stored([40, 35], seed=63, ts0=3_000_000))
        got = await _both(servers, [], offset=Offset.absolute(30))
        values = [r[3] for v, _ in got for r in v[3]]
        assert values and all(b"flu" in v.lower() for v in values)
        assert sum(len(v[3]) for v, _ in got) < 75

    _run(tmp_path, wires, body)


def test_server_without_cuda_raises_and_the_client_refuses_an_sc(tmp_path, monkeypatch):
    """Without CUDA and without ``device="cpu"`` the SPU server raises.
    The client tells an SC from a lone SPU by the SC's admin api key: it
    refused an SC endpoint until the port had the cluster path; now it
    connects to the port's SC in SC mode (a metadata mirror) and to a lone
    SPU with none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError):
        SpuServer(SpuConfig(public_addr="127.0.0.1:0", log_base_dir=str(tmp_path)))

    async def modes():
        from fluvio_tpu_torch.sc import ScServer

        sc = ScServer()
        await sc.start()
        server = await start_spu_server(tmp_path, [], device="cpu")
        try:
            on_sc, on_spu = await Fluvio.connect(sc.public_addr), await Fluvio.connect(
                server.public_addr)
            assert on_sc.metadata is not None and on_spu.metadata is None
            await on_sc.close()
            await on_spu.close()
        finally:
            await server.stop()
            await sc.stop()

    asyncio.run(asyncio.wait_for(modes(), 30))


@pytest.mark.parametrize("cancels", [1, 2, 3])
def test_cancelled_slice_step_never_closes_a_running_generator(cancels):
    """`public_service._next_slice` under ``cancels`` cancels (a stream
    ended, then the loop's shutdown): it raises only once the step in its
    worker thread has ended, so the generator can be closed after it."""
    import threading
    from types import SimpleNamespace

    from fluvio_tpu_torch.spu import public_service

    started, release = threading.Event(), threading.Event()

    def slices():
        started.set()
        release.wait(10)
        yield "slice"

    gen = slices()

    async def body():
        task = asyncio.ensure_future(public_service._next_slice(SimpleNamespace(), gen))
        while not started.is_set():
            await asyncio.sleep(0.005)
        for _ in range(cancels):
            task.cancel()
            await asyncio.sleep(0.02)
        assert not task.done()  # the step still runs
        release.set()
        with pytest.raises(asyncio.CancelledError):
            await task
        gen.close()  # not running: closing it raises nothing

    asyncio.run(body())
