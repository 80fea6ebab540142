"""SPU public API service: produce / fetch / stream-fetch / offsets.

The port's copy of ``fluvio_tpu/spu/public_service.py`` (parity:
fluvio-spu/src/services/public/): the per-connection dispatch loop,
`handle_produce`, `handle_fetch`, `handle_fetch_offsets`,
`handle_update_offsets`, and `StreamFetchHandler`, whose select loop reads
a bounded slice from storage, runs it through the chain on the card,
pushes the wire batches and waits for the consumer's ack.

A stream with a chain is served by `smart_chain.stream_slices` over the
stored log (`StreamFetchHandler._serve_chain`), one step at a time in a
worker thread under the chain's lock, each slice pushed and acked before
the next step. A stateless chain (`smart_chain.gpu_pipelinable`) is
served dispatch-ahead: slice k+1 is read, staged and dispatched before
slice k is finished, encoded and pushed, so the card works under the
socket send and the ack wait. Other chains run one slice at a time
through `process_batches`; a slice whose data the coalesced path declines
goes through `process_batches_per_record`, on the card too.

A produce to a topic whose config carries a deduplication filter first
attaches the topic's dedup chain to the leader, under its write lock,
seeded by a look-back from its log (`smart_chain.ensure_dedup_chain`);
the leader runs every produced record set through it before the append.
A ``READ_COMMITTED`` produce is answered once the leader's HW
covers the write, which with a replica set of more than one waits for the
followers' acks (`_wait_for_hw`), or once ``timeout_ms`` has passed: the
reference answers then too, with the offsets written.

A stream's chain runs its modules' ``look_back`` hooks over the leader's
log before its first slice, in a worker thread (`smart_chain.
chain_look_back`).

Errors: a chain that does not resolve or build, a look-back hook out of
fuel, a `GpuSpill` or `EngineError` from the card, or any other failure of
a slice's chain reaches the consumer as the stream error response the
reference sends (`_smartmodule_error_code`), the stream ends and the
connection stays up. A look-back hook that raises
(`SmartModuleLookbackError`) ends the stream with no response, as the
reference's handler does (it logs the error). A transform error is the
slice's output: the records before the failing one, the error and the
next offset, then the stream ends.

Telemetry (the reference's seams): a stream registers its
``chain@topic/partition`` key (``stream@topic/partition`` without a chain)
with the lag engine, seeds its committed offset at the resolved start and
moves it with each consumer ack; each served slice books its records and
one record-age observation under that key and under the tenant label (the
topic's prefix before its first dot); each slice of a chain stream has a
`SliceFlow` from its arrival to its push.

Admission (the reference's front door, `fluvio_tpu_torch.admission`):
with the process's gate armed, each slice of a chain stream is admitted
before its read (`smart_chain.admission_check`, asked inside
`stream_slices`). A shed slice is HELD: the generator yields a
`smart_chain.SliceHold` and the handler waits ``retry_after_s`` (at least
5 ms, at most 250 ms) on the event loop, where it keeps seeing the
connection's end and the consumer's acks, before the next step asks again
at the same offset; nothing is lost or read twice. While a slice is held
the ``held_slices`` gauge counts it and the tenant's held count moves
once; its release books the hold on the ``hold`` slice phase and on the
slice's flow, which was born at the slice's arrival and carries the
decision. A chain attached to a stream is warmed once
(`_schedule_chain_warmup`): a fresh stateless chain with one 2-record
batch by default, or, with ``AdmissionConfig.warmup``, the whole
shape-bucket warm-up (`admission.warmup.warm_executor`) behind the serve
gate, which sheds ``cold-chain`` until the warm is done.
"""

from __future__ import annotations

import asyncio
import logging
import time
import weakref
from typing import Dict, Optional

from fluvio_tpu_torch.protocol.api import (
    ApiVersionKey,
    ApiVersionsRequest,
    ApiVersionsResponse,
    ResponseMessage,
    decode_request_header,
)
from fluvio_tpu_torch.protocol.codec import ByteWriter
from fluvio_tpu_torch.protocol.error import ErrorCode, FluvioError
from fluvio_tpu_torch.schema.spu import (
    FetchablePartitionResponse,
    FetchOffsetsRequest,
    FetchOffsetsResponse,
    FetchRequest,
    FetchResponse,
    Isolation,
    OffsetUpdateStatus,
    PartitionProduceResponse,
    ProduceRequest,
    ProduceResponse,
    SpuServerApiKey,
    StreamFetchRequest,
    StreamFetchResponse,
    TopicProduceResponse,
    UpdateOffsetsRequest,
    UpdateOffsetsResponse,
)
from fluvio_tpu_torch.smartengine.engine import EngineError, SmartModuleChainInitError
from fluvio_tpu_torch.smartengine.gpu.executor import GpuSpill
from fluvio_tpu_torch.smartengine.metering import SmartModuleFuelError
from fluvio_tpu_torch.spu.context import GlobalContext
from fluvio_tpu_torch.spu.replica import LeaderReplicaState
from fluvio_tpu_torch.spu.smart_chain import (
    BatchProcessResult,
    SliceHold,
    SmartModuleResolutionError,
    _admission_gate,
    acquire_stream_chain,
    admission_chain_sig,
    admission_check,
    admission_note_warm,
    admission_require_warm,
    apply_chain,
    build_chain,
    chain_look_back,
    ensure_dedup_chain,
    stream_slices,
)
from fluvio_tpu_torch.telemetry import TELEMETRY
from fluvio_tpu_torch.telemetry import lag as lag_mod
from fluvio_tpu_torch.telemetry.registry import tenant_label
from fluvio_tpu_torch.transport.service import FluvioService
from fluvio_tpu_torch.transport.sink import ExclusiveSink, FluvioSink
from fluvio_tpu_torch.transport.socket import FluvioSocket, SocketClosed
from fluvio_tpu_torch.types import OffsetPublisher, StickyEvent

logger = logging.getLogger(__name__)

SPU_API_KEYS = [
    ApiVersionKey(SpuServerApiKey.API_VERSION, 0, 0),
    ApiVersionKey(SpuServerApiKey.PRODUCE, 0, ProduceRequest.MAX_API_VERSION),
    ApiVersionKey(SpuServerApiKey.FETCH, 0, FetchRequest.MAX_API_VERSION),
    ApiVersionKey(SpuServerApiKey.FETCH_OFFSETS, 0, 0),
    ApiVersionKey(SpuServerApiKey.STREAM_FETCH, 0, StreamFetchRequest.MAX_API_VERSION),
    ApiVersionKey(SpuServerApiKey.UPDATE_OFFSETS, 0, 0),
]


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


class ConnectionContext:
    """Per-connection state: push streams and their consumer-ack buses."""

    def __init__(self) -> None:
        self.next_stream_id = 1
        self.ack_publishers: Dict[int, OffsetPublisher] = {}
        self.stream_tasks: Dict[int, asyncio.Task] = {}
        self.end = StickyEvent()

    def allocate_stream(self) -> tuple[int, OffsetPublisher]:
        sid = self.next_stream_id
        self.next_stream_id += 1
        pub = OffsetPublisher(-1)
        self.ack_publishers[sid] = pub
        return sid, pub

    async def shutdown(self) -> None:
        self.end.notify()
        for task in self.stream_tasks.values():
            task.cancel()
        if self.stream_tasks:
            await asyncio.gather(*self.stream_tasks.values(), return_exceptions=True)
        self.stream_tasks.clear()


class SpuPublicService(FluvioService[GlobalContext]):
    async def respond(self, ctx: GlobalContext, socket: FluvioSocket) -> None:
        sink = ExclusiveSink(FluvioSink(socket.writer))
        conn = ConnectionContext()
        try:
            while True:
                try:
                    frame = await socket.read_frame()
                except SocketClosed:
                    break
                header, reader = decode_request_header(frame)
                key = header.api_key
                version = header.api_version
                cid = header.correlation_id

                if key == SpuServerApiKey.API_VERSION:
                    ApiVersionsRequest.decode(reader, version)
                    resp = ApiVersionsResponse(api_keys=list(SPU_API_KEYS))
                elif key == SpuServerApiKey.PRODUCE:
                    req = ProduceRequest.decode(reader, version)
                    resp = await handle_produce(ctx, req)
                elif key == SpuServerApiKey.FETCH:
                    req = FetchRequest.decode(reader, version)
                    resp = handle_fetch(ctx, req)
                elif key == SpuServerApiKey.FETCH_OFFSETS:
                    req = FetchOffsetsRequest.decode(reader, version)
                    resp = handle_fetch_offsets(ctx, req)
                elif key == SpuServerApiKey.UPDATE_OFFSETS:
                    req = UpdateOffsetsRequest.decode(reader, version)
                    resp = handle_update_offsets(conn, req)
                elif key == SpuServerApiKey.STREAM_FETCH:
                    req = StreamFetchRequest.decode(reader, version)
                    start_stream_fetch(ctx, conn, req, version, cid, sink)
                    continue  # responses are pushed by the stream task
                else:
                    logger.warning("unknown api key %s", key)
                    break

                await sink.send_response(ResponseMessage(cid, resp), version)
        finally:
            await conn.shutdown()


# ---------------------------------------------------------------------------
# Produce
# ---------------------------------------------------------------------------


async def handle_produce(ctx: GlobalContext, req: ProduceRequest) -> ProduceResponse:
    chain = None
    if req.smartmodules:
        try:
            chain = await asyncio.to_thread(
                build_chain, req.smartmodules, ctx.engine, ctx.smartmodules
            )
        except (SmartModuleResolutionError, EngineError) as e:
            return _produce_error_response(req, _smartmodule_error_code(e), str(e))

    response = ProduceResponse()
    for topic_data in req.topics:
        topic_resp = TopicProduceResponse(name=topic_data.name)
        response.responses.append(topic_resp)
        for pdata in topic_data.partitions:
            presp = PartitionProduceResponse(partition_index=pdata.partition_index)
            topic_resp.partitions.append(presp)
            leader = ctx.leader_for(topic_data.name, pdata.partition_index)
            if leader is None:
                presp.error_code = ErrorCode.NOT_LEADER_FOR_PARTITION
                presp.error_message = (
                    f"{topic_data.name}-{pdata.partition_index} has no leader here"
                )
                continue
            try:
                await ensure_dedup_chain(ctx, leader)
            except SmartModuleResolutionError as e:
                presp.error_code = e.code
                presp.error_message = e.message
                continue
            except Exception as e:  # noqa: BLE001 — the chain's init boundary
                presp.error_code = ErrorCode.SMARTMODULE_CHAIN_INIT_ERROR
                presp.error_message = str(e)
                continue
            records = pdata.records
            if chain is not None:
                try:
                    records, err = await _chain_off_loop(
                        chain, apply_chain, chain, records, ctx.metrics.smartmodule
                    )
                except (GpuSpill, EngineError) as e:
                    err = e
                if err is not None:
                    presp.error_code = ErrorCode.SMARTMODULE_RUNTIME_ERROR
                    presp.error_message = str(err)
                    continue
            try:
                nbytes = sum(b.write_size() for b in records.batches)
                base = await leader.write_record_set(records)
            except FluvioError as e:
                presp.error_code = e.code
                presp.error_message = str(e)
                continue
            presp.base_offset = base
            ctx.metrics.inbound.add(records.total_records(), nbytes)
            if req.isolation == Isolation.READ_COMMITTED:
                await _wait_for_hw(leader, leader.leo(), req.timeout_ms)
    return response


async def _wait_for_hw(leader: LeaderReplicaState, target: int, timeout_ms: int) -> None:
    """Block until the HW reaches ``target`` or ``timeout_ms`` passes
    (read-committed produce acks)."""
    if leader.hw() >= target:
        return
    listener = leader.hw_publisher.change_listener()
    deadline = asyncio.get_running_loop().time() + timeout_ms / 1000
    while leader.hw() < target:
        remaining = deadline - asyncio.get_running_loop().time()
        if remaining <= 0:
            return
        try:
            await asyncio.wait_for(listener.listen(), timeout=remaining)
        except asyncio.TimeoutError:
            return


def _chain_lock(chain) -> asyncio.Lock:
    """The chain's lock: a cached stateless chain is shared by streams,
    and its executor runs one slice at a time."""
    lock = getattr(chain, "_exec_lock", None)
    if lock is None:
        lock = chain._exec_lock = asyncio.Lock()
    return lock


async def _chain_off_loop(chain, fn, *args):
    """Run a blocking chain pass in a worker thread, under the chain's
    lock, so the loop keeps serving every other connection."""
    async with _chain_lock(chain):
        return await asyncio.to_thread(fn, *args)


async def _next_slice(chain, slices):
    """The next result of a `stream_slices` generator (None at its end),
    taken as `_chain_off_loop` runs a pass. A cancelled stream still waits
    for the step to end, through further cancels too (a loop's shutdown
    cancels every task again): the generator is never closed while it
    runs."""
    async with _chain_lock(chain):
        step = asyncio.ensure_future(asyncio.to_thread(next, slices, None))
        try:
            return await asyncio.shield(step)
        except asyncio.CancelledError:
            while not step.done():
                try:
                    await asyncio.wait([step])
                except asyncio.CancelledError:
                    pass
            raise


_warmed_chains: "weakref.WeakSet" = weakref.WeakSet()
# the warm tasks in flight (the loop keeps only weak references to tasks)
_warm_tasks: set = set()


def _schedule_chain_warmup(chain) -> Optional[asyncio.Task]:
    """Pay a chain's first-dispatch costs off the hot path, once a chain
    instance. Two regimes, as the reference's:

    - **Admission warm-up** (``AdmissionConfig.warmup``): the shape-bucket
      work-list walk (`admission.warmup.warm_executor`) — every bucket of
      the probe grid paid at attach, the warmed buckets registered with
      the admission controller (the serve gate sheds ``cold-chain`` until
      then), stateful chains warmed behind the carry save and restore;
    - **tiny warm** (default): one 2-record buffer pays the fixed
      per-chain costs; stateless chains only (a warm record would race
      the carries).

    The warm runs on a worker thread under the chain's lock
    (`_chain_lock`), so it never races a stream's step on the same
    executor. Returns its task (None when nothing is warmed, or without a
    running loop, where it warms inline). A caller that yields once after
    scheduling lets the tiny warm take the lock before its stream's first
    step; the serve-gate warm yields once more first, so that step sheds
    ``cold-chain`` (the stream is held) and the warm runs after it. The
    serve gate lifts on every outcome: warmed buckets registered, or
    (nothing warmed, or the warm raised) explicitly un-gated, never armed
    forever. A failed warm is logged at warning
    level; its probes' failures are in its report and booked as telemetry
    events (`admission.warmup`)."""
    from fluvio_tpu_torch.admission import warmup as adm_warmup

    gpu = chain.gpu_chain
    aot = adm_warmup.warmup_enabled()
    if gpu is None or (gpu.agg_configs and not aot) or chain in _warmed_chains:
        return None
    _warmed_chains.add(chain)
    if aot:
        # the serve gate arms BEFORE the warm starts: traffic arriving
        # mid-warm sheds cold-chain instead of paying the costs inline
        admission_require_warm(chain)

    def _lift_gate() -> None:
        ctl = _admission_gate()
        if ctl is not None:
            ctl.require_warm(admission_chain_sig(chain), False)

    def _warm() -> None:
        if aot:
            report = None
            try:
                report = adm_warmup.warm_executor(gpu)
            finally:
                if report is not None and report.buckets:
                    admission_note_warm(chain, report.buckets)
                else:
                    _lift_gate()
            return
        from fluvio_tpu_torch.protocol.record import Record
        from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

        records = [Record(value=b"[1]"), Record(value=b"[2]")]
        for i, r in enumerate(records):
            r.offset_delta = i
        gpu.process_buffer(RecordBuffer.from_records(records))

    async def _run() -> None:
        try:
            if aot:
                await asyncio.sleep(0)  # the stream's first step takes the lock first
            await _chain_off_loop(chain, _warm)
        except Exception:  # noqa: BLE001 — the warm is best-effort; serving goes on
            logger.warning("chain warm-up failed", exc_info=True)

    try:
        task = asyncio.get_running_loop().create_task(_run())
    except RuntimeError:  # no loop (sync callers): warm inline
        try:
            _warm()
        except Exception:  # noqa: BLE001
            logger.warning("chain warm-up failed", exc_info=True)
        return None
    _warm_tasks.add(task)
    task.add_done_callback(_warm_tasks.discard)
    return task


def _smartmodule_error_code(e: Exception) -> ErrorCode:
    """The stream or produce error code the reference sends for the same
    invocation: a resolution error's own code; an init hook's failure,
    ``SMARTMODULE_CHAIN_INIT_ERROR``; any other failure of the chain,
    ``SMARTMODULE_ERROR`` (a transform error is no failure: it is the
    slice's output, sent as ``SMARTMODULE_RUNTIME_ERROR``)."""
    if isinstance(e, SmartModuleResolutionError):
        return e.code
    if isinstance(e, SmartModuleChainInitError):
        return ErrorCode.SMARTMODULE_CHAIN_INIT_ERROR
    return ErrorCode.SMARTMODULE_ERROR


def _produce_error_response(
    req: ProduceRequest, code: ErrorCode, message: str
) -> ProduceResponse:
    response = ProduceResponse()
    for topic_data in req.topics:
        topic_resp = TopicProduceResponse(name=topic_data.name)
        for pdata in topic_data.partitions:
            topic_resp.partitions.append(
                PartitionProduceResponse(
                    partition_index=pdata.partition_index,
                    error_code=code,
                    error_message=message,
                )
            )
        response.responses.append(topic_resp)
    return response


# ---------------------------------------------------------------------------
# Fetch / FetchOffsets / UpdateOffsets
# ---------------------------------------------------------------------------


def handle_fetch(ctx: GlobalContext, req: FetchRequest) -> FetchResponse:
    resp = FetchResponse(
        topic=req.topic,
        partition=FetchablePartitionResponse(partition_index=req.partition),
    )
    leader = ctx.leader_for(req.topic, req.partition)
    if leader is None:
        resp.partition.error_code = ErrorCode.NOT_LEADER_FOR_PARTITION
        return resp
    info = leader.offsets()
    resp.partition.high_watermark = info.hw
    resp.partition.log_start_offset = info.start_offset
    try:
        rslice = leader.read_records(req.fetch_offset, req.max_bytes, req.isolation)
    except FluvioError as e:
        resp.partition.error_code = e.code
        return resp
    if rslice.file_slice is not None:
        for batch in rslice.decode_batches(parse_records=False):
            resp.partition.records.add(batch)
        ctx.metrics.outbound.add(
            resp.partition.records.total_records(), rslice.file_slice.length
        )
    return resp


def handle_fetch_offsets(ctx: GlobalContext, req: FetchOffsetsRequest) -> FetchOffsetsResponse:
    leader = ctx.leader_for(req.topic, req.partition)
    if leader is None:
        return FetchOffsetsResponse(error_code=ErrorCode.NOT_LEADER_FOR_PARTITION)
    info = leader.offsets()
    return FetchOffsetsResponse(start_offset=info.start_offset, hw=info.hw, leo=info.leo)


def handle_update_offsets(
    conn: ConnectionContext, req: UpdateOffsetsRequest
) -> UpdateOffsetsResponse:
    resp = UpdateOffsetsResponse()
    for upd in req.offsets:
        pub = conn.ack_publishers.get(upd.session_id)
        if pub is None:
            resp.offsets.append(
                OffsetUpdateStatus(
                    session_id=upd.session_id,
                    error_code=ErrorCode.FETCH_SESSION_NOT_FOUND,
                )
            )
            continue
        pub.update(upd.offset)
        resp.offsets.append(OffsetUpdateStatus(session_id=upd.session_id))
    return resp


# ---------------------------------------------------------------------------
# StreamFetch
# ---------------------------------------------------------------------------


def start_stream_fetch(
    ctx: GlobalContext,
    conn: ConnectionContext,
    req: StreamFetchRequest,
    version: int,
    correlation_id: int,
    sink: ExclusiveSink,
) -> None:
    stream_id, ack_publisher = conn.allocate_stream()
    handler = StreamFetchHandler(
        ctx, conn, req, version, correlation_id, stream_id, sink, ack_publisher
    )
    task = asyncio.ensure_future(handler.run())
    conn.stream_tasks[stream_id] = task

    def _cleanup(_t, sid=stream_id) -> None:
        conn.stream_tasks.pop(sid, None)
        conn.ack_publishers.pop(sid, None)  # dead stream ids stop acking

    task.add_done_callback(_cleanup)


class StreamFetchHandler:
    """One push stream: a select loop over data, acks and the connection's
    end (parity: fluvio-spu/src/services/public/stream_fetch.rs:39). The
    chain is acquired once a stream; then the loop reads a bounded slice,
    pushes it (the stored bytes as they are when there is no chain, the
    chain's output otherwise), waits for the consumer's ack and, at the
    log's end, for the leader's offsets to advance."""

    def __init__(
        self,
        ctx: GlobalContext,
        conn: ConnectionContext,
        req: StreamFetchRequest,
        version: int,
        correlation_id: int,
        stream_id: int,
        sink: ExclusiveSink,
        ack_publisher: OffsetPublisher,
    ):
        self.ctx = ctx
        self.conn = conn
        self.req = req
        self.version = version
        self.correlation_id = correlation_id
        self.stream_id = stream_id
        self.sink = sink
        self.ack_publisher = ack_publisher
        self.metrics = ctx.metrics.smartmodule
        self._ended = False  # terminal error pushed; stop the stream
        self._phases: Optional[dict] = None  # the last pushed slice's phase ms
        # while a slice is held by admission backpressure: the hold's
        # start (the held_slices gauge is up until its release books it)
        self._hold_t0: Optional[float] = None
        # streaming-lag identity: chain@topic/partition for chain streams
        # (set once the chain is acquired), stream@topic/partition else
        self._lag_key = f"stream@{req.topic}/{req.partition}"
        # the tenant: the topic name's prefix before its first dot
        self._tenant = tenant_label(req.topic)

    async def run(self) -> None:
        try:
            await self._run()
        except (SocketClosed, ConnectionError):
            pass
        except Exception:  # noqa: BLE001 — one stream's failure must not end the server
            logger.exception("stream fetch failed (%s-%s)", self.req.topic, self.req.partition)
        finally:
            # a stream that ends mid-hold releases it as a re-admit does:
            # the gauge drops and the hold's time is booked
            self._release_hold()

    def _note_hold(self) -> None:
        """A shed slice: stamp the hold's start and raise the gauge (once
        a hold, across its retries)."""
        if self._hold_t0 is None:
            self._hold_t0 = time.monotonic()
            TELEMETRY.gauge_add("held_slices", 1)
            TELEMETRY.add_tenant_held(self._tenant)

    def _release_hold(self, flow=None) -> None:
        """A held slice was admitted (or its stream ended): book the hold
        on the ``hold`` slice phase and the slice's flow, drop the gauge."""
        if self._hold_t0 is None:
            return
        held_s = time.monotonic() - self._hold_t0
        self._hold_t0 = None
        TELEMETRY.gauge_add("held_slices", -1)
        TELEMETRY.add_slice_phase("hold", held_s)
        if flow is not None:
            flow.hold(held_s)

    def _admit(self, chain, flow):
        """`stream_slices`' admission callable, run in the slice's worker
        step before its read: None admits (releasing a hold), a
        `Rejected` decline holds the slice, its reason on the flow. A
        ``breaker-open`` decline proceeds, the flow says so."""
        rej = admission_check(chain, topic=self.req.topic, partition=self.req.partition,
                              tenant=self._tenant)
        if rej is not None and rej.reason != "breaker-open":
            if flow is not None:
                flow.decision = rej.reason
            return rej
        self._release_hold(flow)
        if flow is not None:
            flow.decision = "breaker-open" if rej is not None else "admit"
        return None

    async def _run(self) -> None:
        req = self.req
        leader = self.ctx.leader_for(req.topic, req.partition)
        if leader is None:
            await self._send_error(ErrorCode.NOT_LEADER_FOR_PARTITION, hw=-1, log_start=-1)
            return

        chain = None
        if req.smartmodules:
            try:
                # the build may compile the card's kernels at first use:
                # keep it off the loop so it stalls only this stream
                chain = await asyncio.to_thread(
                    acquire_stream_chain, req.smartmodules, self.ctx, self.version
                )
            except Exception as e:  # noqa: BLE001 — reported on the stream
                await self._chain_failed(leader, e)
                return
            try:
                await chain_look_back(chain, leader)
            except SmartModuleFuelError as e:
                await self._chain_failed(leader, e)
                return
            if _schedule_chain_warmup(chain) is not None:
                await asyncio.sleep(0)  # the warm's task runs up to its lock
            self._lag_key = admission_chain_sig(chain, req.topic, req.partition)
        if TELEMETRY.enabled:
            # the lag engine joins this key's committed offset against the
            # leader's high watermark from here on
            lag_mod.track_stream(self._lag_key, leader)

        # clamp the starting offset into the valid window (stream_fetch.rs
        # resolves the requested offset against [start, bound])
        info = leader.offsets()
        bound = leader.read_bound(req.isolation)
        current = max(info.start_offset, min(req.fetch_offset, bound))
        if TELEMETRY.enabled and current >= 0:
            # seed the committed cursor at the resolved start: a tail
            # consumer on a deep log is not the whole log behind
            lag_mod.note_commit(self._lag_key, current)

        end_wait = asyncio.ensure_future(self.conn.end.wait())
        try:
            if chain is not None:
                await self._serve_chain(leader, chain, end_wait, current)
                return
            while not self.conn.end.is_set() and not self._ended:
                if current < leader.read_bound(req.isolation):
                    sent_next = await self._send_back_records(leader, current)
                    if self._ended:
                        return
                    if sent_next > current:
                        await self._wait_for_ack(sent_next, end_wait)
                        current = sent_next
                        continue
                if not await self._wait_for_data(leader, current, end_wait):
                    return
        finally:
            end_wait.cancel()

    async def _wait_for_data(self, leader, current: int, end_wait: asyncio.Future) -> bool:
        """Wait until the log's read bound passes ``current``; False when
        the connection ends first."""
        listener = leader.offset_publisher(self.req.isolation).change_listener()
        if leader.read_bound(self.req.isolation) > current:
            return True
        listen = asyncio.ensure_future(listener.listen())
        done, _ = await asyncio.wait([listen, end_wait], return_when=asyncio.FIRST_COMPLETED)
        if end_wait in done:
            listen.cancel()
            return False
        return True

    async def _serve_chain(self, leader, chain, end_wait, current: int) -> None:
        """The chain's stream loop: `smart_chain.stream_slices` over the
        stored log up to its read bound, each slice pushed and acked
        before the next is taken; at the log's end, wait for more data.
        For a stateless chain the card works on slice k+1 under slice k's
        push and ack wait. A slice the admission gate sheds is held here,
        on the loop, for its ``retry_after_s`` (5 ms to 250 ms), then the
        next step asks again."""
        req = self.req

        def read(offset: int):
            rslice = leader.read_records(offset, req.max_bytes, req.isolation)
            if rslice.file_slice is None or rslice.next_offset is None:
                return []
            return rslice.decode_batches(parse_records=False)

        while not self.conn.end.is_set():
            bound = leader.read_bound(req.isolation)
            if current < bound:
                slices = stream_slices(chain, read, current, bound, req.max_bytes, self.metrics,
                                       flow_label=(self._lag_key, self._tenant),
                                       admit=lambda flow: self._admit(chain, flow))
                try:
                    while True:
                        try:
                            result = await _next_slice(chain, slices)
                        except FluvioError as e:  # the storage read
                            info = leader.offsets()
                            await self._send_error(e.code, hw=info.hw, log_start=info.start_offset)
                            return
                        except Exception as e:  # noqa: BLE001 — reported on the stream
                            await self._chain_failed(leader, e)
                            return
                        if result is None:
                            break
                        if isinstance(result, SliceHold):
                            self._note_hold()
                            await asyncio.sleep(min(max(result.retry_after_s, 0.005), 0.25))
                            if self.conn.end.is_set():
                                return
                            continue
                        current = await self._push_processed(leader, result)
                        TELEMETRY.end_flow(result.flow, records=result.records.total_records())
                        if self._ended:
                            return
                        await self._wait_for_ack(current, end_wait)
                        if self.conn.end.is_set():
                            return
                finally:
                    async with _chain_lock(chain):
                        slices.close()  # discards what is in flight
            if not await self._wait_for_data(leader, current, end_wait):
                return

    async def _chain_failed(self, leader, e: Exception) -> None:
        """Report a failure of the stream's chain (its build or a slice)
        on the stream and end it: the reference's error code for the
        invocation, the message, no records. A failure that is no
        resolution error, `GpuSpill` or `EngineError` (a device error) is
        logged with its traceback too."""
        if not isinstance(e, (SmartModuleResolutionError, GpuSpill, EngineError,
                              SmartModuleFuelError)):
            logger.error(
                "chain failed on %s-%s", self.req.topic, self.req.partition, exc_info=e
            )
        info = leader.offsets()
        await self._send_error(
            _smartmodule_error_code(e), hw=info.hw, log_start=info.start_offset, message=str(e)
        )
        self._ended = True

    async def _push_processed(self, leader, result: BatchProcessResult) -> int:
        """Send one processed slice's response; returns the next offset."""
        info = leader.offsets()
        partition = FetchablePartitionResponse(
            partition_index=self.req.partition,
            high_watermark=info.hw,
            log_start_offset=info.start_offset,
            next_filter_offset=result.next_offset,
            records=result.records,
        )
        if result.error is not None:
            partition.error_code = ErrorCode.SMARTMODULE_RUNTIME_ERROR
            partition.error_message = str(result.error)
            self._ended = True  # the reference ends the stream on a transform error
        resp = StreamFetchResponse(
            topic=self.req.topic,
            partition_index=self.req.partition,
            stream_id=self.stream_id,
            partition=partition,
        )
        t0 = time.perf_counter()
        await self.sink.send_response(ResponseMessage(self.correlation_id, resp), self.version)
        self._phases = dict(result.phase_ms, push=_ms(t0))
        self.ctx.metrics.slice_phases.append(self._phases)
        nbytes = sum(b.write_size() for b in result.records.batches)
        self.ctx.metrics.outbound.add(result.records.total_records(), nbytes)
        if TELEMETRY.enabled and result.records.batches:
            # the served-record rate and ONE record-age observation a
            # pushed slice (the first output batch's append time -> now)
            served = result.records.total_records()
            age_s = lag_mod.serve_age_s(result.records.batches[0].header.first_timestamp)
            lag_mod.note_serve(self._lag_key, served, age_s)
            TELEMETRY.add_tenant_served(self._tenant, served)
            if age_s is not None:  # no append time stamped: no age
                TELEMETRY.add_tenant_age(self._tenant, age_s)
        return result.next_offset

    async def _wait_for_ack(self, target: int, end_wait: asyncio.Future) -> None:
        """Backpressure: hold the next push until the consumer acks."""
        t0 = time.perf_counter()
        listener = self.ack_publisher.change_listener()
        while self.ack_publisher.current_value() < target and not self.conn.end.is_set():
            listen = asyncio.ensure_future(listener.listen())
            done, _ = await asyncio.wait([listen, end_wait], return_when=asyncio.FIRST_COMPLETED)
            if end_wait in done:
                listen.cancel()
                return
        if self._phases is not None:
            self._phases["ack_wait"] = _ms(t0)
            self._phases = None
        if TELEMETRY.enabled:
            # the consumer's ack is the committed offset of the lag join
            acked = self.ack_publisher.current_value()
            if acked >= 0:
                lag_mod.note_commit(self._lag_key, acked)

    async def _send_back_records(self, leader, offset: int) -> int:
        """Push one slice of stored batches as they are (no chain); returns
        the next offset (``offset`` when nothing was sent)."""
        req = self.req
        try:
            rslice = leader.read_records(offset, req.max_bytes, req.isolation)
        except FluvioError as e:
            info = leader.offsets()
            await self._send_error(e.code, hw=info.hw, log_start=info.start_offset)
            self._ended = True
            return offset
        if rslice.file_slice is None or rslice.next_offset is None:
            return offset
        # zero-copy: stored batches are wire-encoded; send the file slice as
        # the RecordSet body (stream_fetch.rs:443 / sink.rs:123)
        info = rslice.start
        header = ByteWriter()
        header.write_i32(self.correlation_id)
        header.write_string(req.topic)
        header.write_i32(req.partition)
        header.write_i32(self.stream_id)
        header.write_i32(req.partition)  # partition.partition_index
        header.write_u16(int(ErrorCode.NONE))
        header.write_string("")  # error_message
        header.write_i64(info.hw)
        header.write_i64(info.start_offset)
        header.write_i64(rslice.next_offset)
        header.write_i32(rslice.file_slice.length)  # RecordSet byte length
        await self.sink.send_response_with_file_slices(header.bytes(), [rslice.file_slice])
        self.ctx.metrics.outbound.add(0, rslice.file_slice.length)
        return rslice.next_offset

    async def _send_error(
        self, code: ErrorCode, hw: int, log_start: int, message: str = ""
    ) -> None:
        partition = FetchablePartitionResponse(
            partition_index=self.req.partition,
            error_code=code,
            error_message=message,
            high_watermark=hw,
            log_start_offset=log_start,
        )
        resp = StreamFetchResponse(
            topic=self.req.topic,
            partition_index=self.req.partition,
            stream_id=self.stream_id,
            partition=partition,
        )
        await self.sink.send_response(ResponseMessage(self.correlation_id, resp), self.version)
