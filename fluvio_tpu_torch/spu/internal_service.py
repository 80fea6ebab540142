"""SPU internal (peer) API: serves follower sync streams.

The port's copy of ``fluvio_tpu/spu/internal_service.py`` (parity:
fluvio-spu/src/services/internal/ and replication/leader). For each
follower connection the leader pushes record batches of every replica it
leads from the follower's LEO on (`_push_loop`, at most `SYNC_MAX_BYTES`
a push; a HW-only update rides an empty `SyncRecords`), and folds the
follower's offset reports into the leader state, which advances the HW.
A session's replicas leave the leaders' follower tables when its socket
closes.

`_build_sync` reads the stored batches without parsing their records
(``decode_batches(parse_records=False)``): the pushed bytes equal the JAX
leader's, whose parse and re-encode of a record without headers gives
the stored bytes back.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from fluvio_tpu_torch.protocol.api import (
    ApiVersionKey,
    ApiVersionsRequest,
    ApiVersionsResponse,
    ResponseMessage,
    decode_request_header,
)
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.protocol.record import RecordSet
from fluvio_tpu_torch.schema.internal_spu import (
    FollowerOffsetsAck,
    FollowerOffsetsRequest,
    FollowerSyncRequest,
    InternalSpuApiKey,
    SyncRecords,
)
from fluvio_tpu_torch.schema.spu import Isolation
from fluvio_tpu_torch.spu.context import GlobalContext
from fluvio_tpu_torch.transport.service import FluvioService
from fluvio_tpu_torch.transport.sink import ExclusiveSink, FluvioSink
from fluvio_tpu_torch.transport.socket import FluvioSocket, SocketClosed

logger = logging.getLogger(__name__)

SPU_INTERNAL_API_KEYS = (
    ApiVersionKey(
        api_key=InternalSpuApiKey.API_VERSION, min_version=0, max_version=0
    ),
    ApiVersionKey(
        api_key=InternalSpuApiKey.FETCH_STREAM, min_version=0, max_version=0
    ),
    ApiVersionKey(
        api_key=InternalSpuApiKey.FOLLOWER_OFFSETS, min_version=0, max_version=0
    ),
)

SYNC_MAX_BYTES = 1 << 20  # per push; follower acks pace the stream


class _FollowerSession:
    """Connection-local view of one follower's progress."""

    def __init__(self, follower_id: int):
        self.follower_id = follower_id
        # replica key -> next offset to send (optimistic: advanced on send;
        # the authoritative table in LeaderReplicaState advances on ack)
        self.next_offset: Dict[str, int] = {}
        # replica key -> leader HW last pushed (HW-only updates ride an
        # empty SyncRecords so follower HWs advance without new data)
        self.sent_hw: Dict[str, int] = {}
        self.wake = asyncio.Event()


class SpuInternalService(FluvioService[GlobalContext]):
    async def respond(self, ctx: GlobalContext, socket: FluvioSocket) -> None:
        sink = ExclusiveSink(FluvioSink(socket.writer))
        session: Optional[_FollowerSession] = None
        push_task: Optional[asyncio.Task] = None
        try:
            while True:
                try:
                    frame = await socket.read_frame()
                except SocketClosed:
                    break
                header, reader = decode_request_header(frame)
                key, version, cid = (
                    header.api_key,
                    header.api_version,
                    header.correlation_id,
                )
                if key == InternalSpuApiKey.API_VERSION:
                    ApiVersionsRequest.decode(reader, version)
                    resp = ApiVersionsResponse(api_keys=list(SPU_INTERNAL_API_KEYS))
                elif key == InternalSpuApiKey.FETCH_STREAM:
                    req = FollowerSyncRequest.decode(reader, version)
                    session = _FollowerSession(req.follower_id)
                    for ro in req.replicas:
                        session.next_offset[ro.replica_key] = max(ro.leo, 0)
                        leader = ctx.leader_for(ro.topic, ro.partition)
                        if leader is not None:
                            leader.update_follower_offsets(
                                req.follower_id, ro.leo, ro.hw
                            )
                    push_task = asyncio.create_task(
                        _push_loop(ctx, session, version, cid, sink),
                        name=f"leader-sync-{req.follower_id}",
                    )
                    continue
                elif key == InternalSpuApiKey.FOLLOWER_OFFSETS:
                    req = FollowerOffsetsRequest.decode(reader, version)
                    for ro in req.offsets:
                        leader = ctx.leader_for(ro.topic, ro.partition)
                        if leader is not None:
                            if leader.update_follower_offsets(
                                req.follower_id, ro.leo, ro.hw
                            ):
                                logger.debug(
                                    "%s hw advanced to %s",
                                    ro.replica_key,
                                    leader.hw(),
                                )
                        if session is not None:
                            # ack: allow the push loop to resume from the
                            # follower's authoritative position
                            session.next_offset[ro.replica_key] = max(
                                session.next_offset.get(ro.replica_key, 0), ro.leo
                            )
                            session.wake.set()
                    resp = FollowerOffsetsAck()
                else:
                    logger.warning("unknown internal api key %s", key)
                    resp = FollowerOffsetsAck(
                        error_code=ErrorCode.UNKNOWN_SERVER_ERROR
                    )
                await sink.send_response(ResponseMessage(cid, resp), version)
        finally:
            if push_task is not None:
                push_task.cancel()
                await asyncio.gather(push_task, return_exceptions=True)
            if session is not None:
                for key_ in session.next_offset:
                    leader = ctx.leaders.get(key_)
                    if leader is not None:
                        leader.drop_follower(session.follower_id)


async def _push_loop(
    ctx: GlobalContext,
    session: _FollowerSession,
    version: int,
    correlation_id: int,
    sink: ExclusiveSink,
) -> None:
    """Send pending records for every replica the follower registered."""
    try:
        while True:
            sent_any = False
            waiters = []
            for key in list(session.next_offset):
                leader = ctx.leaders.get(key)
                if leader is None:
                    continue
                next_off = session.next_offset[key]
                if next_off < leader.leo():
                    sync = _build_sync(leader, next_off)
                    if sync is not None:
                        last = max(
                            (b.computed_last_offset() for b in sync.records.batches),
                            default=next_off,
                        )
                        session.next_offset[key] = last
                        session.sent_hw[key] = sync.leader_hw
                        await sink.send_response(
                            ResponseMessage(correlation_id, sync), version
                        )
                        sent_any = True
                elif leader.hw() > session.sent_hw.get(key, -1):
                    session.sent_hw[key] = leader.hw()
                    await sink.send_response(
                        ResponseMessage(
                            correlation_id,
                            SyncRecords(
                                topic=leader.topic,
                                partition=leader.partition,
                                leader_leo=leader.leo(),
                                leader_hw=leader.hw(),
                            ),
                        ),
                        version,
                    )
                    sent_any = True
                waiters.append(leader.leo_publisher)
                waiters.append(leader.hw_publisher)
            if sent_any:
                continue
            # idle: wait for new leader data or a follower ack
            session.wake.clear()
            tasks = [asyncio.ensure_future(session.wake.wait())]
            tasks += [
                asyncio.ensure_future(pub.change_listener().listen())
                for pub in waiters
            ]
            try:
                await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED, timeout=1.0
                )
            finally:
                for t in tasks:
                    if not t.done():
                        t.cancel()
    except (SocketClosed, ConnectionError, asyncio.CancelledError):
        pass
    except Exception:
        logger.exception("leader push loop failed (follower %s)", session.follower_id)


def _build_sync(leader, from_offset: int) -> Optional[SyncRecords]:
    try:
        sl = leader.read_records(from_offset, SYNC_MAX_BYTES, Isolation.READ_UNCOMMITTED)
    except Exception:
        logger.exception("sync read failed (%s @ %s)", leader.replica_key, from_offset)
        return None
    batches = sl.decode_batches(parse_records=False)
    if not batches:
        return None
    return SyncRecords(
        topic=leader.topic,
        partition=leader.partition,
        leader_leo=leader.leo(),
        leader_hw=leader.hw(),
        records=RecordSet(batches=batches),
    )
