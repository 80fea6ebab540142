"""SC private API: SPU registration, metadata pushes, LRS status sink.

Capability parity: fluvio-sc/src/services/private_api/private_server.rs —
an SPU dials in and sends `RegisterSpu`; the SC validates the id against
the SPU store, marks it healthy, and converts the connection into a push
channel streaming `UpdateSpu` / `UpdateReplica` / `UpdateSmartModule`
messages (full sync first, then store-fenced deltas). `UpdateLrs`
requests on the same connection feed partition statuses back into the
store. Disconnect flips the SPU's health off, which cascades into the
SPU/partition controllers (election).

The port's copy of ``fluvio_tpu/sc/services/private_service.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from fluvio_tpu_torch.metadata.partition import (
    PartitionStatus,
    ReplicaStatus,
    parse_partition_key,
    partition_key,
)
from fluvio_tpu_torch.protocol.api import (
    ApiVersionKey,
    ApiVersionsRequest,
    ApiVersionsResponse,
    ResponseMessage,
    decode_request_header,
)
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.schema.controlplane import (
    AckResponse,
    InternalScApiKey,
    InternalUpdate,
    RegisterSpuRequest,
    Replica,
    ReplicaRemovedRequest,
    SmartModuleUpdate,
    SpuUpdate,
    UpdateKind,
    UpdateLrsRequest,
)
from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.stream_model.core import _to_plain
from fluvio_tpu_torch.transport.service import FluvioService
from fluvio_tpu_torch.transport.sink import ExclusiveSink, FluvioSink
from fluvio_tpu_torch.transport.socket import FluvioSocket, SocketClosed

logger = logging.getLogger(__name__)

SC_PRIVATE_API_KEYS = (
    ApiVersionKey(api_key=InternalScApiKey.API_VERSION, min_version=0, max_version=0),
    ApiVersionKey(api_key=InternalScApiKey.REGISTER_SPU, min_version=0, max_version=0),
    ApiVersionKey(api_key=InternalScApiKey.UPDATE_LRS, min_version=0, max_version=0),
    ApiVersionKey(
        api_key=InternalScApiKey.REPLICA_REMOVED, min_version=0, max_version=0
    ),
)


def replicas_for_spu(ctx: ScContext, spu_id: int) -> List[Replica]:
    """All partition assignments this SPU participates in."""
    out: List[Replica] = []
    for obj in ctx.partitions.store.values():
        spec = obj.spec
        if spu_id not in spec.replicas:
            continue
        topic, partition = parse_partition_key(obj.key)
        config = {}
        if spec.deduplication is not None:
            config["deduplication"] = _to_plain(spec.deduplication)
        if spec.retention_seconds is not None:
            config["retention_seconds"] = spec.retention_seconds
        if spec.storage is not None:
            config["storage"] = _to_plain(spec.storage)
        out.append(
            Replica(
                topic=topic,
                partition=partition,
                leader=spec.leader,
                replicas=list(spec.replicas),
                config=config,
            )
        )
    return out


def spu_updates(ctx: ScContext) -> List[SpuUpdate]:
    out = []
    for obj in ctx.spus.store.values():
        s = obj.spec
        out.append(
            SpuUpdate(
                id=s.id,
                name=obj.key,
                public_addr=s.public_endpoint.addr,
                private_addr=s.private_endpoint.addr,
                rack=s.rack or "",
            )
        )
    return out


def smartmodule_updates(ctx: ScContext) -> List[SmartModuleUpdate]:
    out = []
    for obj in ctx.smartmodules.store.values():
        out.append(
            SmartModuleUpdate(name=obj.key, payload=obj.spec.artifact.payload)
        )
    return out


class ScPrivateService(FluvioService[ScContext]):
    async def respond(self, ctx: ScContext, socket: FluvioSocket) -> None:
        sink = ExclusiveSink(FluvioSink(socket.writer))
        push_task: Optional[asyncio.Task] = None
        spu_id: Optional[int] = None
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
                if key == InternalScApiKey.API_VERSION:
                    ApiVersionsRequest.decode(reader, version)
                    resp = ApiVersionsResponse(api_keys=list(SC_PRIVATE_API_KEYS))
                elif key == InternalScApiKey.REGISTER_SPU:
                    req = RegisterSpuRequest.decode(reader, version)
                    if ctx.spus.store.value(str(req.spu_id)) is None:
                        logger.warning("unknown SPU %s tried to register", req.spu_id)
                        break  # reference rejects by dropping the connection
                    spu_id = req.spu_id
                    ctx.health.update(spu_id, True)
                    logger.info("spu %s registered", spu_id)
                    push_task = asyncio.create_task(
                        _push_loop(ctx, spu_id, version, cid, sink),
                        name=f"sc-push-spu-{spu_id}",
                    )
                    continue  # responses flow from the push loop
                elif key == InternalScApiKey.UPDATE_LRS:
                    req = UpdateLrsRequest.decode(reader, version)
                    await handle_update_lrs(ctx, req)
                    resp = AckResponse()
                elif key == InternalScApiKey.REPLICA_REMOVED:
                    req = ReplicaRemovedRequest.decode(reader, version)
                    resp = AckResponse()
                else:
                    logger.warning("unknown private api key %s", key)
                    resp = AckResponse(error_code=ErrorCode.UNKNOWN_SERVER_ERROR)
                await sink.send_response(ResponseMessage(cid, resp), version)
        finally:
            if push_task is not None:
                push_task.cancel()
                await asyncio.gather(push_task, return_exceptions=True)
            if spu_id is not None:
                ctx.health.update(spu_id, False)
                logger.info("spu %s disconnected", spu_id)


async def _push_loop(
    ctx: ScContext,
    spu_id: int,
    version: int,
    correlation_id: int,
    sink: ExclusiveSink,
) -> None:
    """Full sync, then re-push on any relevant store movement.

    The reference sends per-kind deltas; we send per-kind full syncs on
    change (the SPU reconciles) — same convergence, simpler fencing.
    """
    spu_listener = ctx.spus.store.change_listener()
    part_listener = ctx.partitions.store.change_listener("spec")
    sm_listener = ctx.smartmodules.store.change_listener()

    async def send(kind: UpdateKind) -> None:
        update = InternalUpdate(kind=kind, sync_all=True)
        if kind == UpdateKind.SPU:
            update.epoch = ctx.spus.store.epoch()
            update.spus = spu_updates(ctx)
        elif kind == UpdateKind.REPLICA:
            update.epoch = ctx.partitions.store.epoch()
            update.replicas = replicas_for_spu(ctx, spu_id)
        else:
            update.epoch = ctx.smartmodules.store.epoch()
            update.smartmodules = smartmodule_updates(ctx)
        await sink.send_response(ResponseMessage(correlation_id, update), version)

    try:
        for listener, kind in (
            (spu_listener, UpdateKind.SPU),
            (part_listener, UpdateKind.REPLICA),
            (sm_listener, UpdateKind.SMARTMODULE),
        ):
            listener.sync_changes()  # fast-forward; full state goes out below
            await send(kind)
        while True:
            waits = {
                asyncio.ensure_future(spu_listener.listen()): UpdateKind.SPU,
                asyncio.ensure_future(part_listener.listen()): UpdateKind.REPLICA,
                asyncio.ensure_future(sm_listener.listen()): UpdateKind.SMARTMODULE,
            }
            try:
                done, pending = await asyncio.wait(
                    waits, return_when=asyncio.FIRST_COMPLETED
                )
            finally:
                for p in waits:
                    if not p.done():
                        p.cancel()
            kinds = {waits[t] for t in done if not t.cancelled()}
            for kind, listener in (
                (UpdateKind.SPU, spu_listener),
                (UpdateKind.REPLICA, part_listener),
                (UpdateKind.SMARTMODULE, sm_listener),
            ):
                if kind in kinds:
                    listener.sync_changes()
                    await send(kind)
    except (SocketClosed, ConnectionError, asyncio.CancelledError):
        pass
    except Exception:
        logger.exception("push loop for spu %s failed", spu_id)


async def handle_update_lrs(ctx: ScContext, req: UpdateLrsRequest) -> None:
    """Fold SPU-reported offsets into partition statuses (update_lrs.rs)."""
    for lrs in req.updates:
        key = partition_key(lrs.topic, lrs.partition)
        obj = ctx.partitions.store.value(key)
        if obj is None:
            continue
        status: PartitionStatus = obj.status
        leader = ReplicaStatus(spu=lrs.leader.spu, hw=lrs.leader.hw, leo=lrs.leader.leo)
        replicas = [
            ReplicaStatus(spu=r.spu, hw=r.hw, leo=r.leo) for r in lrs.replicas
        ]
        in_sync = 1 + sum(1 for r in replicas if r.leo >= 0 and r.leo == leader.leo)
        new_status = PartitionStatus(
            resolution=status.resolution,
            leader=leader,
            replicas=replicas,
            lsr=in_sync,
            size=lrs.size,
        )
        await ctx.partitions.update_status(key, new_status)
