"""SC public (admin) API service: Create / Delete / List / Watch.

Capability parity: fluvio-sc/src/services/public_api/ — the generic
object dispatch (create.rs/delete.rs/list.rs/watch.rs:244). Create
validates + applies to the store context (in memory);
topic creates can optionally wait for a final resolution. Watch opens a
server-push stream of epoch-fenced updates per kind.

The port's copy of ``fluvio_tpu/sc/services/public_service.py``.
"""

from __future__ import annotations

import asyncio
import logging

from fluvio_tpu_torch.metadata.partition import PartitionSpec, parse_partition_key
from fluvio_tpu_torch.metadata.topic import TopicResolution, TopicSpec
from fluvio_tpu_torch.protocol.api import (
    ApiVersionKey,
    ApiVersionsRequest,
    ApiVersionsResponse,
    ResponseMessage,
    decode_request_header,
)
from fluvio_tpu_torch.auth import InstanceAction, ObjectType, TypeAction
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.schema.admin import (
    AdminApiKey,
    AdminObject,
    AdminStatus,
    CreateRequest,
    DeleteRequest,
    ListRequest,
    ListResponse,
    WatchRequest,
    WatchResponse,
    spec_type_for,
)
from fluvio_tpu_torch.sc.context import ScContext
from fluvio_tpu_torch.sc.controllers.topics import validate_topic_spec
from fluvio_tpu_torch.stream_model.core import MetadataStoreObject
from fluvio_tpu_torch.transport.service import FluvioService
from fluvio_tpu_torch.transport.sink import ExclusiveSink, FluvioSink
from fluvio_tpu_torch.transport.socket import FluvioSocket, SocketClosed

logger = logging.getLogger(__name__)

SC_API_KEYS = (
    ApiVersionKey(api_key=AdminApiKey.API_VERSION, min_version=0, max_version=0),
    ApiVersionKey(api_key=AdminApiKey.CREATE, min_version=0, max_version=0),
    ApiVersionKey(api_key=AdminApiKey.DELETE, min_version=0, max_version=0),
    ApiVersionKey(api_key=AdminApiKey.LIST, min_version=0, max_version=0),
    ApiVersionKey(api_key=AdminApiKey.WATCH, min_version=0, max_version=0),
)

_ALREADY_EXISTS = {
    "topic": ErrorCode.TOPIC_ALREADY_EXISTS,
    "spu": ErrorCode.SPU_ALREADY_EXISTS,
    "custom-spu": ErrorCode.SPU_ALREADY_EXISTS,
    "tableformat": ErrorCode.TABLE_FORMAT_ALREADY_EXISTS,
}


def _allow(auth, kind: str, action) -> bool:
    try:
        ty = ObjectType.from_kind(kind)
    except KeyError:
        return True  # unknown kind: let the handler produce its error
    if isinstance(action, TypeAction):
        return auth.allow_type_action(ty, action)
    return auth.allow_instance_action(ty, action, "")


class ScPublicService(FluvioService[ScContext]):
    async def respond(self, ctx: ScContext, socket: FluvioSocket) -> None:
        sink = ExclusiveSink(FluvioSink(socket.writer))
        auth = ctx.authorization.create_auth_context(socket)
        watch_tasks: list[asyncio.Task] = []
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
                if key == AdminApiKey.API_VERSION:
                    ApiVersionsRequest.decode(reader, version)
                    resp = ApiVersionsResponse(api_keys=list(SC_API_KEYS))
                elif key == AdminApiKey.CREATE:
                    req = CreateRequest.decode(reader, version)
                    if not _allow(auth, req.kind, TypeAction.CREATE):
                        resp = _permission_denied(req.name)
                    else:
                        resp = await handle_create(ctx, req)
                elif key == AdminApiKey.DELETE:
                    req = DeleteRequest.decode(reader, version)
                    if not _allow(auth, req.kind, InstanceAction.DELETE):
                        resp = _permission_denied(req.name)
                    else:
                        resp = await handle_delete(ctx, req)
                elif key == AdminApiKey.LIST:
                    req = ListRequest.decode(reader, version)
                    if not _allow(auth, req.kind, TypeAction.READ):
                        resp = ListResponse(
                            error_code=ErrorCode.PERMISSION_DENIED,
                            error_message="permission denied",
                        )
                    else:
                        resp = handle_list(ctx, req)
                elif key == AdminApiKey.WATCH:
                    req = WatchRequest.decode(reader, version)
                    if not _allow(auth, req.kind, TypeAction.READ):
                        await sink.send_response(
                            ResponseMessage(
                                cid,
                                WatchResponse(
                                    epoch=-1,
                                    error_code=ErrorCode.PERMISSION_DENIED,
                                ),
                            ),
                            version,
                        )
                        continue
                    task = asyncio.create_task(
                        _watch_stream(ctx, req, version, cid, sink),
                        name=f"admin-watch-{req.kind}",
                    )
                    watch_tasks.append(task)
                    continue  # responses are pushed by the watch task
                else:
                    logger.warning("unknown admin api key %s", key)
                    break
                await sink.send_response(ResponseMessage(cid, resp), version)
        finally:
            for task in watch_tasks:
                task.cancel()
            if watch_tasks:
                await asyncio.gather(*watch_tasks, return_exceptions=True)


def _permission_denied(name: str) -> AdminStatus:
    return AdminStatus(
        name=name,
        error_code=ErrorCode.PERMISSION_DENIED,
        error_message="permission denied",
    )


async def handle_create(ctx: ScContext, req: CreateRequest) -> AdminStatus:
    try:
        spec_type = spec_type_for(req.kind)
    except ValueError as e:
        return AdminStatus(
            name=req.name,
            error_code=ErrorCode.INVALID_CREATE_REQUEST,
            error_message=str(e),
        )
    if req.kind == PartitionSpec.KIND:
        return AdminStatus(
            name=req.name,
            error_code=ErrorCode.INVALID_CREATE_REQUEST,
            error_message="partitions are created by the topic controller",
        )
    store = ctx.store_for(req.kind)
    if req.name in store.store:
        code = _ALREADY_EXISTS.get(req.kind, ErrorCode.INVALID_CREATE_REQUEST)
        return AdminStatus(
            name=req.name,
            error_code=code,
            error_message=f"{req.kind} {req.name!r} already exists",
        )
    try:
        spec = spec_type.from_dict(req.spec)
    except (TypeError, ValueError, KeyError) as e:
        return AdminStatus(
            name=req.name,
            error_code=ErrorCode.INVALID_CREATE_REQUEST,
            error_message=f"bad {req.kind} spec: {e}",
        )
    # eager validation so obviously-bad topic configs fail the request
    # instead of parking in INVALID_CONFIG (policy.rs behavior)
    if isinstance(spec, TopicSpec):
        err = validate_topic_spec(req.name, spec)
        if err:
            return AdminStatus(
                name=req.name,
                error_code=ErrorCode.TOPIC_INVALID_CONFIGURATION,
                error_message=err,
            )
    if req.dry_run:
        return AdminStatus(name=req.name)
    await store.apply(MetadataStoreObject(key=req.name, spec=spec))
    if req.timeout_ms > 0 and isinstance(spec, TopicSpec):
        obj = await ctx.topics.wait_action(
            req.name,
            lambda o: o is not None and o.status.resolution.is_final(),
            timeout=req.timeout_ms / 1000.0,
        )
        if obj is not None and obj.status.resolution == TopicResolution.INVALID_CONFIG:
            return AdminStatus(
                name=req.name,
                error_code=ErrorCode.TOPIC_INVALID_CONFIGURATION,
                error_message=obj.status.reason,
            )
    return AdminStatus(name=req.name)


async def handle_delete(ctx: ScContext, req: DeleteRequest) -> AdminStatus:
    try:
        store = ctx.store_for(req.kind)
    except ValueError as e:
        return AdminStatus(
            name=req.name,
            error_code=ErrorCode.INVALID_DELETE_REQUEST,
            error_message=str(e),
        )
    if req.name not in store.store:
        return AdminStatus(
            name=req.name,
            error_code=ErrorCode.INVALID_DELETE_REQUEST,
            error_message=f"{req.kind} {req.name!r} not found",
        )
    await store.delete(req.name)
    if req.kind == TopicSpec.KIND:
        # cascade: drop the topic's partitions (reference deletes children
        # through the K8s owner ref; local mode does it explicitly)
        for key in list(ctx.partitions.store.keys()):
            topic, _ = parse_partition_key(key)
            if topic == req.name:
                await ctx.partitions.delete(key)
    return AdminStatus(name=req.name)


def handle_list(ctx: ScContext, req: ListRequest) -> ListResponse:
    try:
        store = ctx.store_for(req.kind)
    except ValueError as e:
        return ListResponse(error_code=ErrorCode.OTHER, error_message=str(e))
    objects = []
    for obj in store.store.values():
        if req.name_filters and obj.key not in req.name_filters:
            continue
        admin_obj = AdminObject.from_store_object(obj)
        admin_obj.kind = req.kind if req.kind != "custom-spu" else "spu"
        objects.append(admin_obj)
    return ListResponse(objects=objects)


async def _watch_stream(
    ctx: ScContext,
    req: WatchRequest,
    version: int,
    correlation_id: int,
    sink: ExclusiveSink,
) -> None:
    """Push epoch-fenced updates for one kind until the connection dies."""
    try:
        store = ctx.store_for(req.kind)
    except ValueError:
        await sink.send_response(
            ResponseMessage(correlation_id, WatchResponse(epoch=-1)), version
        )
        return
    listener = store.store.change_listener()
    try:
        while True:
            changes = listener.sync_changes()
            resp = WatchResponse(epoch=changes.epoch)
            if changes.is_sync_all:
                resp.is_sync_all = True
                resp.all_objects = [
                    AdminObject.from_store_object(o) for o in changes.updates
                ]
            else:
                resp.changes = [
                    AdminObject.from_store_object(o) for o in changes.updates
                ]
                resp.deleted = list(changes.deletes)
            if resp.is_sync_all or resp.changes or resp.deleted:
                await sink.send_response(ResponseMessage(correlation_id, resp), version)
            await listener.listen()
    except (SocketClosed, ConnectionError, asyncio.CancelledError):
        pass
    except Exception:
        logger.exception("admin watch stream failed (%s)", req.kind)
