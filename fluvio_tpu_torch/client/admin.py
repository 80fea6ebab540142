"""FluvioAdmin: create/delete/list/watch against the SC public API.

Capability parity: fluvio/src/admin.rs — thin typed wrapper over the
admin object protocol. Objects travel in their canonical dict form (see
fluvio_tpu_torch.schema.admin); helpers convert to/from the metadata dataclasses.

The port's copy of ``fluvio_tpu/client/admin.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from fluvio_tpu_torch.metadata.smartmodule import SmartModuleSpec
from fluvio_tpu_torch.metadata.spu import Endpoint, SpuSpec, SpuType
from fluvio_tpu_torch.metadata.topic import TopicSpec
from fluvio_tpu_torch.schema.admin import (
    AdminStatus,
    CreateRequest,
    DeleteRequest,
    ListRequest,
    WatchRequest,
)
from fluvio_tpu_torch.stream_model.core import MetadataStoreObject
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket


class AdminError(Exception):
    def __init__(self, status: AdminStatus):
        super().__init__(status.error_message or status.error_code.name)
        self.status = status


async def list_objects(
    socket: VersionedSerialSocket,
    kind: str,
    name_filters: Optional[List[str]] = None,
) -> List[MetadataStoreObject]:
    """One LIST round-trip on an SC socket (shared by FluvioAdmin and
    the client metadata mirror's authoritative lookups)."""
    resp = await socket.send_receive(
        ListRequest(kind=kind, name_filters=list(name_filters or []))
    )
    if resp.error_code.value != 0:
        raise RuntimeError(resp.error_message or resp.error_code.name)
    return [o.to_store_object() for o in resp.objects]


class FluvioAdmin:
    def __init__(self, socket: VersionedSerialSocket):
        self._socket = socket

    @classmethod
    async def connect(cls, sc_addr: str) -> "FluvioAdmin":
        return cls(await VersionedSerialSocket.connect(sc_addr))

    async def close(self) -> None:
        await self._socket.close()

    # -- generic object API --------------------------------------------------

    async def create(
        self,
        name: str,
        kind: str,
        spec: Dict[str, Any],
        dry_run: bool = False,
        timeout_ms: int = 0,
    ) -> AdminStatus:
        status = await self._socket.send_receive(
            CreateRequest(
                name=name, kind=kind, spec=spec, dry_run=dry_run, timeout_ms=timeout_ms
            )
        )
        if status.as_error():
            raise AdminError(status)
        return status

    async def delete(self, name: str, kind: str) -> AdminStatus:
        status = await self._socket.send_receive(DeleteRequest(name=name, kind=kind))
        if status.as_error():
            raise AdminError(status)
        return status

    async def list(
        self, kind: str, name_filters: Optional[List[str]] = None
    ) -> List[MetadataStoreObject]:
        return await list_objects(self._socket, kind, name_filters)

    async def watch(self, kind: str, queue_len: int = 10):
        """AsyncResponse of WatchResponse pushes (first = full sync)."""
        return await self._socket.create_stream(
            WatchRequest(kind=kind), queue_len=queue_len
        )

    # -- typed helpers (what the CLI uses) -----------------------------------

    async def create_topic(
        self, name: str, spec: Optional[TopicSpec] = None, timeout_ms: int = 10_000
    ) -> AdminStatus:
        spec = spec or TopicSpec.computed(1)
        return await self.create(
            name, TopicSpec.KIND, spec.to_dict(), timeout_ms=timeout_ms
        )

    async def delete_topic(self, name: str) -> AdminStatus:
        return await self.delete(name, TopicSpec.KIND)

    async def list_topics(self) -> List[MetadataStoreObject]:
        return await self.list(TopicSpec.KIND)

    async def register_custom_spu(
        self,
        spu_id: int,
        public_addr: str,
        private_addr: str = "",
        rack: Optional[str] = None,
    ) -> AdminStatus:
        # SPUs are keyed by str(id): the private server's registration
        # lookup resolves the dialing SPU's id against that key
        spec = SpuSpec(
            id=spu_id,
            spu_type=SpuType.CUSTOM,
            public_endpoint=Endpoint.from_addr(public_addr),
            private_endpoint=(
                Endpoint.from_addr(private_addr) if private_addr else Endpoint()
            ),
            rack=rack,
        )
        return await self.create(str(spu_id), "custom-spu", spec.to_dict())

    async def create_smartmodule(
        self, name: str, source: bytes
    ) -> AdminStatus:
        spec = SmartModuleSpec.from_source(source, name=name)
        return await self.create(name, SmartModuleSpec.KIND, spec.to_dict())
