"""Version-negotiating serial socket (the port's copy of
``fluvio_tpu/transport/versioned.py``; parity: fluvio-socket/src/versioned.rs:218).

Performs ApiVersions negotiation once per connection, then sends every
request at the highest version inside the INTERSECTION of the client's
[MIN_API_VERSION, MAX_API_VERSION] and the server's advertised
[min_version, max_version] for that api key — so a newer client talks
down to an older broker (and vice versa), and disjoint ranges fail with
a typed error instead of an undecodable frame.
"""

from __future__ import annotations


from fluvio_tpu_torch.protocol.api import ApiRequest, ApiVersionsRequest, ApiVersionsResponse
from fluvio_tpu_torch.transport.multiplexing import MultiplexerSocket
from fluvio_tpu_torch.transport.socket import FluvioSocket, connect


class VersionMismatch(Exception):
    def __init__(self, api_key: int, detail: str = ""):
        super().__init__(
            detail or f"server does not support api key {api_key}"
        )
        self.api_key = api_key


class VersionedSerialSocket:
    """Multiplexer + negotiated version table."""

    def __init__(self, multiplexer: MultiplexerSocket, versions: ApiVersionsResponse):
        self.multiplexer = multiplexer
        self.versions = versions

    @classmethod
    async def connect(cls, addr: str, tls=None) -> "VersionedSerialSocket":
        socket = await connect(addr, tls=tls)
        return await cls.from_socket(socket)

    @classmethod
    async def from_socket(cls, socket: FluvioSocket) -> "VersionedSerialSocket":
        multiplexer = MultiplexerSocket(socket)
        versions = await multiplexer.send_and_receive(ApiVersionsRequest())
        return cls(multiplexer, versions)

    def lookup_version(self, request: ApiRequest) -> int:
        rng = self.versions.lookup_range(request.API_KEY)
        if rng is None:
            raise VersionMismatch(request.API_KEY)
        v = min(rng.max_version, request.MAX_API_VERSION)
        if v < rng.min_version or v < request.MIN_API_VERSION:
            raise VersionMismatch(
                request.API_KEY,
                f"api {request.API_KEY}: client supports "
                f"[{request.MIN_API_VERSION}, {request.MAX_API_VERSION}], "
                f"server supports [{rng.min_version}, {rng.max_version}]",
            )
        return v

    async def send_receive(self, request: ApiRequest):
        return await self.multiplexer.send_and_receive(
            request, self.lookup_version(request)
        )

    async def create_stream(self, request: ApiRequest, queue_len: int = 10):
        return await self.multiplexer.create_stream(
            request, self.lookup_version(request), queue_len
        )

    async def send_async(self, request: ApiRequest) -> int:
        return await self.multiplexer.send_async(request, self.lookup_version(request))

    @property
    def is_stale(self) -> bool:
        return self.multiplexer.is_stale

    async def close(self) -> None:
        await self.multiplexer.close()
