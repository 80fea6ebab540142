"""Client entry point (the port's copy of the lone-SPU mode of
``fluvio_tpu/client/fluvio.py``; parity: fluvio/src/fluvio.rs
`Fluvio::connect`).

``Fluvio.connect(addr)`` dials one SPU's public endpoint, negotiates
versions, and hands out partition consumers over that one connection.
The SC mode (metadata mirror, leader routing, admin) and the producer are
not ported yet: an SC endpoint raises `ScEndpointUnsupported`.
"""

from __future__ import annotations

from typing import Dict, Optional

from fluvio_tpu_torch.client.consumer import PartitionConsumer
from fluvio_tpu_torch.transport.versioned import VersionedSerialSocket

# the SC's admin CREATE api key: an endpoint advertising it is an SC
_SC_ADMIN_CREATE = 1001


class ScEndpointUnsupported(ConnectionError):
    """The endpoint is an SC, whose client side the port does not have."""


class SpuPool:
    """Socket cache of the lone-SPU mode (parity: fluvio/src/spu.rs:97):
    every topic and partition routes to ``default_addr``."""

    def __init__(self, default_addr: str):
        self._default_addr = default_addr
        self._sockets: Dict[str, VersionedSerialSocket] = {}

    async def socket_for(self, topic: str, partition: int) -> VersionedSerialSocket:
        addr = self._default_addr
        sock = self._sockets.get(addr)
        if sock is not None and not sock.is_stale:
            return sock
        sock = await VersionedSerialSocket.connect(addr)
        self._sockets[addr] = sock
        return sock

    async def close(self) -> None:
        for sock in self._sockets.values():
            await sock.close()
        self._sockets.clear()


class Fluvio:
    def __init__(self, pool: SpuPool):
        self._pool = pool

    @classmethod
    async def connect(cls, addr: str) -> "Fluvio":
        """Connect to a lone SPU at ``host:port``. Raises
        `ScEndpointUnsupported` when ``addr`` is an SC."""
        socket = await VersionedSerialSocket.connect(addr)
        is_sc = socket.versions.lookup_version(_SC_ADMIN_CREATE) is not None
        await socket.close()
        if is_sc:
            raise ScEndpointUnsupported(
                f"{addr} is an SC endpoint; the port's client connects to a lone SPU only"
            )
        pool = SpuPool(default_addr=addr)
        await pool.socket_for("", 0)  # eager validation + version negotiation
        return cls(pool)

    async def partition_consumer(self, topic: str, partition: int = 0) -> PartitionConsumer:
        socket = await self._pool.socket_for(topic, partition)
        return PartitionConsumer(topic, partition, socket)

    async def close(self) -> None:
        await self._pool.close()
