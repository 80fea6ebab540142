"""Framed TCP socket (the port's copy of ``fluvio_tpu/transport/socket.py``;
parity: fluvio-socket/src/socket.rs).

Frame layout both directions: ``i32 payload_len`` + payload bytes, the
wire format of `fluvio_tpu_torch.protocol.api`. Plaintext TCP only: the
port has no TLS yet.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional, Tuple

from fluvio_tpu_torch.protocol.api import (
    ApiRequest,
    RequestMessage,
    decode_response_payload,
)
from fluvio_tpu_torch.protocol.codec import ByteReader


class SocketClosed(ConnectionError):
    """Peer closed the connection (parity: SocketError::SocketClosed).

    A ConnectionError subclass so transport-failure classification (e.g.
    the producer's at-least-once retry) treats it as transient.
    """


class FluvioSocket:
    """One TCP connection: framed reads + writes.

    Cheap struct over an asyncio (reader, writer) pair. Concurrency control
    (many in-flight requests) lives in MultiplexerSocket; servers use the
    sink/stream halves directly.
    """

    _next_id = 0

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        FluvioSocket._next_id += 1
        self.id = FluvioSocket._next_id
        self._stale = False

    @property
    def peer_addr(self) -> str:
        info = self.writer.get_extra_info("peername")
        return f"{info[0]}:{info[1]}" if info else "<unknown>"

    def set_stale(self) -> None:
        self._stale = True

    def is_stale(self) -> bool:
        return self._stale

    async def read_frame(self) -> bytes:
        """Read one length-prefixed frame; raises SocketClosed at EOF."""
        try:
            header = await self.reader.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            raise SocketClosed()
        (length,) = struct.unpack(">i", header)
        if length < 0:
            raise SocketClosed()
        try:
            return await self.reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            raise SocketClosed()

    async def write_frame(self, payload: bytes) -> None:
        self.writer.write(struct.pack(">i", len(payload)) + payload)
        await self.writer.drain()

    async def send_request(self, msg: RequestMessage) -> None:
        await self.write_frame(msg.encode_payload())

    async def get_response(self, msg: RequestMessage) -> "object":
        """Read one response frame and decode it as ``msg``'s response type."""
        payload = await self.read_frame()
        correlation_id, reader = decode_response_payload(payload)
        resp_type = msg.request.RESPONSE
        return resp_type.decode(reader, msg.header.api_version)

    async def send(self, msg: RequestMessage) -> Tuple[int, "object"]:
        """Serial request/response on an un-multiplexed socket."""
        await self.send_request(msg)
        payload = await self.read_frame()
        correlation_id, reader = decode_response_payload(payload)
        resp_type = msg.request.RESPONSE
        return correlation_id, resp_type.decode(reader, msg.header.api_version)

    async def close(self) -> None:
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass

    def split(self) -> Tuple["FluvioStream", "FluvioSink"]:
        from fluvio_tpu_torch.transport.sink import FluvioSink

        return FluvioStream(self), FluvioSink(self.writer)


class FluvioStream:
    """Read half of a socket (parity: FluvioStream)."""

    def __init__(self, socket: FluvioSocket):
        self._socket = socket

    async def next_frame(self) -> Optional[bytes]:
        """Next request frame, or None at EOF."""
        try:
            return await self._socket.read_frame()
        except SocketClosed:
            return None

    def request_reader(self, payload: bytes) -> ByteReader:
        return ByteReader(payload)


async def connect(addr: str) -> FluvioSocket:
    """Connect to ``host:port``."""
    host, port_s = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port_s))
    return FluvioSocket(reader, writer)


async def connect_request(addr: str, request: ApiRequest, version: Optional[int] = None):
    """One-shot connect + request + response (convenience for tests/CLI)."""
    sock = await connect(addr)
    try:
        msg = RequestMessage.new_request(request, version)
        _, resp = await sock.send(msg)
        return resp
    finally:
        await sock.close()
