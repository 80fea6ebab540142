"""Correlation-id multiplexer over one framed socket (the port's copy of
``fluvio_tpu/transport/multiplexing.py``).

Capability parity: fluvio-socket/src/multiplexing.rs — `MultiplexerSocket`
(`:57`): many concurrent in-flight requests on one TCP connection, each
tagged with a correlation id; a single dispatcher loop per socket routes
response frames to either a oneshot waiter (serial request) or a bounded
queue (server-push stream, `create_stream` `:231` — what powers the
consumer's StreamFetch).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, Optional, Union

from fluvio_tpu_torch.protocol.api import (
    ApiRequest,
    RequestMessage,
    decode_response_payload,
)
from fluvio_tpu_torch.transport.socket import FluvioSocket, SocketClosed

_STREAM_END = object()


class MultiplexerClosed(ConnectionError):
    """Socket already stale/closed — transient, like SocketClosed."""


class AsyncResponse:
    """Async iterator over server-push responses for one stream request."""

    def __init__(
        self,
        multiplexer: "MultiplexerSocket",
        correlation_id: int,
        msg: RequestMessage,
        queue: asyncio.Queue,
    ):
        self._multiplexer = multiplexer
        self.correlation_id = correlation_id
        self._msg = msg
        self._queue = queue

    async def next(self):
        """Next decoded response, or None when the stream/socket ends."""
        item = await self._queue.get()
        if item is _STREAM_END:
            return None
        if isinstance(item, Exception):
            raise item
        _, reader = decode_response_payload(item)
        return self._msg.request.RESPONSE.decode(reader, self._msg.header.api_version)

    def __aiter__(self) -> AsyncIterator:
        return self

    async def __anext__(self):
        item = await self.next()
        if item is None:
            raise StopAsyncIteration
        return item

    async def close(self) -> None:
        self._multiplexer._drop_stream(self.correlation_id)


class MultiplexerSocket:
    """Shared multiplexed socket; cheap to clone by reference."""

    def __init__(self, socket: FluvioSocket):
        self._socket = socket
        self._next_correlation = 1
        # cid -> Future (serial) | Queue (stream)
        self._waiters: Dict[int, Union[asyncio.Future, asyncio.Queue]] = {}
        self._send_lock = asyncio.Lock()
        self._closed = False
        self._closing = False
        self._dispatcher = asyncio.ensure_future(self._dispatch_loop())

    # -- lifecycle ----------------------------------------------------------

    @property
    def is_stale(self) -> bool:
        return self._closed or self._socket.is_stale()

    async def close(self) -> None:
        self._closed = True
        self._closing = True  # deliberate: streams end cleanly, not with error
        self._dispatcher.cancel()
        try:
            await self._dispatcher
        except (asyncio.CancelledError, Exception):
            pass
        await self._socket.close()
        self._fail_all(MultiplexerClosed())

    def _fail_all(self, err: Exception) -> None:
        """Fail serial waiters; end streams (with ``err`` unless closing).

        A deliberate close() delivers a clean end-of-stream; an unexpected
        socket drop delivers the error so continuous consumers can
        distinguish disconnect from end-of-data and reconnect.
        """
        item = _STREAM_END if self._closing else err
        for waiter in list(self._waiters.values()):
            if isinstance(waiter, asyncio.Future):
                if not waiter.done():
                    waiter.set_exception(err)
            else:
                try:
                    waiter.put_nowait(item)
                except asyncio.QueueFull:
                    # slow consumer with a full queue: drop the oldest
                    # buffered response to make room for the terminal item
                    try:
                        waiter.get_nowait()
                        waiter.put_nowait(item)
                    except (asyncio.QueueEmpty, asyncio.QueueFull):
                        pass
        self._waiters.clear()

    def _drop_stream(self, correlation_id: int) -> None:
        self._waiters.pop(correlation_id, None)

    # -- request paths ------------------------------------------------------

    def _allocate(self, msg: RequestMessage) -> int:
        cid = self._next_correlation
        self._next_correlation += 1
        msg.header.correlation_id = cid
        return cid

    async def send_and_receive(self, request: ApiRequest, version: Optional[int] = None):
        """Serial request: send, await the single matching response."""
        if self.is_stale:
            raise MultiplexerClosed()
        msg = RequestMessage.new_request(request, version)
        cid = self._allocate(msg)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters[cid] = fut
        async with self._send_lock:
            await self._socket.write_frame(msg.encode_payload())
        payload = await fut
        _, reader = decode_response_payload(payload)
        return request.RESPONSE.decode(reader, msg.header.api_version)

    async def create_stream(
        self, request: ApiRequest, version: Optional[int] = None, queue_len: int = 10
    ) -> AsyncResponse:
        """Stream request: send once, then iterate server pushes."""
        if self.is_stale:
            raise MultiplexerClosed()
        msg = RequestMessage.new_request(request, version)
        cid = self._allocate(msg)
        queue: asyncio.Queue = asyncio.Queue(maxsize=queue_len)
        self._waiters[cid] = queue
        async with self._send_lock:
            await self._socket.write_frame(msg.encode_payload())
        return AsyncResponse(self, cid, msg, queue)

    async def send_async(self, request: ApiRequest, version: Optional[int] = None) -> int:
        """Fire-and-forget (e.g. offset acks on a consumer stream)."""
        msg = RequestMessage.new_request(request, version)
        cid = self._allocate(msg)
        async with self._send_lock:
            await self._socket.write_frame(msg.encode_payload())
        return cid

    # -- dispatcher ---------------------------------------------------------

    async def _dispatch_loop(self) -> None:
        try:
            while True:
                payload = await self._socket.read_frame()
                cid, _ = decode_response_payload(payload)
                waiter = self._waiters.get(cid)
                if waiter is None:
                    continue  # response for a dropped/unknown request
                if isinstance(waiter, asyncio.Future):
                    del self._waiters[cid]
                    if not waiter.done():
                        waiter.set_result(payload)
                else:
                    await waiter.put(payload)
        except (SocketClosed, asyncio.CancelledError):
            self._terminal_error = SocketClosed()
        except Exception as e:  # noqa: BLE001 — e.g. corrupt frame DecodeError
            self._terminal_error = e
        finally:
            self._closed = True
            self._socket.set_stale()
            self._fail_all(getattr(self, "_terminal_error", SocketClosed()))
