"""Write half of a socket, including the zero-copy file-slice path (the
port's copy of ``fluvio_tpu/transport/sink.py``).

Capability parity: fluvio-socket/src/sink.rs — `FluvioSink` with
`encode_file_slices` (sendfile of stored batches straight from the log file
into the TCP socket, fluvio-socket/src/sink.rs:123) and `ExclusiveFlvSink`
(shared-writer lock, sink.rs:423).
"""

from __future__ import annotations

import asyncio
import os
import struct
from typing import TYPE_CHECKING, List

from fluvio_tpu_torch.protocol.api import RequestMessage, ResponseMessage
from fluvio_tpu_torch.protocol.codec import ByteWriter, Version

if TYPE_CHECKING:
    from fluvio_tpu_torch.storage.replica import FileSlice


class FluvioSink:
    """Framed writer over an asyncio StreamWriter."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer

    async def write_frame(self, payload: bytes) -> None:
        self.writer.write(struct.pack(">i", len(payload)) + payload)
        await self.writer.drain()

    async def send_request(self, msg: RequestMessage) -> None:
        await self.write_frame(msg.encode_payload())

    async def send_response(self, msg: ResponseMessage, version: Version) -> None:
        await self.write_frame(msg.encode_payload(version))

    async def send_response_with_file_slices(
        self,
        header_bytes: bytes,
        slices: List["FileSlice"],
        trailer_bytes: bytes = b"",
    ) -> None:
        """Zero-copy consume path.

        One frame whose payload is ``header_bytes`` + the raw bytes of each
        file slice (stored batches are already wire-encoded on disk) +
        ``trailer_bytes``. The slice content goes out via ``os.sendfile``
        directly from the log file's fd into the TCP socket when the
        transport supports it; otherwise falls back to pread+write.
        """
        total = len(header_bytes) + sum(s.length for s in slices) + len(trailer_bytes)
        self.writer.write(struct.pack(">i", total) + header_bytes)
        await self.writer.drain()
        for s in slices:
            await self._send_file_slice(s)
        if trailer_bytes:
            self.writer.write(trailer_bytes)
        await self.writer.drain()

    # 64 KB chunks: bounded memory while streaming large slices
    _SLICE_CHUNK = 1 << 16

    async def _send_file_slice(self, s: "FileSlice") -> None:
        """Stream the slice file->socket without decode/re-encode.

        Stored batches are already wire-encoded, so this is a straight
        pread->transport copy (the asyncio transport owns the fd, so raw
        os.sendfile can't be used without racing its write buffer; the
        native C++ sink is where true sendfile lives).
        """
        with open(s.path, "rb") as f:
            fd = f.fileno()
            sent = 0
            while sent < s.length:
                n = min(self._SLICE_CHUNK, s.length - sent)
                chunk = os.pread(fd, n, s.position + sent)
                if not chunk:
                    raise OSError(f"log file truncated: {s.path} @ {s.position + sent}")
                self.writer.write(chunk)
                await self.writer.drain()
                sent += len(chunk)

    async def close(self) -> None:
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class ExclusiveSink:
    """Lock-guarded shared sink: many stream handlers, one TCP writer.

    Parity: ExclusiveFlvSink (fluvio-socket/src/sink.rs:423) — every consumer
    stream on a multiplexed connection serializes its pushes through this.
    """

    def __init__(self, sink: FluvioSink):
        self._sink = sink
        self._lock = asyncio.Lock()

    async def send_response(self, msg: ResponseMessage, version: Version) -> None:
        async with self._lock:
            await self._sink.send_response(msg, version)

    async def send_response_with_file_slices(
        self,
        header_bytes: bytes,
        slices: List["FileSlice"],
        trailer_bytes: bytes = b"",
    ) -> None:
        async with self._lock:
            await self._sink.send_response_with_file_slices(
                header_bytes, slices, trailer_bytes
            )

    async def write_frame(self, payload: bytes) -> None:
        async with self._lock:
            await self._sink.write_frame(payload)


def encode_response_header(correlation_id: int) -> bytes:
    w = ByteWriter()
    w.write_i32(correlation_id)
    return w.bytes()
