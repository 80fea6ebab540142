"""Primitive binary reader/writer with the versioned-field convention.

Capability parity: fluvio-protocol's `Encoder`/`Decoder` traits and the
`#[fluvio(min_version, max_version)]` field-versioning scheme
(fluvio-protocol/src/core/{encoder,decoder}.rs). Instead of a derive macro,
wire structs here implement ``encode(writer, version)`` /
``decode(reader, version)`` and guard versioned fields with
``if version >= N`` — the version is negotiated per connection exactly like
the reference (ApiVersions exchange, see transport layer).

All integers are big-endian (network order), matching Kafka conventions.
Strings are u16-length-prefixed UTF-8; byte buffers are i32-length-prefixed;
options are u8 tag + value; vectors are i32 count + items.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional, TypeVar

from fluvio_tpu_torch.protocol.varint import varint_decode, varint_encode

T = TypeVar("T")

Version = int


class DecodeError(Exception):
    """Malformed or truncated wire data."""


_S_I8 = struct.Struct(">b")
_S_U8 = struct.Struct(">B")
_S_I16 = struct.Struct(">h")
_S_U16 = struct.Struct(">H")
_S_I32 = struct.Struct(">i")
_S_U32 = struct.Struct(">I")
_S_I64 = struct.Struct(">q")
_S_U64 = struct.Struct(">Q")
_S_F32 = struct.Struct(">f")
_S_F64 = struct.Struct(">d")


class ByteWriter:
    """Append-only binary writer over a bytearray."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def __len__(self) -> int:
        return len(self.buf)

    def bytes(self) -> bytes:
        return bytes(self.buf)

    # -- primitives ---------------------------------------------------------

    def write_bool(self, v: bool) -> None:
        self.buf += _S_U8.pack(1 if v else 0)

    def write_i8(self, v: int) -> None:
        self.buf += _S_I8.pack(v)

    def write_u8(self, v: int) -> None:
        self.buf += _S_U8.pack(v)

    def write_i16(self, v: int) -> None:
        self.buf += _S_I16.pack(v)

    def write_u16(self, v: int) -> None:
        self.buf += _S_U16.pack(v)

    def write_i32(self, v: int) -> None:
        self.buf += _S_I32.pack(v)

    def write_u32(self, v: int) -> None:
        self.buf += _S_U32.pack(v)

    def write_i64(self, v: int) -> None:
        self.buf += _S_I64.pack(v)

    def write_u64(self, v: int) -> None:
        self.buf += _S_U64.pack(v)

    def write_f32(self, v: float) -> None:
        self.buf += _S_F32.pack(v)

    def write_f64(self, v: float) -> None:
        self.buf += _S_F64.pack(v)

    def write_varint(self, v: int) -> None:
        varint_encode(self.buf, v)

    def write_raw(self, data: bytes) -> None:
        self.buf += data

    # -- composites ---------------------------------------------------------

    def write_string(self, s: str) -> None:
        data = s.encode("utf-8")
        if len(data) > 0xFFFF:
            raise ValueError("string too long for u16 length prefix")
        self.write_u16(len(data))
        self.buf += data

    def write_option_string(self, s: Optional[str]) -> None:
        if s is None:
            self.write_u8(0)
        else:
            self.write_u8(1)
            self.write_string(s)

    def write_bytes(self, data: Optional[bytes]) -> None:
        """i32-length-prefixed byte buffer; None encodes as length -1."""
        if data is None:
            self.write_i32(-1)
        else:
            self.write_i32(len(data))
            self.buf += data

    def write_option(self, v: Optional[T], write_fn: Callable[[T], None]) -> None:
        if v is None:
            self.write_u8(0)
        else:
            self.write_u8(1)
            write_fn(v)

    def write_vec(self, items: List[T], write_fn: Callable[[T], None]) -> None:
        self.write_i32(len(items))
        for item in items:
            write_fn(item)


class ByteReader:
    """Positioned binary reader over bytes/memoryview."""

    __slots__ = ("buf", "pos", "limit")

    def __init__(self, buf, pos: int = 0, limit: Optional[int] = None) -> None:
        self.buf = buf
        self.pos = pos
        self.limit = len(buf) if limit is None else limit

    def remaining(self) -> int:
        return self.limit - self.pos

    def _take(self, n: int) -> memoryview:
        if n < 0:
            raise DecodeError(f"negative length {n}")
        if self.remaining() < n:
            raise DecodeError(
                f"unexpected EOF: need {n} bytes, have {self.remaining()}"
            )
        view = memoryview(self.buf)[self.pos : self.pos + n]
        self.pos += n
        return view

    def sub_reader(self, n: int) -> "ByteReader":
        """Bounded reader over the next ``n`` bytes (consumes them)."""
        if n < 0:
            raise DecodeError(f"negative length {n}")
        if self.remaining() < n:
            raise DecodeError(f"unexpected EOF: need {n}, have {self.remaining()}")
        r = ByteReader(self.buf, self.pos, self.pos + n)
        self.pos += n
        return r

    # -- primitives ---------------------------------------------------------

    def read_bool(self) -> bool:
        return _S_U8.unpack(self._take(1))[0] != 0

    def read_i8(self) -> int:
        return _S_I8.unpack(self._take(1))[0]

    def read_u8(self) -> int:
        return _S_U8.unpack(self._take(1))[0]

    def read_i16(self) -> int:
        return _S_I16.unpack(self._take(2))[0]

    def read_u16(self) -> int:
        return _S_U16.unpack(self._take(2))[0]

    def read_i32(self) -> int:
        return _S_I32.unpack(self._take(4))[0]

    def read_u32(self) -> int:
        return _S_U32.unpack(self._take(4))[0]

    def read_i64(self) -> int:
        return _S_I64.unpack(self._take(8))[0]

    def read_u64(self) -> int:
        return _S_U64.unpack(self._take(8))[0]

    def read_f32(self) -> float:
        return _S_F32.unpack(self._take(4))[0]

    def read_f64(self) -> float:
        return _S_F64.unpack(self._take(8))[0]

    def read_varint(self) -> int:
        try:
            value, self.pos = varint_decode(self.buf, self.pos)
        except ValueError as e:
            raise DecodeError(str(e)) from e
        if self.pos > self.limit:
            raise DecodeError("varint ran past reader limit")
        return value

    def read_raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    def read_rest(self) -> bytes:
        return self.read_raw(self.remaining())

    # -- composites ---------------------------------------------------------

    def read_string(self) -> str:
        n = self.read_u16()
        return str(self._take(n), "utf-8")

    def read_option_string(self) -> Optional[str]:
        return self.read_string() if self.read_u8() else None

    def read_bytes(self) -> Optional[bytes]:
        n = self.read_i32()
        if n < 0:
            return None
        return bytes(self._take(n))

    def read_option(self, read_fn: Callable[[], T]) -> Optional[T]:
        return read_fn() if self.read_u8() else None

    def read_vec(self, read_fn: Callable[[], T]) -> List[T]:
        n = self.read_i32()
        if n < 0:
            raise DecodeError(f"negative vec length {n}")
        return [read_fn() for _ in range(n)]
