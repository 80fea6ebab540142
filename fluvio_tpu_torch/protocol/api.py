"""Request/response framing with api-key + version headers (the port's
copy of ``fluvio_tpu/protocol/api.py``).

Capability parity: fluvio-protocol/src/api/{mod.rs,request.rs,response.rs} —
the `Request` trait (API_KEY + min/max version + response type),
`RequestMessage` / `ResponseMessage`, and the length-prefixed frame layout
used by the tokio codec (fluvio-protocol/src/codec/mod.rs).

Frame layout (both directions)::

    i32  payload_len
    ...  payload

Request payload::

    u16  api_key
    i16  api_version
    i32  correlation_id
    str  client_id           # u16-prefixed UTF-8
    ...  request body (encoded at api_version)

Response payload::

    i32  correlation_id
    ...  response body (encoded at the request's api_version)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Generic, Type, TypeVar

from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version

MAX_BYTES = 52_428_800  # 50 MB default fetch bound, matching the reference

R = TypeVar("R", bound="ApiRequest")


class Encodable:
    """Convention: wire structs expose encode(w, version) / decode(r, version)."""

    def encode(self, w: ByteWriter, version: Version) -> None:  # pragma: no cover
        raise NotImplementedError

    @classmethod
    def decode(cls, r: ByteReader, version: Version):  # pragma: no cover
        raise NotImplementedError


class ApiRequest(Encodable):
    """Base for request bodies.

    Subclasses set ``API_KEY``, version range, and ``RESPONSE`` type.
    """

    API_KEY: ClassVar[int] = -1
    MIN_API_VERSION: ClassVar[int] = 0
    MAX_API_VERSION: ClassVar[int] = 0
    DEFAULT_API_VERSION: ClassVar[int] = 0
    RESPONSE: ClassVar[Type[Encodable]]


@dataclass
class RequestHeader:
    api_key: int = 0
    api_version: Version = 0
    correlation_id: int = 0
    client_id: str = "fluvio-tpu"

    def encode(self, w: ByteWriter) -> None:
        w.write_u16(self.api_key)
        w.write_i16(self.api_version)
        w.write_i32(self.correlation_id)
        w.write_string(self.client_id)

    @classmethod
    def decode(cls, r: ByteReader) -> "RequestHeader":
        return cls(
            api_key=r.read_u16(),
            api_version=r.read_i16(),
            correlation_id=r.read_i32(),
            client_id=r.read_string(),
        )


@dataclass
class RequestMessage(Generic[R]):
    header: RequestHeader
    request: R

    @classmethod
    def new_request(cls, request: R, version: Version | None = None) -> "RequestMessage[R]":
        v = request.DEFAULT_API_VERSION if version is None else version
        return cls(
            header=RequestHeader(api_key=request.API_KEY, api_version=v),
            request=request,
        )

    def encode_payload(self) -> bytes:
        w = ByteWriter()
        self.header.encode(w)
        self.request.encode(w, self.header.api_version)
        return w.bytes()

    def to_frame(self) -> bytes:
        payload = self.encode_payload()
        w = ByteWriter()
        w.write_i32(len(payload))
        w.write_raw(payload)
        return w.bytes()


@dataclass
class ResponseMessage:
    correlation_id: int
    response: Encodable

    def encode_payload(self, version: Version) -> bytes:
        w = ByteWriter()
        w.write_i32(self.correlation_id)
        self.response.encode(w, version)
        return w.bytes()

    def to_frame(self, version: Version) -> bytes:
        payload = self.encode_payload(version)
        w = ByteWriter()
        w.write_i32(len(payload))
        w.write_raw(payload)
        return w.bytes()


def decode_request_header(payload: bytes) -> tuple[RequestHeader, ByteReader]:
    """Split an incoming request payload into header + body reader."""
    r = ByteReader(payload)
    header = RequestHeader.decode(r)
    return header, r


def decode_response_payload(payload: bytes) -> tuple[int, ByteReader]:
    """Split an incoming response payload into correlation id + body reader."""
    r = ByteReader(payload)
    correlation_id = r.read_i32()
    return correlation_id, r


# ---------------------------------------------------------------------------
# ApiVersions — version negotiation, spoken by every server
# (parity: fluvio-protocol/src/link/versions.rs)
# ---------------------------------------------------------------------------


@dataclass
class ApiVersionKey(Encodable):
    api_key: int = 0
    min_version: Version = 0
    max_version: Version = 0

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u16(self.api_key)
        w.write_i16(self.min_version)
        w.write_i16(self.max_version)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ApiVersionKey":
        return cls(r.read_u16(), r.read_i16(), r.read_i16())


@dataclass
class ApiVersionsResponse(Encodable):
    api_keys: list[ApiVersionKey] = field(default_factory=list)
    platform_version: str = "0.1.0"

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.platform_version)
        w.write_vec(self.api_keys, lambda k: k.encode(w, version))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ApiVersionsResponse":
        platform_version = r.read_string()
        keys = r.read_vec(lambda: ApiVersionKey.decode(r, version))
        return cls(api_keys=keys, platform_version=platform_version)

    def lookup_version(self, api_key: int) -> Version | None:
        rng = self.lookup_range(api_key)
        return rng.max_version if rng is not None else None

    def lookup_range(self, api_key: int) -> "ApiVersionKey | None":
        for k in self.api_keys:
            if k.api_key == api_key:
                return k
        return None


@dataclass
class ApiVersionsRequest(ApiRequest):
    """Api key 18 in the reference's public API numbering."""

    API_KEY: ClassVar[int] = 18
    RESPONSE: ClassVar[Type[Encodable]] = ApiVersionsResponse

    client_version: str = "0.1.0"
    client_os: str = "linux"
    client_arch: str = "x86_64"

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.client_version)
        w.write_string(self.client_os)
        w.write_string(self.client_arch)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ApiVersionsRequest":
        return cls(r.read_string(), r.read_string(), r.read_string())
