"""Wire-level error codes shared by all services.

Capability parity: fluvio-protocol/src/link/error_code.rs. Encoded as a
u16 code + optional string detail (the reference encodes enums with payload
via its derive; we flatten to (code, message))."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version


class ErrorCode(enum.IntEnum):
    UNKNOWN_SERVER_ERROR = 1
    NONE = 0
    OTHER = 2
    OFFSET_OUT_OF_RANGE = 3
    NOT_LEADER_FOR_PARTITION = 6
    REQUEST_TIMED_OUT = 7
    MESSAGE_TOO_LARGE = 10
    PERMISSION_DENIED = 13
    STORAGE_ERROR = 56
    INVALID_CREATE_REQUEST = 57
    INVALID_DELETE_REQUEST = 58

    SPU_ERROR = 1000
    SPU_REGISTRATION_FAILED = 1001
    SPU_OFFLINE = 1002
    SPU_NOT_FOUND = 1003
    SPU_ALREADY_EXISTS = 1004

    TOPIC_ERROR = 2000
    TOPIC_NOT_FOUND = 2001
    TOPIC_ALREADY_EXISTS = 2002
    TOPIC_PENDING_INITIALIZATION = 2003
    TOPIC_INVALID_CONFIGURATION = 2004
    TOPIC_NOT_PROVISIONED = 2005
    TOPIC_INVALID_NAME = 2006

    PARTITION_PENDING_INITIALIZATION = 3000
    PARTITION_NOT_LEADER = 3001
    FETCH_SESSION_NOT_FOUND = 3002

    SMARTMODULE_ERROR = 5000
    SMARTMODULE_NOT_FOUND = 5001
    SMARTMODULE_INVALID = 5002
    SMARTMODULE_INVALID_EXPORTS = 5003
    SMARTMODULE_RUNTIME_ERROR = 5004
    SMARTMODULE_CHAIN_INIT_ERROR = 5005
    SMARTMODULE_INIT_ERROR = 5006
    SMARTMODULE_LOOKBACK_ERROR = 5007
    SMARTMODULE_MEMORY_LIMIT_EXCEEDED = 5008

    TABLE_FORMAT_ERROR = 6000
    TABLE_FORMAT_NOT_FOUND = 6001
    TABLE_FORMAT_ALREADY_EXISTS = 6002

    COMPRESSION_ERROR = 7000
    DEDUPLICATION_SMARTMODULE_NOT_LOADED = 8000
    DEDUPLICATION_SMARTMODULE_NAME_INVALID = 8001


@dataclass
class ApiError:
    """(code, detail) pair used in response payloads."""

    code: ErrorCode = ErrorCode.NONE
    message: Optional[str] = None

    def is_ok(self) -> bool:
        return self.code == ErrorCode.NONE

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_u16(int(self.code))
        w.write_option_string(self.message)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "ApiError":
        raw_code = r.read_u16()
        message = r.read_option_string()
        try:
            code = ErrorCode(raw_code)
        except ValueError:
            # Forward compatibility: a newer peer may send codes we don't know.
            code = ErrorCode.UNKNOWN_SERVER_ERROR
            message = f"unknown error code {raw_code}: {message or ''}"
        return cls(code=code, message=message)

    @classmethod
    def ok(cls) -> "ApiError":
        return cls()

    def raise_if_error(self) -> None:
        if not self.is_ok():
            raise FluvioError(self.code, self.message or self.code.name)


class FluvioError(Exception):
    """Client-visible error carrying an ErrorCode."""

    def __init__(self, code: ErrorCode, message: str = ""):
        super().__init__(f"{code.name}: {message}" if message else code.name)
        self.code = code
        self.message = message
