"""Transform kinds and the dataplane types of one chain invocation.

The port's copy of ``fluvio_tpu/smartmodule/types.py`` (parity:
fluvio-smartmodule/src/{input.rs,output.rs}): the kind enum and its
detection order, `SmartModuleRecord` (a record with its resolved absolute
offset and timestamp), `SmartModuleInput` (base offset and timestamp plus
the records, parsed or encoded), `SmartModuleOutput` (the successes and
an optional first error) and the error types, with their wire encodings.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, Version
from fluvio_tpu_torch.protocol.record import Record
from fluvio_tpu_torch.types import NO_TIMESTAMP, Offset, Timestamp

# Version at which record timestamps are resolved (parity:
# fluvio-smartmodule/src/input.rs:14 SMARTMODULE_TIMESTAMPS_VERSION = 22).
SMARTMODULE_TIMESTAMPS_VERSION: Version = 22
DEFAULT_SMARTENGINE_VERSION: Version = SMARTMODULE_TIMESTAMPS_VERSION


class SmartModuleKind(enum.Enum):
    FILTER = "filter"
    MAP = "map"
    FILTER_MAP = "filter_map"
    ARRAY_MAP = "array_map"
    AGGREGATE = "aggregate"
    INIT = "init"
    LOOK_BACK = "look_back"


# Detection order when a module exports several candidates (parity:
# fluvio-smartengine .../transforms/mod.rs:24-52).
TRANSFORM_KIND_ORDER = [
    SmartModuleKind.FILTER,
    SmartModuleKind.MAP,
    SmartModuleKind.FILTER_MAP,
    SmartModuleKind.ARRAY_MAP,
    SmartModuleKind.AGGREGATE,
]


@dataclass
class SmartModuleRecord:
    """Record plus resolved absolute offset/timestamp, handed to user fns."""

    record: Record
    base_offset: Offset = 0
    base_timestamp: Timestamp = NO_TIMESTAMP

    @property
    def value(self) -> bytes:
        return self.record.value

    @property
    def key(self) -> Optional[bytes]:
        return self.record.key

    @property
    def offset(self) -> Offset:
        return self.base_offset + self.record.offset_delta

    @property
    def timestamp(self) -> Timestamp:
        if self.base_timestamp == NO_TIMESTAMP:
            return NO_TIMESTAMP
        return self.base_timestamp + self.record.timestamp_delta

    def value_str(self) -> str:
        return self.value.decode("utf-8")

    def key_str(self) -> Optional[str]:
        return None if self.key is None else self.key.decode("utf-8")


@dataclass
class SmartModuleInput:
    """Input to one transform invocation: a slab of records + bases.

    Carries either parsed records or the encoded form; both views are
    interconvertible. The encoded layout::

        i64  base_offset
        i32  raw_len + raw record bytes   # records encoded back to back
        i64  base_timestamp
    """

    base_offset: Offset = 0
    base_timestamp: Timestamp = NO_TIMESTAMP
    records: Optional[List[Record]] = None
    raw_bytes: Optional[bytes] = None
    raw_count: int = 0

    @classmethod
    def from_records(
        cls,
        records: List[Record],
        base_offset: Offset = 0,
        base_timestamp: Timestamp = NO_TIMESTAMP,
    ) -> "SmartModuleInput":
        return cls(
            base_offset=base_offset, base_timestamp=base_timestamp, records=records
        )

    @classmethod
    def from_raw(
        cls,
        raw: bytes,
        count: int,
        base_offset: Offset = 0,
        base_timestamp: Timestamp = NO_TIMESTAMP,
    ) -> "SmartModuleInput":
        return cls(
            base_offset=base_offset,
            base_timestamp=base_timestamp,
            raw_bytes=raw,
            raw_count=count,
        )

    def into_records(self, version: Version = DEFAULT_SMARTENGINE_VERSION) -> List[Record]:
        if self.records is not None:
            return self.records
        assert self.raw_bytes is not None
        r = ByteReader(self.raw_bytes)
        out = []
        while r.remaining() > 0:
            out.append(Record.decode(r, version))
        return out

    def into_smartmodule_records(
        self, version: Version = DEFAULT_SMARTENGINE_VERSION
    ) -> List[SmartModuleRecord]:
        return [
            SmartModuleRecord(rec, self.base_offset, self.base_timestamp)
            for rec in self.into_records(version)
        ]

    def record_count(self) -> int:
        if self.records is not None:
            return len(self.records)
        return self.raw_count

    def byte_size(self) -> int:
        if self.raw_bytes is not None:
            return len(self.raw_bytes)
        return sum(r.write_size() for r in self.records or [])

    def encode(self, w: ByteWriter, version: Version = DEFAULT_SMARTENGINE_VERSION) -> None:
        w.write_i64(self.base_offset)
        body = ByteWriter()
        for rec in self.into_records(version):
            rec.encode(body, version)
        w.write_i32(len(body))
        w.write_raw(body.buf)
        if version >= SMARTMODULE_TIMESTAMPS_VERSION:
            w.write_i64(self.base_timestamp)

    @classmethod
    def decode(
        cls, r: ByteReader, version: Version = DEFAULT_SMARTENGINE_VERSION
    ) -> "SmartModuleInput":
        base_offset = r.read_i64()
        raw_len = r.read_i32()
        raw = r.read_raw(raw_len)
        base_timestamp = NO_TIMESTAMP
        if version >= SMARTMODULE_TIMESTAMPS_VERSION:
            base_timestamp = r.read_i64()
        inp = cls(
            base_offset=base_offset, base_timestamp=base_timestamp, raw_bytes=raw
        )
        inp.records = inp.into_records(version)
        inp.raw_count = len(inp.records)
        return inp


@dataclass
class SmartModuleTransformRuntimeError:
    """First failing record context (parity: link/smartmodule.rs)."""

    hint: str = ""
    offset: Offset = 0
    kind: SmartModuleKind = SmartModuleKind.FILTER
    record_key: Optional[bytes] = None
    record_value: bytes = b""

    def __str__(self) -> str:
        key = self.record_key.decode("utf-8", "replace") if self.record_key else "NULL"
        value = self.record_value.decode("utf-8", "replace")
        return (
            f"{self.hint}\n\n"
            f"SmartModule {self.kind.value} error at offset {self.offset}\n"
            f"Key: {key}\nValue: {value}"
        )

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_string(self.hint)
        w.write_i64(self.offset)
        w.write_string(self.kind.value)
        w.write_option(self.record_key, w.write_bytes)
        w.write_bytes(self.record_value)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "SmartModuleTransformRuntimeError":
        return cls(
            hint=r.read_string(),
            offset=r.read_i64(),
            kind=SmartModuleKind(r.read_string()),
            record_key=r.read_option(r.read_bytes),
            record_value=r.read_bytes() or b"",
        )


@dataclass
class SmartModuleOutput:
    """Result of one transform invocation: successes + optional first error."""

    successes: List[Record] = field(default_factory=list)
    error: Optional[SmartModuleTransformRuntimeError] = None

    @classmethod
    def new(cls, records: List[Record]) -> "SmartModuleOutput":
        return cls(successes=records)

    def encode(self, w: ByteWriter, version: Version = DEFAULT_SMARTENGINE_VERSION) -> None:
        w.write_vec(self.successes, lambda rec: rec.encode(w, version))
        w.write_option(self.error, lambda e: e.encode(w, version))

    @classmethod
    def decode(
        cls, r: ByteReader, version: Version = DEFAULT_SMARTENGINE_VERSION
    ) -> "SmartModuleOutput":
        successes = r.read_vec(lambda: Record.decode(r, version))
        error = r.read_option(lambda: SmartModuleTransformRuntimeError.decode(r, version))
        return cls(successes=successes, error=error)


class SmartModuleInitError(Exception):
    """User init hook failed (parity: SmartModuleInitRuntimeError)."""


class SmartModuleLookbackError(Exception):
    """User look_back hook failed on a record.

    Carries the failing record's absolute offset like the reference's
    SmartModuleLookbackRuntimeError.
    """

    def __init__(self, hint: str, offset: Offset):
        super().__init__(f"{hint} (offset {offset})")
        self.hint = hint
        self.offset = offset
