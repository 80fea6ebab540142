"""Records, batches and record-sets — the storage/wire unit of the log.

Capability parity: fluvio-protocol/src/record/{data.rs,batch.rs}. The layout
is a Kafka-style batch format (our own spec, both ends are ours):

Record (varint-framed, inside a batch)::

    varint  inner_len          # bytes following
    i8      attributes
    varint  timestamp_delta
    varint  offset_delta
    u8      key_present        # Option<key>
    [varint key_len + bytes]
    varint  value_len + bytes
    varint  header_count       # record headers (kept 0-compatible)

Batch::

    i64     base_offset
    i32     batch_len          # bytes following this field
    i32     partition_leader_epoch
    i8      magic
    u32     crc                # crc32 of everything after this field
    i16     attributes         # bits 0-2 compression codec; bit 4 schema-id
    i32     last_offset_delta
    i64     first_timestamp
    i64     max_time_stamp
    i64     producer_id
    i16     producer_epoch
    i32     first_sequence
    [u32    schema_id]         # iff attributes & ATTR_SCHEMA_PRESENT
    i32     record_count
    ...     records            # possibly compressed as one block

RecordSet::

    i32     total_len
    ...     batches (back to back)

A batch's record section may be kept as raw (possibly compressed) bytes —
the analog of the reference's ``RawRecords`` — so the broker can move data
without parsing it; ``memory_records()`` materializes parsed records on
demand.

A producer encodes, and a leader parses and encodes again, every record
of a produce, so a batch's record section goes through `_encode_records`
and `_decode_records`: loops over the record fields with short varints
taken from a table (`Record.encode` is the one-record case). The decode
reads what `Record.decode` reads; on a section that is not plainly well
formed (a read past a record's end, record headers, a truncated varint)
it runs `Record.decode` from the start instead, which raises the
section's `DecodeError`.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter, DecodeError, Version
from fluvio_tpu_torch.protocol.compression import Compression, compress, decompress
from fluvio_tpu_torch.protocol.varint import varint_decode, varint_encode, varint_size
from fluvio_tpu_torch.types import NO_TIMESTAMP, Offset, Timestamp

ATTR_COMPRESSION_MASK = 0x07
ATTR_SCHEMA_PRESENT = 0x10

COMPRESSION_NONE = Compression.NONE

# i32 epoch + i8 magic + u32 crc + i16 attrs + i32 lod + i64 fts + i64 mts
# + i64 pid + i16 pepoch + i32 fseq
BATCH_HEADER_SIZE = 4 + 1 + 4 + 2 + 4 + 8 + 8 + 8 + 2 + 4
# base_offset + batch_len
BATCH_PREAMBLE_SIZE = 8 + 4
BATCH_FILE_HEADER_SIZE = BATCH_PREAMBLE_SIZE + BATCH_HEADER_SIZE

MAGIC_V0 = 2  # matches Kafka magic for the v2-style layout


# zigzag varints of 0..8191, one or two bytes each (lengths and deltas)
_VARINTS = []
for _n in range(8192):
    _b = bytearray()
    varint_encode(_b, _n)
    _VARINTS.append(bytes(_b))
del _n, _b


def _varint_bytes(n: int) -> bytes:
    if 0 <= n < 8192:
        return _VARINTS[n]
    out = bytearray()
    varint_encode(out, n)
    return bytes(out)


def _varint_len(n: int) -> int:
    return 1 if -64 <= n < 64 else varint_size(n)


@dataclass
class Record:
    """A single key/value record."""

    value: bytes = b""
    key: Optional[bytes] = None
    attributes: int = 0
    timestamp_delta: Timestamp = 0
    offset_delta: Offset = 0

    def _inner_size(self) -> int:
        # attributes, key tag and header count (0) take a byte each
        inner = 3 + _varint_len(self.timestamp_delta) + _varint_len(self.offset_delta)
        if self.key is not None:
            inner += _varint_len(len(self.key)) + len(self.key)
        return inner + _varint_len(len(self.value)) + len(self.value)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_raw(_encode_records([self]))

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "Record":
        inner_len = r.read_varint()
        sub = r.sub_reader(inner_len)
        attributes = sub.read_i8()
        ts_delta = sub.read_varint()
        off_delta = sub.read_varint()
        key: Optional[bytes] = None
        if sub.read_u8():
            klen = sub.read_varint()
            key = sub.read_raw(klen)
        vlen = sub.read_varint()
        value = sub.read_raw(vlen)
        header_count = sub.read_varint()
        for _ in range(header_count):  # skip-tolerant: we never write headers
            hk = sub.read_varint()
            sub.read_raw(hk)
            hv = sub.read_varint()
            sub.read_raw(hv)
        return cls(
            value=value,
            key=key,
            attributes=attributes,
            timestamp_delta=ts_delta,
            offset_delta=off_delta,
        )

    def write_size(self, version: Version = 0) -> int:
        inner = self._inner_size()
        return _varint_len(inner) + inner


def _encode_records(records: List[Record]) -> bytes:
    """The record section of ``records``, uncompressed, each record as the
    module docstring lays it out (no record headers)."""
    out = bytearray()
    for rec in records:
        attributes, key, value = rec.attributes, rec.key, rec.value
        if not -128 <= attributes <= 127:
            ByteWriter().write_i8(attributes)  # raises struct.error: not an i8
        ts = _varint_bytes(rec.timestamp_delta)
        od = _varint_bytes(rec.offset_delta)
        vl = _varint_bytes(len(value))
        if key is None:
            out += _varint_bytes(3 + len(ts) + len(od) + len(vl) + len(value))
            out.append(attributes & 0xFF)
            out += ts
            out += od
            out.append(0)
        else:
            kl = _varint_bytes(len(key))
            out += _varint_bytes(3 + len(ts) + len(od) + len(kl) + len(key) + len(vl)
                                 + len(value))
            out.append(attributes & 0xFF)
            out += ts
            out += od
            out.append(1)
            out += kl
            out += key
        out += vl
        out += value
        out.append(0)  # record headers: none
    return bytes(out)


class _NotPlain(Exception):
    """A record section `_decode_records` leaves to `Record.decode`."""


def _read_varint(data: bytes, pos: int, end: int):
    b = data[pos] if pos < end else 0x80
    if b < 0x80:
        return (b >> 1) ^ -(b & 1), pos + 1
    if pos + 1 < end and data[pos + 1] < 0x80:
        u = (b & 0x7F) | (data[pos + 1] << 7)
        return (u >> 1) ^ -(u & 1), pos + 2
    try:
        value, pos = varint_decode(data, pos)
    except ValueError:
        raise _NotPlain from None
    if pos > end:
        raise _NotPlain
    return value, pos


def _decode_records(data, count: int) -> List[Record]:
    """``count`` records parsed from the head of ``data``, as ``count``
    calls of `Record.decode` parse them (and raise as they raise)."""
    data = bytes(data)
    n = len(data)
    try:
        out = []
        pos = 0
        for _ in range(count):
            inner, pos = _read_varint(data, pos, n)
            end = pos + inner
            if inner < 1 or end > n:
                raise _NotPlain
            attributes = data[pos]
            if attributes > 127:
                attributes -= 256
            ts, pos = _read_varint(data, pos + 1, end)
            od, pos = _read_varint(data, pos, end)
            if pos >= end:
                raise _NotPlain
            key = None
            if data[pos]:
                klen, pos = _read_varint(data, pos + 1, end)
                if klen < 0 or pos + klen > end:
                    raise _NotPlain
                key = data[pos:pos + klen]
                pos += klen
            else:
                pos += 1
            vlen, pos = _read_varint(data, pos, end)
            if vlen < 0 or pos + vlen >= end or data[pos + vlen] != 0:
                raise _NotPlain  # past the end, or record headers follow
            out.append(Record(value=data[pos:pos + vlen], key=key, attributes=attributes,
                              timestamp_delta=ts, offset_delta=od))
            pos = end
        return out
    except _NotPlain:
        r = ByteReader(data)
        return [Record.decode(r) for _ in range(count)]


@dataclass
class BatchHeader:
    partition_leader_epoch: int = -1
    magic: int = MAGIC_V0
    crc: int = 0
    attributes: int = 0
    last_offset_delta: int = -1
    first_timestamp: Timestamp = NO_TIMESTAMP
    max_time_stamp: Timestamp = NO_TIMESTAMP
    producer_id: int = -1
    producer_epoch: int = -1
    first_sequence: int = -1
    schema_id: int = 0  # emitted iff attributes & ATTR_SCHEMA_PRESENT

    def compression(self) -> Compression:
        return Compression(self.attributes & ATTR_COMPRESSION_MASK)

    def set_compression(self, codec: Compression) -> None:
        self.attributes = (self.attributes & ~ATTR_COMPRESSION_MASK) | int(codec)

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        w.write_i32(self.partition_leader_epoch)
        w.write_i8(self.magic)
        w.write_u32(self.crc)
        w.write_i16(self.attributes)
        w.write_i32(self.last_offset_delta)
        w.write_i64(self.first_timestamp)
        w.write_i64(self.max_time_stamp)
        w.write_i64(self.producer_id)
        w.write_i16(self.producer_epoch)
        w.write_i32(self.first_sequence)

    @classmethod
    def decode(cls, r: ByteReader, version: Version = 0) -> "BatchHeader":
        return cls(
            partition_leader_epoch=r.read_i32(),
            magic=r.read_i8(),
            crc=r.read_u32(),
            attributes=r.read_i16(),
            last_offset_delta=r.read_i32(),
            first_timestamp=r.read_i64(),
            max_time_stamp=r.read_i64(),
            producer_id=r.read_i64(),
            producer_epoch=r.read_i16(),
            first_sequence=r.read_i32(),
        )


@dataclass
class Batch:
    """A batch of records with a Kafka-style header.

    Exactly one of ``records`` (parsed) or ``raw_records`` (opaque, possibly
    compressed — the record_count is still tracked) is the source of truth;
    ``raw_records`` is set by shallow decode paths (storage/wire passthrough).
    """

    base_offset: Offset = 0
    header: BatchHeader = field(default_factory=BatchHeader)
    records: List[Record] = field(default_factory=list)
    raw_records: Optional[bytes] = None
    raw_record_count: int = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def from_records(
        cls,
        records: List[Record],
        base_offset: Offset = 0,
        first_timestamp: Optional[Timestamp] = None,
        compression: Compression = Compression.NONE,
        preserve_offsets: bool = False,
    ) -> "Batch":
        """``preserve_offsets`` keeps each record's existing offset delta
        (the consume-path transform contract, fluvio-spu batch.rs: output
        records keep their stored offsets so consumers resuming mid-slice
        filter correctly); the default re-deltas sequentially (produce
        path, where offsets are not assigned until the log write)."""
        b = cls(base_offset=base_offset, records=list(records))
        now = int(time.time() * 1000) if first_timestamp is None else first_timestamp
        b.header.first_timestamp = now
        b.header.max_time_stamp = now
        if not preserve_offsets:
            for i, rec in enumerate(b.records):
                rec.offset_delta = i
        b.header.last_offset_delta = (
            max((r.offset_delta for r in b.records), default=0)
            if preserve_offsets
            else len(b.records) - 1
        )
        b.header.set_compression(compression)
        return b

    def records_len(self) -> int:
        if self.raw_records is not None:
            return self.raw_record_count
        return len(self.records)

    def computed_last_offset(self) -> Offset:
        """Offset *after* the last record in this batch."""
        return self.base_offset + self.header.last_offset_delta + 1

    def memory_records(self) -> List[Record]:
        """Parsed records, decompressing/parsing raw payload if needed."""
        if self.raw_records is None:
            return self.records
        data = decompress(self.header.compression(), self.raw_records)
        return _decode_records(data, self.raw_record_count)

    # -- wire ---------------------------------------------------------------

    def _encode_record_section(self) -> bytes:
        if self.raw_records is not None:
            return self.raw_records
        return compress(self.header.compression(), _encode_records(self.records))

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        record_section = self._encode_record_section()
        count = self.records_len()

        after_crc = ByteWriter()
        after_crc.write_i16(self.header.attributes)
        after_crc.write_i32(self.header.last_offset_delta)
        after_crc.write_i64(self.header.first_timestamp)
        after_crc.write_i64(self.header.max_time_stamp)
        after_crc.write_i64(self.header.producer_id)
        after_crc.write_i16(self.header.producer_epoch)
        after_crc.write_i32(self.header.first_sequence)
        if self.header.attributes & ATTR_SCHEMA_PRESENT:
            after_crc.write_u32(self.header.schema_id)
        after_crc.write_i32(count)
        after_crc.write_raw(record_section)

        crc = zlib.crc32(after_crc.buf) & 0xFFFFFFFF

        batch_len = 4 + 1 + 4 + len(after_crc)  # epoch + magic + crc + rest
        w.write_i64(self.base_offset)
        w.write_i32(batch_len)
        w.write_i32(self.header.partition_leader_epoch)
        w.write_i8(self.header.magic)
        w.write_u32(crc)
        w.write_raw(after_crc.buf)

    @classmethod
    def decode(
        cls,
        r: ByteReader,
        version: Version = 0,
        parse_records: bool = True,
        check_crc: bool = False,
    ) -> "Batch":
        base_offset = r.read_i64()
        batch_len = r.read_i32()
        if batch_len < BATCH_HEADER_SIZE:
            raise DecodeError(f"batch_len {batch_len} below header size")
        sub = r.sub_reader(batch_len)
        body_start = sub.pos
        header = BatchHeader.decode(sub)
        if check_crc:
            # CRC covers everything after the crc field (epoch i32 + magic i8
            # + crc u32 = 9 bytes into the body).
            after_crc = memoryview(sub.buf)[body_start + 9 : sub.limit]
            actual = zlib.crc32(after_crc) & 0xFFFFFFFF
            if actual != header.crc:
                raise DecodeError(
                    f"batch crc mismatch: stored {header.crc:#x}, computed {actual:#x}"
                )
        if header.attributes & ATTR_SCHEMA_PRESENT:
            header.schema_id = sub.read_u32()
        count = sub.read_i32()
        if count < 0:
            raise DecodeError(f"negative record count {count}")
        raw = sub.read_rest()
        b = cls(
            base_offset=base_offset,
            header=header,
            raw_records=raw,
            raw_record_count=count,
        )
        if parse_records:
            b.records = b.memory_records()
            b.raw_records = None
            b.raw_record_count = 0
        return b

    def write_size(self, version: Version = 0) -> int:
        """Encoded size. Exact for uncompressed/raw batches; for a batch
        that still needs compressing this is the uncompressed upper bound
        (callers budget with it; encode() may write less)."""
        if self.raw_records is not None:
            section = len(self.raw_records)
        else:
            section = sum(r.write_size(version) for r in self.records)
        schema = 4 if self.header.attributes & ATTR_SCHEMA_PRESENT else 0
        return BATCH_PREAMBLE_SIZE + BATCH_HEADER_SIZE + schema + 4 + section


@dataclass
class RecordSet:
    """Length-prefixed sequence of batches (the produce/fetch payload)."""

    batches: List[Batch] = field(default_factory=list)

    def add(self, batch: Batch) -> "RecordSet":
        self.batches.append(batch)
        return self

    def total_records(self) -> int:
        return sum(b.records_len() for b in self.batches)

    def base_offset(self) -> Offset:
        return self.batches[0].base_offset if self.batches else -1

    def last_offset(self) -> Optional[Offset]:
        """Next offset to fetch after this set."""
        if not self.batches:
            return None
        return self.batches[-1].computed_last_offset()

    def encode(self, w: ByteWriter, version: Version = 0) -> None:
        body = ByteWriter()
        for batch in self.batches:
            batch.encode(body, version)
        w.write_i32(len(body))
        w.write_raw(body.bytes())

    @classmethod
    def decode(
        cls, r: ByteReader, version: Version = 0, parse_records: bool = True
    ) -> "RecordSet":
        total = r.read_i32()
        sub = r.sub_reader(total)
        batches = []
        while sub.remaining() > 0:
            batches.append(Batch.decode(sub, version, parse_records=parse_records))
        return cls(batches=batches)
