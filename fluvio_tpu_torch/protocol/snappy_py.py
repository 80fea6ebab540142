"""Pure-Python snappy codec (raw/block format).

Capability parity: fluvio-compression/src/snappy.rs (the `snap` crate's
raw format). The image has no python-snappy, and a reference-produced
snappy topic must still be consumable — so this implements the snappy
block format from the spec (github.com/google/snappy format_description):

- preamble: uncompressed length as a little-endian varint
- elements: literals (tag low bits 00) and back-references
  (01 = 1-byte offset copy, 10 = 2-byte offset copy, 11 = 4-byte)

The compressor is a greedy 4-byte-hash matcher emitting 10-type copies
(what every mainstream snappy encoder emits for typical data); the
decompressor accepts the full format.
"""

from __future__ import annotations


class SnappyError(Exception):
    pass


def _copy_match(out: bytearray, offset: int, length: int) -> None:
    """Back-reference copy: slice for non-overlap, chunk-doubling for
    overlap (byte-exact with the per-byte semantics, interpreter-cheap)."""
    start = len(out) - offset
    if length <= offset:
        out += out[start : start + length]
        return
    chunk = bytes(out[start:])
    reps = -(-length // len(chunk))
    out += (chunk * reps)[:length]


def _varint_encode(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varint_decode(data: bytes, pos: int) -> tuple:
    shift = n = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated preamble varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 35:
            raise SnappyError("preamble varint too long")


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    n = len(chunk) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out.append(n)
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += chunk


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # 2-byte-offset copies (tag 10): length 1-64, offset < 65536
    while length >= 68:
        out.append((63 << 2) | 2)
        out += offset.to_bytes(2, "little")
        length -= 64
    if length > 64:
        out.append(((60 - 1) << 2) | 2)  # length 60
        out += offset.to_bytes(2, "little")
        length -= 60
    out.append(((length - 1) << 2) | 2)
    out += offset.to_bytes(2, "little")


def compress(data: bytes) -> bytes:
    out = bytearray(_varint_encode(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    if n < 16:
        _emit_literal(out, data)
        return bytes(out)
    table: dict = {}
    pos = 0
    lit_start = 0
    limit = n - 4
    while pos <= limit:
        key = data[pos : pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand < 65536:
            # extend the match forward
            length = 4
            while (
                pos + length < n
                and length < 64 * 8
                and data[cand + length] == data[pos + length]
            ):
                length += 1
            if lit_start < pos:
                _emit_literal(out, data[lit_start:pos])
            _emit_copy(out, pos - cand, length)
            pos += length
            lit_start = pos
        else:
            pos += 1
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)


def decompress(data: bytes) -> bytes:
    expected, pos = _varint_decode(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise SnappyError("truncated literal")
            out += data[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("copy offset out of range")
        _copy_match(out, offset, length)
    if len(out) != expected:
        raise SnappyError(
            f"decompressed size {len(out)} != preamble {expected}"
        )
    return bytes(out)
