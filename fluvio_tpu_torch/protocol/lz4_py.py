"""Pure-Python LZ4 frame codec.

Capability parity: fluvio-compression/src/lz4.rs (the `lz4_flex` frame
format). No lz4 wheel exists in this image, and a reference-produced
lz4 topic must still be consumable — so this implements the LZ4 frame
format (magic, descriptor with xxh32 header checksum, data blocks, end
mark) and the LZ4 block format (token / literals / 2-byte offset /
match-length extension) from the public specs.

The compressor is a greedy 4-byte-hash matcher; the decompressor
accepts any compliant frame, including uncompressed blocks, skippable
frames, and the optional content/block checksums (verified when
present).
"""

from __future__ import annotations

MAGIC = 0x184D2204


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
_SKIP_MAGIC_LO = 0x184D2A50  # 0x184D2A50..5F are skippable frames


class Lz4Error(Exception):
    pass


# -- xxHash32 (needed for the frame descriptor checksum) ---------------------

_P1, _P2, _P3, _P4, _P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393,
)
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed
        v4 = (seed - _P1) & _M
        while pos <= n - 16:
            for i, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[pos + 4 * i : pos + 4 * i + 4], "little")
                v = (v + lane * _P2) & _M
                v = _rotl(v, 13)
                v = (v * _P1) & _M
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            pos += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while pos <= n - 4:
        h = (h + int.from_bytes(data[pos : pos + 4], "little") * _P3) & _M
        h = (_rotl(h, 17) * _P4) & _M
        pos += 4
    while pos < n:
        h = (h + data[pos] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        pos += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


# -- block format ------------------------------------------------------------

_MIN_MATCH = 4


def _compress_block(data: bytes) -> bytes:
    """Greedy LZ4 block compression (literals + 2-byte-offset matches)."""
    n = len(data)
    out = bytearray()
    table: dict = {}
    pos = 0
    anchor = 0
    # spec: the last 5 bytes are always literals; matches must not start
    # within the last 12 bytes
    match_limit = n - 12
    while pos <= match_limit:
        key = data[pos : pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is None or pos - cand > 0xFFFF:
            pos += 1
            continue
        length = _MIN_MATCH
        # matches may not cover the last 5 bytes
        max_len = n - 5 - pos
        while length < max_len and data[cand + length] == data[pos + length]:
            length += 1
        lit = data[anchor:pos]
        lit_len = len(lit)
        ml = length - _MIN_MATCH
        token = (min(lit_len, 15) << 4) | min(ml, 15)
        out.append(token)
        if lit_len >= 15:
            rest = lit_len - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out += lit
        out += (pos - cand).to_bytes(2, "little")
        if ml >= 15:
            rest = ml - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        pos += length
        anchor = pos
    # trailing literals
    lit = data[anchor:]
    token = min(len(lit), 15) << 4
    out.append(token)
    if len(lit) >= 15:
        rest = len(lit) - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += lit
    return bytes(out)


def _decompress_block(data: bytes, max_size: int) -> bytes:
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise Lz4Error("truncated literal length")
                b = data[pos]
                pos += 1
                lit_len += b
                if b != 255:
                    break
        if pos + lit_len > n:
            raise Lz4Error("truncated literals")
        out += data[pos : pos + lit_len]
        pos += lit_len
        if pos >= n:
            break  # last sequence has no match
        if pos + 2 > n:
            raise Lz4Error("truncated match offset")
        offset = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if offset == 0 or offset > len(out):
            raise Lz4Error("match offset out of range")
        ml = token & 0xF
        if ml == 15:
            while True:
                if pos >= n:
                    raise Lz4Error("truncated match length")
                b = data[pos]
                pos += 1
                ml += b
                if b != 255:
                    break
        ml += _MIN_MATCH
        _copy_match(out, offset, ml)
        if len(out) > max_size:
            raise Lz4Error("block exceeds declared content size")
    return bytes(out)


# -- frame format ------------------------------------------------------------

_BLOCK_MAX = 4 << 20  # 4 MiB block-max-size code 7


def compress(data: bytes) -> bytes:
    """One LZ4 frame: descriptor (no content size, no checksums,
    block-independent) + compressed blocks + end mark."""
    flg = (1 << 6) | (1 << 5)  # version 01, block-independent
    bd = 7 << 4  # 4 MiB max block size
    desc = bytes([flg, bd])
    out = bytearray(MAGIC.to_bytes(4, "little"))
    out += desc
    out.append((xxh32(desc) >> 8) & 0xFF)
    for lo in range(0, max(len(data), 1), _BLOCK_MAX):
        chunk = data[lo : lo + _BLOCK_MAX]
        comp = _compress_block(chunk)
        if len(comp) < len(chunk):
            out += len(comp).to_bytes(4, "little")
            out += comp
        else:  # incompressible: store raw (high bit set)
            out += (len(chunk) | 0x80000000).to_bytes(4, "little")
            out += chunk
    out += (0).to_bytes(4, "little")  # end mark
    return bytes(out)


def decompress(data: bytes) -> bytes:
    pos = 0
    n = len(data)
    out = bytearray()
    while pos < n:
        if pos + 4 > n:
            raise Lz4Error("truncated magic")
        magic = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if (magic & 0xFFFFFFF0) == _SKIP_MAGIC_LO:
            if pos + 4 > n:
                raise Lz4Error("truncated skippable frame")
            skip = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4 + skip
            continue
        if magic != MAGIC:
            raise Lz4Error(f"bad magic 0x{magic:08x}")
        if pos + 2 > n:
            raise Lz4Error("truncated descriptor")
        flg = data[pos]
        desc_start = pos
        pos += 2
        if (flg >> 6) != 1:
            raise Lz4Error("unsupported frame version")
        has_content_size = bool(flg & (1 << 3))
        has_content_checksum = bool(flg & (1 << 2))
        has_block_checksum = bool(flg & (1 << 4))
        has_dict_id = bool(flg & 1)
        content_size = None
        if has_content_size:
            content_size = int.from_bytes(data[pos : pos + 8], "little")
            pos += 8
        if has_dict_id:
            pos += 4
        if pos >= n:
            raise Lz4Error("truncated header checksum")
        hc = data[pos]
        expect = (xxh32(data[desc_start:pos]) >> 8) & 0xFF
        if hc != expect:
            raise Lz4Error("frame header checksum mismatch")
        pos += 1
        frame_out_start = len(out)
        while True:
            if pos + 4 > n:
                raise Lz4Error("truncated block size")
            bsize = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
            if bsize == 0:
                break  # end mark
            uncompressed = bool(bsize & 0x80000000)
            bsize &= 0x7FFFFFFF
            if pos + bsize > n:
                raise Lz4Error("truncated block")
            block = data[pos : pos + bsize]
            pos += bsize
            if has_block_checksum:
                bc = int.from_bytes(data[pos : pos + 4], "little")
                if xxh32(block) != bc:
                    raise Lz4Error("block checksum mismatch")
                pos += 4
            if uncompressed:
                out += block
            else:
                out += _decompress_block(block, 1 << 32)
        if has_content_checksum:
            cc = int.from_bytes(data[pos : pos + 4], "little")
            if xxh32(bytes(out[frame_out_start:])) != cc:
                raise Lz4Error("content checksum mismatch")
            pos += 4
        if content_size is not None and (
            len(out) - frame_out_start
        ) != content_size:
            raise Lz4Error("content size mismatch")
    return bytes(out)
