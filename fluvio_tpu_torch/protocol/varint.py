"""Zigzag varint codec — scalar and numpy-vectorized forms.

Capability parity: fluvio-protocol/src/core/varint.rs (protobuf/Kafka-style
zigzag varints used for record framing). We use standard 64-bit zigzag
(``(n << 1) ^ (n >> 63)``) throughout.

The vectorized forms are the staging path for the GPU engine: decoding a
million-record batch with a Python loop would dominate end-to-end time, so
`varint_decode_array` / `varint_encode_array` operate on whole byte buffers
with numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_MASK64 = (1 << 64) - 1
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


def zigzag(n: int) -> int:
    if not INT64_MIN <= n <= INT64_MAX:
        raise ValueError(f"varint: value {n} outside int64 range")
    return ((n << 1) ^ (n >> 63)) & _MASK64


def unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def varint_size(n: int) -> int:
    """Encoded size in bytes of zigzag varint of ``n``."""
    u = zigzag(n)
    size = 1
    while u >= 0x80:
        u >>= 7
        size += 1
    return size


def varint_encode(out: bytearray, n: int) -> None:
    u = zigzag(n)
    while u >= 0x80:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)


def varint_decode(buf, pos: int) -> Tuple[int, int]:
    """Decode one zigzag varint from ``buf`` at ``pos``.

    Returns ``(value, new_pos)``. Raises ``ValueError`` on truncation.
    """
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ValueError("varint: unexpected end of buffer")
        b = int(buf[pos])
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint: too many continuation bytes")
    # Mask to 64 bits so a 10-byte varint's high bits wrap exactly like the
    # vectorized (uint64) decoder — both ends must agree on every byte string.
    return unzigzag(result & _MASK64), pos


# ---------------------------------------------------------------------------
# Vectorized batch codecs (numpy)
# ---------------------------------------------------------------------------


def varint_decode_array(data: np.ndarray, positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one varint at each of N positions of ``data`` (uint8 array).

    Vectorized over N: loops over *byte index within the varint* (<= 10
    iterations) instead of over records. Returns ``(values int64[N],
    new_positions int64[N])``.
    """
    positions = positions.astype(np.int64)
    n = positions.shape[0]
    result = np.zeros(n, dtype=np.uint64)
    pos = positions.copy()
    active = np.ones(n, dtype=bool)
    shift = np.uint64(0)
    data_len = len(data)
    for _ in range(10):
        if not active.any():
            break
        if (pos[active] >= data_len).any():
            raise ValueError("varint: unexpected end of buffer in batch decode")
        b = data[pos[active]]
        result[active] |= (b.astype(np.uint64) & np.uint64(0x7F)) << shift
        pos[active] += 1
        cont = np.zeros(n, dtype=bool)
        cont[active] = (b & 0x80) != 0
        active = cont
        shift = shift + np.uint64(7)
    if active.any():
        raise ValueError("varint: overlong varint in batch decode")
    u = result
    values = (u >> np.uint64(1)).astype(np.int64) ^ -(u & np.uint64(1)).astype(np.int64)
    return values, pos


def varint_encoded_sizes(values: np.ndarray) -> np.ndarray:
    """Encoded byte length of each zigzag varint (vectorized)."""
    values = values.astype(np.int64)
    u = (values.astype(np.uint64) << np.uint64(1)) ^ (values >> np.int64(63)).astype(np.uint64)
    # bits needed -> ceil(bits/7), min 1
    nbits = np.zeros(values.shape, dtype=np.int64)
    uu = u.copy()
    for _ in range(10):
        nz = uu != 0
        nbits[nz] += 1
        uu >>= np.uint64(7)
    nbits[nbits == 0] = 1
    return nbits


def varint_encode_array(values: np.ndarray, out: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Encode each value as zigzag varint into ``out`` at ``positions``.

    Returns new positions. ``out`` must be large enough (use
    :func:`varint_encoded_sizes` to budget).
    """
    values = values.astype(np.int64)
    u = (values.astype(np.uint64) << np.uint64(1)) ^ (values >> np.int64(63)).astype(np.uint64)
    pos = positions.astype(np.int64).copy()
    n = values.shape[0]
    active = np.ones(n, dtype=bool)
    for _ in range(10):
        if not active.any():
            break
        more = (u >> np.uint64(7)) != 0
        byte = (u & np.uint64(0x7F)).astype(np.uint8)
        byte[more & active] |= 0x80
        out[pos[active]] = byte[active]
        pos[active] += 1
        next_active = active & more
        u >>= np.uint64(7)
        active = next_active
    return pos
