"""Record-batch compression codecs.

The port's copy of ``fluvio_tpu/protocol/compression.py`` (parity: the
`fluvio-compression` crate, gzip/snappy/lz4/zstd). Codec ids live in the
low 3 bits of the batch attributes word. gzip runs through zlib; lz4 and
snappy through their wheels when installed, else through the bundled
pure-Python codecs (`lz4_py.py`, `snappy_py.py`), so a stored lz4 or
snappy topic decodes anywhere; zstd needs the ``zstandard`` package, as
in the reference.
"""

from __future__ import annotations

import enum
import gzip as _gzip


class UnsupportedCompression(Exception):
    pass


class Compression(enum.IntEnum):
    NONE = 0
    GZIP = 1
    SNAPPY = 2
    LZ4 = 3
    ZSTD = 4

    @classmethod
    def parse(cls, name: str) -> "Compression":
        try:
            return cls[name.strip().upper()]
        except KeyError:
            raise ValueError(f"unknown compression: {name!r}") from None


try:
    import zstandard as _zstd

    _ZSTD_C = _zstd.ZstdCompressor(level=3)
    _ZSTD_D = _zstd.ZstdDecompressor()
except ImportError:  # pragma: no cover
    _zstd = None


def _lz4():
    try:
        import lz4.frame as wheel  # type: ignore

        return wheel
    except ImportError:
        from fluvio_tpu_torch.protocol import lz4_py

        return lz4_py


def _snappy():
    try:
        import snappy as wheel  # type: ignore

        return wheel
    except ImportError:
        from fluvio_tpu_torch.protocol import snappy_py

        return snappy_py


def compress(codec: Compression, data: bytes) -> bytes:
    if codec == Compression.NONE:
        return data
    if codec == Compression.GZIP:
        return _gzip.compress(data, compresslevel=6)
    if codec == Compression.ZSTD:
        if _zstd is None:
            raise UnsupportedCompression("zstd not available")
        return _ZSTD_C.compress(data)
    if codec == Compression.LZ4:
        return _lz4().compress(data)
    if codec == Compression.SNAPPY:
        return _snappy().compress(data)
    raise UnsupportedCompression(f"unknown codec {codec}")


def decompress(codec: Compression, data: bytes) -> bytes:
    if codec == Compression.NONE:
        return data
    if codec == Compression.GZIP:
        return _gzip.decompress(data)
    if codec == Compression.ZSTD:
        if _zstd is None:
            raise UnsupportedCompression("zstd not available")
        return _ZSTD_D.decompress(data)
    if codec == Compression.LZ4:
        return _lz4().decompress(data)
    if codec == Compression.SNAPPY:
        return _snappy().decompress(data)
    raise UnsupportedCompression(f"unknown codec {codec}")
