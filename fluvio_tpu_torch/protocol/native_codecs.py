"""ctypes loader for ``fluvio_tpu_torch/native/codecs.cpp`` (lz4-frame and
snappy), the only lz4 / snappy codec of the port's wire path.

The library builds with g++ at first use into ``native/_build/``, keyed
by the source's hash, as ``native/records.py`` does. A build or load
failure raises :class:`CodecLibraryUnavailable`; nothing falls back to
the pure-Python codecs (``lz4_py.py`` / ``snappy_py.py``), which stay as
the plain versions the tests cross-decode against.

Parity: fluvio-compression/src/lib.rs links the native lz4/snappy
libraries; ``codecs.cpp`` is a byte-identical copy of the JAX package's,
so both packages put the same bytes on the wire.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from fluvio_tpu_torch.protocol.lz4_py import Lz4Error
from fluvio_tpu_torch.protocol.snappy_py import SnappyError
from fluvio_tpu_torch.telemetry.compiles import note_build

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "codecs.cpp"
_BUILD_DIR = _SOURCE.parent / "_build"
_lock = threading.Lock()
_lib = None


class CodecLibraryUnavailable(RuntimeError):
    """The lz4 / snappy codec library could not be built or loaded."""


class _CodecBuf(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)), ("len", ctypes.c_int64)]


def load():
    """Build (once, keyed by the source's hash) and bind the library;
    raises :class:`CodecLibraryUnavailable`. A failure is not cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            t0 = time.perf_counter()
            digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
            out = _BUILD_DIR / f"codecs-{digest}.so"
            cached = out.exists()
            if not cached:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SOURCE), "-o", str(tmp)],
                    check=True, capture_output=True,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            note_build("g++", "codecs.cpp", time.perf_counter() - t0, cached=cached)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise CodecLibraryUnavailable(
                f"lz4/snappy codec library did not build: {e} "
                f"{detail.decode(errors='replace')[-400:]}"
            ) from e
        for fn in ("lz4_frame_compress", "lz4_frame_decompress",
                   "snappy_compress", "snappy_decompress"):
            getattr(lib, fn).restype = _CodecBuf
            getattr(lib, fn).argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.codec_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.codec_free.restype = None
        _lib = lib
        return _lib


def _call(fn_name: str, data: bytes, error_cls) -> bytes:
    lib = load()
    data = bytes(data)
    buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\x00")
    res = getattr(lib, fn_name)(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(data))
    if res.len < 0:
        raise error_cls(f"{fn_name}: malformed input")
    try:
        return ctypes.string_at(res.data, res.len)
    finally:
        lib.codec_free(res.data)


def lz4_compress(data: bytes) -> bytes:
    return _call("lz4_frame_compress", data, Lz4Error)


def lz4_decompress(data: bytes) -> bytes:
    return _call("lz4_frame_decompress", data, Lz4Error)


def snappy_compress(data: bytes) -> bytes:
    return _call("snappy_compress", data, SnappyError)


def snappy_decompress(data: bytes) -> bytes:
    return _call("snappy_decompress", data, SnappyError)
