"""The consume path's columnar record codec (`records.cpp`), built with g++
at first use into ``_build/`` next to the source, keyed by its hash, and
bound with ctypes.

`decode_record_columns` parses a stored record slab into numpy columns
(at ``align=4`` the value flat is the engine's 4-aligned upload form,
`RecordBuffer.from_flat` adopts it as it is), `encode_record_columns`
writes columns back into a slab. There is no Python decoder in its place:
a library that does not build raises :class:`RecordCodecUnavailable`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from fluvio_tpu_torch.telemetry.compiles import note_build

_SOURCE = Path(__file__).resolve().parent / "records.cpp"
_BUILD_DIR = _SOURCE.parent / "_build"
_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_LL = ctypes.c_int64


class RecordCodecUnavailable(RuntimeError):
    """The record codec library could not be built or loaded."""


def load():
    """Build (once, keyed by the source's hash) and bind the library;
    raises :class:`RecordCodecUnavailable`. A failure is not cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            t0 = time.perf_counter()
            digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
            out = _BUILD_DIR / f"records-{digest}.so"
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
            note_build("g++", "records.cpp", time.perf_counter() - t0, cached=cached)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise RecordCodecUnavailable(
                f"record codec library did not build: {e} "
                f"{detail.decode(errors='replace')[-400:]}"
            ) from e
        lib.fluvio_records_scan.restype = _P
        lib.fluvio_records_scan.argtypes = [ctypes.c_char_p, _LL, _LL, _P]
        lib.fluvio_records_scan_free.restype = None
        lib.fluvio_records_scan_free.argtypes = [_P]
        lib.fluvio_records_fill.restype = None
        lib.fluvio_records_fill.argtypes = [_P, ctypes.c_char_p] + [_P] * 8
        lib.fluvio_records_encoded_size.restype = _LL
        lib.fluvio_records_encoded_size.argtypes = [_P] * 5 + [_LL]
        lib.fluvio_records_encode.restype = None
        lib.fluvio_records_encode.argtypes = [_P] * 7 + [_LL, _P]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_record_columns(raw: bytes, align: int = 4) -> dict:
    """A record slab -> numpy columns: ``count``; ``parsed``, the bytes of
    whole well-formed records (a caller treats ``parsed != len(raw)`` as
    a malformed slab); ``val_flat`` with every value at an
    ``align``-aligned offset and zero gaps, ``val_off`` (count + 1 aligned
    starts, the last the flat's size) and ``val_len`` (exact lengths);
    ``key_flat`` / ``key_off`` (exact-packed) and ``key_present``;
    ``off_delta`` and ``ts_delta`` (int64)."""
    lib = load()
    raw = bytes(raw)
    counts = np.zeros(4, dtype=np.int64)
    handle = lib.fluvio_records_scan(raw, len(raw), align, _ptr(counts))
    if not handle:
        raise MemoryError("record codec: scan allocation failed")
    n, parsed, total_va, total_k = (int(x) for x in counts)
    try:
        cols = {
            "count": n,
            "parsed": parsed,
            "val_flat": np.zeros(total_va, dtype=np.uint8),
            "val_off": np.empty(n + 1, dtype=np.int64),
            "val_len": np.empty(n, dtype=np.int64),
            "key_flat": np.empty(total_k, dtype=np.uint8),
            "key_off": np.empty(n + 1, dtype=np.int64),
            "key_present": np.empty(n, dtype=np.uint8),
            "off_delta": np.empty(n, dtype=np.int64),
            "ts_delta": np.empty(n, dtype=np.int64),
        }
    except BaseException:
        lib.fluvio_records_scan_free(handle)
        raise
    lib.fluvio_records_fill(
        handle, raw,
        *(_ptr(cols[k]) for k in ("val_flat", "val_off", "val_len", "key_flat", "key_off",
                                  "key_present", "off_delta", "ts_delta")),
    )
    return cols


def encode_record_columns(val_flat, val_off, key_flat, key_off, key_present, off_delta,
                          ts_delta) -> bytes:
    """Columns (exact offsets: ``val_off`` / ``key_off`` hold count + 1
    entries) -> the wire slab of the records, attributes 0 and no record
    headers."""
    lib = load()
    vf = np.ascontiguousarray(val_flat, dtype=np.uint8)
    vo = np.ascontiguousarray(val_off, dtype=np.int64)
    kf = np.ascontiguousarray(key_flat, dtype=np.uint8)
    ko = np.ascontiguousarray(key_off, dtype=np.int64)
    kp = np.ascontiguousarray(key_present, dtype=np.uint8)
    od = np.ascontiguousarray(off_delta, dtype=np.int64)
    td = np.ascontiguousarray(ts_delta, dtype=np.int64)
    n = len(vo) - 1
    # the encoder copies [off[i], off[i + 1]) of each flat: the offsets
    # must ascend from 0 and end inside it
    if not (n >= 0 and len(ko) == n + 1 and len(kp) == len(od) == len(td) == n
            and vo[0] >= 0 and ko[0] >= 0 and vo[-1] <= len(vf) and ko[-1] <= len(kf)
            and (np.diff(vo) >= 0).all() and (np.diff(ko) >= 0).all()):
        raise ValueError("encode_record_columns: column lengths disagree")
    total = lib.fluvio_records_encoded_size(_ptr(vo), _ptr(ko), _ptr(kp), _ptr(od), _ptr(td), n)
    out = np.empty(total, dtype=np.uint8)
    lib.fluvio_records_encode(_ptr(vf), _ptr(vo), _ptr(kf), _ptr(ko), _ptr(kp), _ptr(od),
                              _ptr(td), n, _ptr(out))
    return out.tobytes()
