"""Offset checkpoint file (the port's copy of
``fluvio_tpu/storage/checkpoint.py``; parity: fluvio-storage/src/checkpoint.rs).

Layout: u16 version + i64 offset, rewritten atomically in place. Holds the
replica high watermark in ``replication.chk``.
"""

from __future__ import annotations

import os
import struct

_FMT = struct.Struct(">Hq")
VERSION = 0


class CheckPoint:
    def __init__(self, path: str, initial: int = 0):
        self.path = path
        self._offset = initial
        if os.path.exists(path) and os.path.getsize(path) >= _FMT.size:
            with open(path, "rb") as f:
                version, offset = _FMT.unpack(f.read(_FMT.size))
                if version == VERSION:
                    self._offset = offset
        else:
            self.write(initial)

    def get_offset(self) -> int:
        return self._offset

    def write(self, offset: int) -> None:
        self._offset = offset
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_FMT.pack(VERSION, offset))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
