"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The port's counterpart of the g++/ctypes idiom in
``fluvio_tpu/smartengine/native_backend.py``: each source compiles with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, at
first use, into ``_build/`` next to this file, keyed by a hash of the
source and the flags (a changed source builds anew; an unchanged one is
reused). The sources build in parallel, one ``nvcc`` per file, all started
together. Every C entry point takes pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()``.

Nothing here runs at import time; a missing ``nvcc`` or a failed build
raises — there is no fallback. Each library records one build event in
the telemetry (`telemetry.compiles.note_build`, kind ``nvcc``): built,
with the seconds until its nvcc ended, or cached, with its load time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from fluvio_tpu_torch.telemetry.compiles import note_build

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--ptxas-options=-v",  # registers / shared memory / spills into the build log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# source file -> {C entry point: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "json_span.cu": {
        "fluvio_json_span": [_P, _P, _P, _I, _I, _LL, _I, _P, _P, _P],
        "fluvio_json_span_striped": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _P, _P, _P],
    },
    "extract.cu": {"fluvio_extract": [_P, _P, _P, _LL, _I, _P, _P]},
    "dfa_scan.cu": {
        "fluvio_dfa_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _I, _P, _P]
    },
    "dfa_compose.cu": {"fluvio_dfa_compose": [_P, _P, _I, _I, _LL, _I, _P, _P]},
    "glz_decode.cu": {
        "fluvio_glz_resolve": [_P, _P, _LL, _LL, _P, _P],
        "fluvio_glz_decode": [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P, _P, _P, _P],
    },
    "glz_encode.cu": {"fluvio_glz_enc_match": [_P, _P, _P, _I, _I, _P, _P]},
    "json_array.cu": {
        "fluvio_json_array_striped": [_P, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _P],
    },
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class _Kernels:
    """Process-wide registry of the built libraries (one build per
    process; later calls reuse the loaded handles)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, ctypes._CFuncPtr] = {}
        self.build_seconds = 0.0
        self.build_logs: Dict[str, str] = {}

    def function(self, name: str):
        if name not in self._entries:
            self.build()
        return self._entries[name]

    def build(self) -> Dict[str, str]:
        """Build (or reuse) every source and bind its entry points.
        Returns the per-source nvcc logs (empty for a cached library)."""
        with self._lock:
            if self._entries:
                return self.build_logs
            t0 = time.perf_counter()
            targets = {src: _target(src) for src in SIGNATURES}
            procs = {}
            for src, so in targets.items():
                if so.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                procs[src] = (
                    subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                        stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT,
                        text=True,
                    ),
                    tmp,
                )
            failed = []
            built_s: Dict[str, float] = {}
            for src, (proc, tmp) in procs.items():
                out, _ = proc.communicate()
                built_s[src] = time.perf_counter() - t0
                self.build_logs[src] = out
                if proc.returncode != 0:
                    failed.append(f"{src} (rc {proc.returncode}):\n{out}")
                    continue
                os.replace(tmp, targets[src])
            if failed:
                raise KernelBuildError("nvcc failed for " + "\n".join(failed))
            entries = {}
            for src, so in targets.items():
                t_load = time.perf_counter()
                lib = ctypes.CDLL(str(so))
                for name, argtypes in SIGNATURES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    entries[name] = fn
                note_build("nvcc", src, built_s.get(src, 0.0) + time.perf_counter() - t_load,
                           cached=src not in procs)
            self._entries = entries
            self.build_seconds = time.perf_counter() - t0
            return self.build_logs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA kernels build only where the toolkit is")


def _target(src: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / src).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{digest.hexdigest()[:16]}.so"


KERNELS = _Kernels()


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error (a refused launch
    never runs, and only `cudaGetLastError` shows it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
