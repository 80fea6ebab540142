"""Preflight checks (the port's copy of ``fluvio_tpu/cluster/check.py``;
parity: fluvio-cluster/src/check/mod.rs:967 `ClusterChecker` with its
check list — here the local-install relevant ones: the interpreter, the
engine stack, data directory writability and port availability).

The engine check is the port's: the CUDA card (``torch.cuda.is_available``)
and the native libraries its first dispatch builds (the record codec with
g++ and, with a card, the CUDA kernels with nvcc). A missing card is
reported (``ok`` False), never raised: there is no other engine to fall
back to. The JAX package's check for an installed cluster reads its local
cluster state (``cluster/local.py``), host tooling the port does not
carry, so that check is not here.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class CheckResult:
    name: str
    ok: bool
    message: str = ""


@dataclass
class ClusterChecker:
    checks: List[Callable[[], CheckResult]] = field(default_factory=list)

    @classmethod
    def local_preflight(cls, data_dir: str, ports: Optional[List[int]] = None) -> "ClusterChecker":
        checker = cls()
        checker.checks.append(_check_python)
        checker.checks.append(_check_engine_stack)
        checker.checks.append(lambda: _check_data_dir(data_dir))
        for port in ports or []:
            checker.checks.append(lambda p=port: _check_port_free(p))
        return checker

    def run(self) -> List[CheckResult]:
        return [check() for check in self.checks]

    def run_or_fail(self) -> List[CheckResult]:
        results = self.run()
        failures = [r for r in results if not r.ok]
        if failures:
            lines = "; ".join(f"{r.name}: {r.message}" for r in failures)
            raise RuntimeError(f"preflight failed: {lines}")
        return results


def _check_python() -> CheckResult:
    ok = sys.version_info >= (3, 10)
    return CheckResult("python", ok, "" if ok else f"need >= 3.10, have {sys.version.split()[0]}")


def _check_engine_stack() -> CheckResult:
    """The card and the native libraries a first dispatch builds."""
    try:
        import torch

        from fluvio_tpu_torch.native import records as native_records

        native_records.load()
        if not torch.cuda.is_available():
            return CheckResult(
                "engine", False,
                "CUDA is not available: the engine runs only on the card (device='cpu' "
                "runs the plain torch kernels, for tests)")
        from fluvio_tpu_torch.smartengine.gpu.native import KERNELS

        KERNELS.build()
        return CheckResult("engine", True, f"{torch.cuda.get_device_name(0)}, kernels built "
                                           f"in {KERNELS.build_seconds:.1f} s")
    except Exception as e:  # noqa: BLE001 — report, don't crash preflight
        return CheckResult("engine", False, f"{type(e).__name__}: {e}")


def _check_data_dir(data_dir: str) -> CheckResult:
    try:
        os.makedirs(data_dir, exist_ok=True)
        with tempfile.TemporaryFile(dir=data_dir):
            pass
        return CheckResult("data-dir", True)
    except OSError as e:
        return CheckResult("data-dir", False, str(e))


def _check_port_free(port: int) -> CheckResult:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
            return CheckResult(f"port-{port}", True)
        except OSError:
            return CheckResult(f"port-{port}", False, "already in use")
