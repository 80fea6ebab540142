"""Execution metering for user Python SmartModule hooks (the port's copy
of ``fluvio_tpu/smartengine/metering.py``).

The reference executes untrusted modules under wasmtime with fuel
metering and traps the instance when the budget is exhausted
(fluvio-smartengine/src/engine/wasmtime/state.rs:14,40-55,
engine.rs:31-35). DSL programs run on the card and are bounded by
construction; a user-authored Python hook is arbitrary code on the host,
and unmetered, one infinite loop would wedge the broker process.

The analog is a wall-clock budget per hook call enforced from outside
the hook's thread: the hook runs on a dedicated watchdog thread, and when
the budget expires a typed `SmartModuleFuelError` is injected at the
hook's next bytecode boundary (``PyThreadState_SetAsyncExc``, the
mechanism CPython uses for KeyboardInterrupt delivery). Injection is
retried until the hook unwinds, because user code with a bare
``except:`` can swallow the first one. A hook spinning inside a C
extension cannot be interrupted this way; after a grace period the
watchdog abandons the daemon thread and raises in the caller anyway, so
the serving path always gets its typed error in bounded time.
Abandoned threads are counted per module (`quarantine_state`): past
`_MODULE_ABANDONED_LIMIT` live ones that module is refused, past
`_ABANDONED_LIMIT` process-wide every metered call is.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable

#: how long to keep re-injecting before abandoning the hook thread
_KILL_GRACE_SECONDS = 5.0

#: per-module ceiling on live abandoned hook threads: past it, only THAT
#: module's metered execution is refused. Matches the reference's
#: per-instance trap isolation (wasmtime/state.rs:40-55): one hostile
#: module must never take down well-behaved modules' hooks.
_MODULE_ABANDONED_LIMIT = 4

#: hard ceiling process-wide — a last-resort circuit breaker against many
#: DISTINCT hostile modules (each under its own per-module limit)
#: accumulating spinners until the GIL starves. Unlike the per-module
#: limit this refuses ALL metered execution; its state is visible in the
#: SPU monitoring socket so an operator can see why.
_ABANDONED_LIMIT = 16

_abandoned_lock = threading.Lock()
#: module key -> list of live abandoned hook threads
_abandoned_by_module: dict = {}


def _prune_dead_locked() -> None:
    for key in list(_abandoned_by_module):
        live = [t for t in _abandoned_by_module[key] if t.is_alive()]
        if live:
            _abandoned_by_module[key] = live
        else:
            del _abandoned_by_module[key]


def _live_abandoned(key: str) -> tuple:
    """(this module's live abandoned count, process-wide total)."""
    with _abandoned_lock:
        _prune_dead_locked()
        total = sum(len(v) for v in _abandoned_by_module.values())
        return len(_abandoned_by_module.get(key, ())), total


def quarantine_state() -> dict:
    """Operator-visible quarantine snapshot (the SPU monitoring socket's
    ``hook_quarantine``)."""
    with _abandoned_lock:
        _prune_dead_locked()
        per_module = {k: len(v) for k, v in _abandoned_by_module.items()}
    total = sum(per_module.values())
    return {
        "abandoned_hook_threads": total,
        "by_module": per_module,
        "quarantined_modules": sorted(
            k for k, n in per_module.items() if n >= _MODULE_ABANDONED_LIMIT
        ),
        "process_circuit_broken": total >= _ABANDONED_LIMIT,
    }


def scale_budget(budget_ms: int, n_records: int) -> int:
    """Input-proportional budget: reference fuel is per-instruction and
    scales with work; a flat wall-clock cap would fail honest hooks on
    large batches. One budget unit covers 10k records."""
    if budget_ms <= 0:
        return budget_ms
    return budget_ms * max(1, -(-max(n_records, 1) // 10_000))


class SmartModuleFuelError(Exception):
    """A hook exceeded its execution budget (reference fuel trap,
    wasmtime/state.rs:40-55 — there a wasm trap, here a typed error the
    chain converts into a transform error response). ``abandoned`` marks
    a hook that also ignored exception injection: its thread is still
    running, and the owning chain must be poisoned so the hook is never
    re-entered (state may be mid-mutation, and each re-run would leak
    another spinner)."""

    def __init__(
        self,
        name: str = "smartmodule",
        budget_ms: int = 0,
        abandoned: bool = False,
        quarantined: str = "",
    ):
        if quarantined == "module":
            msg = (
                f"SmartModule {name!r} refused: this module abandoned "
                f"{_MODULE_ABANDONED_LIMIT}+ hook threads — quarantined "
                f"while they stay alive (other modules keep running)"
            )
        elif quarantined == "process":
            msg = (
                f"SmartModule {name!r} refused: {_ABANDONED_LIMIT}+ "
                f"abandoned hook threads process-wide — metering circuit "
                f"breaker open (see quarantine state in SPU monitoring)"
            )
        else:
            msg = f"SmartModule {name!r} exceeded its execution budget" + (
                f" ({budget_ms} ms)" if budget_ms else ""
            )
        super().__init__(msg)
        self.module = name
        self.budget_ms = budget_ms
        self.abandoned = abandoned
        self.quarantined = quarantined


def run_metered(
    fn: Callable,
    budget_ms: int,
    name: str = "smartmodule",
    key: str = "",
):
    """Run ``fn()`` with a wall-clock budget; raise SmartModuleFuelError
    if it does not finish in time. ``budget_ms <= 0`` runs unmetered.

    ``key`` is the module's stable identity (source hash when available,
    else its name) — abandonment is tracked per key so quarantine stays
    scoped to the offending module."""
    if budget_ms <= 0:
        return fn()
    key = key or name
    mine, total = _live_abandoned(key)
    if mine >= _MODULE_ABANDONED_LIMIT:
        raise SmartModuleFuelError(name, budget_ms, quarantined="module")
    if total >= _ABANDONED_LIMIT:
        raise SmartModuleFuelError(name, budget_ms, quarantined="process")
    box: dict = {}
    done = threading.Event()

    def runner() -> None:
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True, name=f"sm-meter-{name}")
    t.start()
    if not done.wait(budget_ms / 1000.0):
        deadline = time.monotonic() + _KILL_GRACE_SECONDS
        while not done.is_set() and time.monotonic() < deadline:
            if t.ident is not None:
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(t.ident),
                    ctypes.py_object(SmartModuleFuelError),
                )
            done.wait(0.05)
        abandoned = not done.is_set()
        if abandoned:
            with _abandoned_lock:
                _abandoned_by_module.setdefault(key, []).append(t)
        raise SmartModuleFuelError(name, budget_ms, abandoned=abandoned)
    err = box.get("error")
    if err is not None:
        if isinstance(err, SmartModuleFuelError):
            # the injected class carries no context; re-raise with it
            raise SmartModuleFuelError(name, budget_ms) from None
        raise err
    return box.get("result")
