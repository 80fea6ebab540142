"""Fault-injection harness: a process-global registry of named fault
points threaded through the pipeline's failure seams.

The port's counterpart of ``fluvio_tpu/resilience/faults.py``. Every seam
the recovery layer guards is also a place chaos can strike on demand: the
same code path handles a real CUDA or transfer error and an armed
`InjectedFault`, so the chaos tests exercise the recovery logic the card
runs:

==============  ==========================================================
point           seam
==============  ==========================================================
``stage``       host-side staging of a batch (the ragged flat)
``h2d``         the uploads to the card
``dispatch``    the chain's torch calls and kernel launches
``device``      first blocking wait on the batch's results (its event)
``fetch``       the downloads of the batch's results
``glz_decode``  the up link's decode on the card (glz link on only)
``glz_encode``  the down link's encode on the card (glz link on only)
``spill_rerun`` the card re-run of a batch whose fused attempt failed
``socket_accept``  the SPU monitoring socket's per-client handler
==============  ==========================================================

Arming, by API (the port reads no environment variable)::

    from fluvio_tpu_torch.resilience import faults
    faults.FAULTS.inject("device", first=2)      # fire on the first 2 hits
    faults.FAULTS.inject("fetch", every=3)       # every 3rd hit
    faults.FAULTS.inject("h2d", prob=0.01, seed=7)  # 1% of hits, seeded
    faults.FAULTS.inject("dispatch", first=1, exc="deterministic")
    faults.FAULTS.clear()

`FaultRegistry.load_env_spec` parses the reference's spec string (for a
test or a config that carries one)::

    "device:first=2;fetch:every=3,exc=deterministic"

Grammar: ``;``-separated entries, each ``point:field=value[,field=value]``
with exactly one trigger field (``every=N`` | ``first=K`` | ``prob=P``)
and optional ``exc=transient|deterministic`` (default transient) and
``seed=N`` (for ``prob``).

Hot-path contract: `maybe_fire(point)` is the seam call. With nothing
armed it is one module-global ``None`` check.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

FAULT_POINTS = (
    "stage",
    "h2d",
    "dispatch",
    "device",
    "fetch",
    "glz_decode",
    "glz_encode",
    "spill_rerun",
    "socket_accept",
)


class InjectedFault(RuntimeError):
    """The exception an armed fault point raises.

    ``transient`` drives the recovery classifier: transient faults are
    retried with backoff, deterministic ones go straight to the card
    re-run (and, failing that too, the quarantine).
    """

    def __init__(self, point: str, transient: bool = True, message: str = ""):
        super().__init__(
            message or f"injected fault at {point!r} "
            f"({'transient' if transient else 'deterministic'})"
        )
        self.point = point
        self.transient = transient


class FaultRule:
    """One armed fault point: trigger mode + exception template."""

    def __init__(
        self,
        point: str,
        every: Optional[int] = None,
        first: Optional[int] = None,
        prob: Optional[float] = None,
        exc=None,
        seed: Optional[int] = None,
    ):
        modes = [m for m in (every, first, prob) if m is not None]
        if len(modes) != 1:
            raise ValueError(f"fault point {point!r} needs exactly one of every/first/prob")
        if every is not None and every < 1:
            raise ValueError("every must be >= 1")
        if first is not None and first < 1:
            raise ValueError("first must be >= 1")
        if prob is not None and not (0.0 <= prob <= 1.0):
            raise ValueError("prob must be in [0, 1]")
        self.point = point
        self.every = every
        self.first = first
        self.prob = prob
        self.exc = exc
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(seed if seed is not None else 0xF1A7)

    def should_fire(self) -> bool:
        self.hits += 1
        if self.every is not None:
            return self.hits % self.every == 0
        if self.first is not None:
            return self.hits <= self.first
        return self._rng.random() < self.prob

    def make_exc(self) -> BaseException:
        if self.exc is None:
            return InjectedFault(self.point)
        if isinstance(self.exc, BaseException):
            # the armed instance is a template: raising the same object
            # again would chain its traceback across fires, so each fire
            # raises a fresh copy
            e = self.exc
            if isinstance(e, InjectedFault):
                return InjectedFault(e.point, transient=e.transient, message=str(e))
            try:
                return type(e)(*e.args)
            except Exception:  # noqa: BLE001 — an exotic __init__
                return e
        if isinstance(self.exc, type) and issubclass(self.exc, BaseException):
            return self.exc(f"injected fault at {self.point!r}")
        if self.exc == "deterministic":
            return InjectedFault(self.point, transient=False)
        return InjectedFault(self.point)


class FaultRegistry:
    """Process-global map of armed fault points (thread-safe arming;
    firing reads a snapshot dict, so seams never take the lock)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: Dict[str, FaultRule] = {}

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def inject(
        self,
        point: str,
        every: Optional[int] = None,
        first: Optional[int] = None,
        prob: Optional[float] = None,
        exc=None,
        seed: Optional[int] = None,
    ) -> FaultRule:
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r} (one of {FAULT_POINTS})")
        rule = FaultRule(point, every=every, first=first, prob=prob, exc=exc, seed=seed)
        with self._lock:
            rules = dict(self._rules)
            rules[point] = rule
            self._rules = rules
        _refresh_armed()
        return rule

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._rules = {}
            else:
                rules = dict(self._rules)
                rules.pop(point, None)
                self._rules = rules
        _refresh_armed()

    def rule(self, point: str) -> Optional[FaultRule]:
        return self._rules.get(point)

    def fire(self, point: str) -> None:
        rule = self._rules.get(point)
        if rule is not None and rule.should_fire():
            rule.fired += 1
            raise rule.make_exc()

    def load_env_spec(self, spec: str) -> None:
        """Arm from a spec string (see the module docstring).

        All or nothing: every entry parses before any arms, so a malformed
        spec cannot leave a prefix of its faults armed."""
        parsed = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            point, _, fields = entry.partition(":")
            point = point.strip()
            kwargs: Dict = {}
            for fld in fields.split(","):
                fld = fld.strip()
                if not fld:
                    continue
                key, _, val = fld.partition("=")
                key, val = key.strip(), val.strip()
                if key == "every":
                    kwargs["every"] = int(val)
                elif key == "first":
                    kwargs["first"] = int(val)
                elif key == "prob":
                    kwargs["prob"] = float(val)
                elif key == "seed":
                    kwargs["seed"] = int(val)
                elif key == "exc":
                    if val not in ("transient", "deterministic"):
                        raise ValueError(
                            f"fault spec exc must be transient|deterministic, got {val!r}")
                    kwargs["exc"] = val
                else:
                    raise ValueError(f"unknown fault spec field {key!r}")
            if point not in FAULT_POINTS:
                raise ValueError(f"unknown fault point {point!r} (one of {FAULT_POINTS})")
            FaultRule(point, **kwargs)  # validate the trigger fields now
            parsed.append((point, kwargs))
        for point, kwargs in parsed:
            self.inject(point, **kwargs)


FAULTS = FaultRegistry()

# the seam's fast path: None when nothing is armed, so `maybe_fire` costs
# one global load and an is-None test a seam
_ARMED: Optional[FaultRegistry] = None


def _refresh_armed() -> None:
    global _ARMED
    _ARMED = FAULTS if FAULTS.armed else None


def maybe_fire(point: str) -> None:
    """The seam call: raise the armed exception when ``point`` triggers."""
    if _ARMED is not None:
        _ARMED.fire(point)
