"""Per-chain fairness: weighted round-robin over bounded admission queues.

The port's copy of ``fluvio_tpu/admission/fairness.py``. One tenant's
build storm (the registry's storm thresholds are the trip signal) or
spill-heavy chain must not starve the rest. The queue layer gives every
chain its own BOUNDED deque and serves them by smooth weighted
round-robin (the nginx algorithm: each pop adds every contender's
effective weight to its credit, serves the max-credit chain, then
subtracts the credit total served) — so over any window a chain's share
of pops converges to its weight share regardless of how fast it
enqueues.

Storm penalty: `note_storm(chain)` drops the chain's effective weight by
``STORM_PENALTY`` until the cooldown expires — the pipeline calls it when
the chain's dispatches accumulate build events past the storm threshold,
so a churning tenant keeps *some* service (its own traffic still drains)
while everyone else keeps theirs.

Locking: one lock guards the queues/credits; no user code, telemetry
call, or dispatch ever runs under it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from fluvio_tpu_torch.admission.types import current_config
from fluvio_tpu_torch.telemetry import TELEMETRY

# effective-weight multiplier while a chain is storm-penalized
STORM_PENALTY = 0.125


class FairQueue:
    """Bounded per-chain FIFOs drained by smooth weighted round-robin."""

    def __init__(
        self,
        max_depth: Optional[int] = None,
        default_weight: float = 1.0,
        clock=time.monotonic,
    ) -> None:
        self.max_depth = max_depth if max_depth is not None else int(current_config().queue)
        self.default_weight = default_weight
        self.clock = clock
        self._lock = threading.Lock()
        self._queues: Dict[str, deque] = {}
        self._weights: Dict[str, float] = {}
        self._credits: Dict[str, float] = {}
        self._storm_until: Dict[str, float] = {}

    # -- registration --------------------------------------------------------

    def set_weight(self, chain: str, weight: float) -> None:
        with self._lock:
            self._weights[chain] = max(weight, 1e-6)

    def note_storm(self, chain: str, cooldown_s: float) -> None:
        """Penalize ``chain``'s effective weight until the cooldown
        passes (deterministic age-out: no reset call needed)."""
        until = self.clock() + cooldown_s
        with self._lock:
            self._storm_until[chain] = until

    def stormed(self, chain: str) -> bool:
        now = self.clock()
        with self._lock:
            return self._storm_until.get(chain, 0.0) > now

    def _effective_weight(self, chain: str, now: float) -> float:
        w = self._weights.get(chain, self.default_weight)
        if self._storm_until.get(chain, 0.0) > now:
            w *= STORM_PENALTY
        return max(w, 1e-6)

    # -- queue ops -----------------------------------------------------------

    def push(self, chain: str, item) -> bool:
        """Enqueue; False when the chain's bounded queue is full (the
        caller sheds with reason ``queue-full``)."""
        with self._lock:
            q = self._queues.get(chain)
            if q is None:
                q = self._queues.setdefault(chain, deque())
            if len(q) >= self.max_depth:
                return False
            q.append(item)
        TELEMETRY.gauge_add("admission_queue_depth", 1)
        return True

    def pop(self) -> Optional[Tuple[str, object]]:
        """Serve the next (chain, item) by weighted round-robin, or
        None when every queue is empty."""
        now = self.clock()
        with self._lock:
            contenders = [c for c, q in self._queues.items() if q]
            if not contenders:
                return None
            total = 0.0
            best = None
            for c in contenders:
                w = self._effective_weight(c, now)
                total += w
                self._credits[c] = self._credits.get(c, 0.0) + w
                if best is None or self._credits[c] > self._credits[best]:
                    best = c
            self._credits[best] -= total
            item = self._queues[best].popleft()
        TELEMETRY.gauge_add("admission_queue_depth", -1)
        return best, item

    def depth(self, chain: Optional[str] = None) -> int:
        with self._lock:
            if chain is not None:
                q = self._queues.get(chain)
                return len(q) if q else 0
            return sum(len(q) for q in self._queues.values())

    def drain(self) -> List[Tuple[str, object]]:
        """Shutdown: remove and return every queued item (chain order
        round-robin so no tenant's tail is preferred), releasing the
        queue-depth gauge exactly."""
        out: List[Tuple[str, object]] = []
        while True:
            nxt = self.pop()
            if nxt is None:
                return out
            out.append(nxt)

    def chains(self) -> Iterable[str]:
        with self._lock:
            return list(self._queues)
