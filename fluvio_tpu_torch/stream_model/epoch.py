"""Dual-epoch object map with change fencing (the port's copy of
``fluvio_tpu/stream_model/epoch.py``).

Capability parity: fluvio-stream-model/src/epoch/dual_epoch_map.rs — every
mutation bumps a global epoch; each object remembers the epoch of its last
spec change and last status change separately, so a listener holding epoch
E gets back exactly {spec-changed, status-changed, deleted} sets since E,
or a full resync if E is older than the deletion horizon.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Generic, List, Optional, Tuple, TypeVar

from fluvio_tpu_torch.stream_model.core import MetadataStoreObject, Spec

S = TypeVar("S", bound=Spec)


@dataclass
class _Entry(Generic[S]):
    obj: MetadataStoreObject[S]
    spec_epoch: int
    status_epoch: int


@dataclass
class EpochChanges(Generic[S]):
    """What happened since the listener's epoch."""

    epoch: int  # current store epoch (listener should fast-forward to this)
    updates: List[MetadataStoreObject[S]] = field(default_factory=list)
    deletes: List[str] = field(default_factory=list)
    is_sync_all: bool = False  # listener too old: treat updates as full set

    def has_changes(self) -> bool:
        return self.is_sync_all or bool(self.updates) or bool(self.deletes)


class DualEpochMap(Generic[S]):
    def __init__(self) -> None:
        self._entries: Dict[str, _Entry[S]] = {}
        self._epoch = 0
        # (epoch, key) of deletions, pruned to a bounded horizon
        self._deletions: List[Tuple[int, str]] = []
        self._deletion_horizon = 0  # oldest epoch deletions are retained for

    @property
    def epoch(self) -> int:
        return self._epoch

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str) -> Optional[MetadataStoreObject[S]]:
        entry = self._entries.get(key)
        return entry.obj if entry else None

    def values(self) -> List[MetadataStoreObject[S]]:
        return [e.obj for e in self._entries.values()]

    def keys(self) -> List[str]:
        return list(self._entries)

    # -- mutation (each returns whether something changed) -------------------

    def apply(self, obj: MetadataStoreObject[S]) -> bool:
        """Insert or update spec+status; bumps revision on change."""
        entry = self._entries.get(obj.key)
        if entry is not None and entry.obj.spec == obj.spec and entry.obj.status == obj.status:
            return False
        self._epoch += 1
        if entry is None:
            obj.revision = 0
            self._entries[obj.key] = _Entry(obj, self._epoch, self._epoch)
        else:
            spec_changed = entry.obj.spec != obj.spec
            status_changed = entry.obj.status != obj.status
            obj.revision = entry.obj.revision + 1
            entry.obj = obj
            if spec_changed:
                entry.spec_epoch = self._epoch
            if status_changed:
                entry.status_epoch = self._epoch
        return True

    def update_spec(self, key: str, spec: S) -> bool:
        entry = self._entries.get(key)
        if entry is None:
            return self.apply(MetadataStoreObject(key=key, spec=spec))
        if entry.obj.spec == spec:
            return False
        self._epoch += 1
        entry.obj = entry.obj.with_spec(spec)
        entry.obj.revision += 1
        entry.spec_epoch = self._epoch
        return True

    def update_status(self, key: str, status) -> bool:
        entry = self._entries.get(key)
        if entry is None:
            return False
        if entry.obj.status == status:
            return False
        self._epoch += 1
        entry.obj = entry.obj.with_status(status)
        entry.obj.revision += 1
        entry.status_epoch = self._epoch
        return True

    MAX_DELETIONS = 1024  # auto-prune bound; older listeners full-resync

    def delete(self, key: str) -> bool:
        if key not in self._entries:
            return False
        self._epoch += 1
        del self._entries[key]
        self._deletions.append((self._epoch, key))
        if len(self._deletions) > self.MAX_DELETIONS:
            # keep the newer half; listeners older than the horizon get
            # a full sync from changes_since
            mid_epoch = self._deletions[len(self._deletions) // 2][0]
            self.prune_deletions(mid_epoch)
        return True

    def sync_all(self, objects: List[MetadataStoreObject[S]]) -> bool:
        """Full resync: apply all, delete everything absent."""
        incoming = {o.key for o in objects}
        changed = False
        for key in list(self._entries):
            if key not in incoming:
                changed |= self.delete(key)
        for obj in objects:
            changed |= self.apply(obj)
        return changed

    # -- change fencing ------------------------------------------------------

    def changes_since(self, epoch: int, filter: str = "all") -> EpochChanges[S]:
        """Changes after ``epoch``; filter in {"all", "spec", "status"}.

        If ``epoch`` predates the deletion horizon, returns a full sync
        (the listener can't reconstruct which keys were deleted).
        """
        if epoch < self._deletion_horizon or epoch < 0:
            return EpochChanges(
                epoch=self._epoch,
                updates=[e.obj for e in self._entries.values()],
                is_sync_all=True,
            )
        updates = []
        for entry in self._entries.values():
            if filter == "spec":
                marker = entry.spec_epoch
            elif filter == "status":
                marker = entry.status_epoch
            else:
                marker = max(entry.spec_epoch, entry.status_epoch)
            if marker > epoch:
                updates.append(entry.obj)
        deletes = [k for (e, k) in self._deletions if e > epoch]
        return EpochChanges(epoch=self._epoch, updates=updates, deletes=deletes)

    def prune_deletions(self, keep_from_epoch: int) -> None:
        """Drop deletion records older than ``keep_from_epoch``; listeners
        older than that will get full resyncs."""
        self._deletion_horizon = max(self._deletion_horizon, keep_from_epoch)
        self._deletions = [
            (e, k) for (e, k) in self._deletions if e > keep_from_epoch
        ]
