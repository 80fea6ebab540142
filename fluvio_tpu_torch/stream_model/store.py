"""LocalStore + StoreContext: the async store every controller listens on.

The port's copy of ``fluvio_tpu/stream_model/store.py`` (parity:
fluvio-stream-model/src/store/{dual_store.rs,event.rs}): `LocalStore`
wraps the DualEpochMap behind an async notify bus; a `ChangeListener`
wakes when the store's epoch moves past what it has seen (`listen` /
`sync_changes`); `StoreContext.wait_action` waits for a change to land
(the admin API acks a topic create with it). The port keeps its metadata
in memory only, so `StoreContext` writes the store and queues no action
for a durable backend.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Generic, List, Optional, TypeVar

from fluvio_tpu_torch.stream_model.core import MetadataStoreObject, Spec
from fluvio_tpu_torch.stream_model.epoch import DualEpochMap, EpochChanges

S = TypeVar("S", bound=Spec)


class ChangeListener(Generic[S]):
    """Cursor over a store's epoch stream."""

    def __init__(self, store: "LocalStore[S]", filter: str = "all"):
        self._store = store
        self._filter = filter
        self._epoch = -1  # first listen returns a full sync

    def has_change(self) -> bool:
        return self._store.epoch() > self._epoch

    async def listen(self) -> None:
        """Block until the store moves past this listener's epoch."""
        while not self.has_change():
            await self._store._wait_for_change()

    def sync_changes(self) -> EpochChanges[S]:
        changes = self._store._map.changes_since(self._epoch, self._filter)
        self._epoch = changes.epoch
        return changes

    def set_current(self) -> None:
        self._epoch = self._store.epoch()


class LocalStore(Generic[S]):
    def __init__(self, spec_type: type):
        self.spec_type = spec_type
        self._map: DualEpochMap[S] = DualEpochMap()
        self._cond: Optional[asyncio.Condition] = None

    def _condition(self) -> asyncio.Condition:
        if self._cond is None:
            self._cond = asyncio.Condition()
        return self._cond

    async def _wait_for_change(self) -> None:
        epoch = self.epoch()
        cond = self._condition()
        async with cond:
            while self.epoch() == epoch:
                await cond.wait()

    def _notify(self) -> None:
        cond = self._condition()

        async def wake() -> None:
            async with cond:
                cond.notify_all()

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop: nothing is listening
        loop.create_task(wake())

    # -- reads ---------------------------------------------------------------

    def epoch(self) -> int:
        return self._map.epoch

    def value(self, key: str) -> Optional[MetadataStoreObject[S]]:
        return self._map.get(key)

    def values(self) -> List[MetadataStoreObject[S]]:
        return self._map.values()

    def keys(self) -> List[str]:
        return self._map.keys()

    def count(self) -> int:
        return len(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    # -- writes --------------------------------------------------------------

    def apply(self, obj: MetadataStoreObject[S]) -> bool:
        changed = self._map.apply(obj)
        if changed:
            self._notify()
        return changed

    def update_spec(self, key: str, spec: S) -> bool:
        changed = self._map.update_spec(key, spec)
        if changed:
            self._notify()
        return changed

    def update_status(self, key: str, status) -> bool:
        changed = self._map.update_status(key, status)
        if changed:
            self._notify()
        return changed

    def delete(self, key: str) -> bool:
        changed = self._map.delete(key)
        if changed:
            self._notify()
        return changed

    def sync_all(self, objects: List[MetadataStoreObject[S]]) -> bool:
        changed = self._map.sync_all(objects)
        if changed:
            self._notify()
        return changed

    # -- listeners -----------------------------------------------------------

    def change_listener(self, filter: str = "all") -> ChangeListener[S]:
        return ChangeListener(self, filter)


class StoreContext(Generic[S]):
    """A store and the async write API controllers use (parity:
    StoreContext in dual_store.rs, without its metadata-backend actions)."""

    def __init__(self, spec_type: type):
        self.spec_type = spec_type
        self.store: LocalStore[S] = LocalStore(spec_type)

    async def apply(self, obj: MetadataStoreObject[S]) -> None:
        self.store.apply(obj)

    async def update_spec(self, key: str, spec: S) -> None:
        self.store.update_spec(key, spec)

    async def update_status(self, key: str, status) -> None:
        self.store.update_status(key, status)

    async def delete(self, key: str) -> None:
        self.store.delete(key)

    async def wait_action(
        self,
        key: str,
        predicate: Callable[[Optional[MetadataStoreObject[S]]], bool],
        timeout: float = 10.0,
    ) -> Optional[MetadataStoreObject[S]]:
        """Wait until ``predicate(store.value(key))`` holds (or timeout)."""
        listener = self.store.change_listener()
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            obj = self.store.value(key)
            if predicate(obj):
                return obj
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return obj
            try:
                await asyncio.wait_for(listener.listen(), timeout=remaining)
            except asyncio.TimeoutError:
                return self.store.value(key)
            listener.set_current()
