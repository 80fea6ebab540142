"""Offset and timestamp aliases, replica keys and the in-process events.

The port's copy of the primitives of ``fluvio_tpu/types.py``: the
``Offset`` and ``Timestamp`` aliases, ``NO_TIMESTAMP``, the SPU's public
port and `partition_replica_key`, `StickyEvent` (a one-way latch for
end-of-life signals) and `OffsetPublisher` / `OffsetChangeListener`, a
monotonic value with per-listener change wakeups (the bus that wakes
consumer streams when a partition's committed offset advances). They are
asyncio-native: a listener awaits a change, an update from any thread
wakes the loop its listeners wait on.
"""

from __future__ import annotations

import asyncio
from typing import Optional

Offset = int
Timestamp = int  # milliseconds since epoch; NO_TIMESTAMP = -1

NO_TIMESTAMP: Timestamp = -1

SPU_PUBLIC_PORT = 9010


def partition_replica_key(topic: str, partition: int) -> str:
    """Canonical replica id, e.g. ``my-topic-0``."""
    return f"{topic}-{partition}"


class StickyEvent:
    """One-way latch: once notified, stays set (server shutdown, the end of
    a connection's streams)."""

    def __init__(self) -> None:
        self._event = asyncio.Event()

    def notify(self) -> None:
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        await self._event.wait()


class OffsetChangeListener:
    """Listener handle on an :class:`OffsetPublisher`.

    ``listen()`` returns as soon as the published value differs from the last
    value this listener observed (immediately, if it already differs).
    """

    def __init__(self, publisher: "OffsetPublisher") -> None:
        self._publisher = publisher
        self._last_seen: Offset = publisher.current_value()
        self._cond = publisher._cond

    def last_seen(self) -> Offset:
        return self._last_seen

    async def listen(self) -> Offset:
        self._publisher._loop = asyncio.get_running_loop()
        async with self._cond:
            while self._publisher.current_value() == self._last_seen:
                await self._cond.wait()
            self._last_seen = self._publisher.current_value()
            return self._last_seen

    def sync(self) -> Offset:
        """Mark the current value as seen and return it (non-blocking)."""
        self._last_seen = self._publisher.current_value()
        return self._last_seen


class OffsetPublisher:
    """Monotonic offset bus: publishes a value, wakes all listeners on change."""

    def __init__(self, initial: Offset = -1) -> None:
        self._value: Offset = initial
        self._cond = asyncio.Condition()
        self._pending: set = set()  # keep notify tasks alive until done
        self._loop: Optional[asyncio.AbstractEventLoop] = None  # listeners' loop

    def current_value(self) -> Offset:
        return self._value

    def _schedule_notify(self, loop: asyncio.AbstractEventLoop) -> None:
        task = loop.create_task(self._notify())
        self._pending.add(task)
        task.add_done_callback(self._pending.discard)

    def update(self, value: Offset) -> None:
        if value == self._value:
            return
        self._value = value
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # called from a thread with no loop: wake the listeners on the
            # loop they wait in, if one is known
            loop = self._loop
            if loop is None or loop.is_closed():
                return
            loop.call_soon_threadsafe(self._schedule_notify, loop)
            return
        self._loop = loop
        self._schedule_notify(loop)

    async def update_async(self, value: Offset) -> None:
        if value == self._value:
            return
        self._loop = asyncio.get_running_loop()
        async with self._cond:
            self._value = value
            self._cond.notify_all()

    async def _notify(self) -> None:
        async with self._cond:
            self._cond.notify_all()

    def change_listener(self) -> OffsetChangeListener:
        return OffsetChangeListener(self)
