"""dedup-filter: the source artifact of the bounded-window deduplication
SmartModule, a copy of ``fluvio_tpu/models/dedup_filter.py``'s ``SOURCE``.

Every SPU seeds its local store with it (`builtin_sources`), so a topic
config or a Predefined invocation can name it. Its transform is a Python
hook with no DSL program, seeded by a ``look_back`` hook: the engine runs
it as a host hook segment (`smartengine.hooks`), metered, and a topic that
deduplicates attaches it to its leader (`spu.smart_chain.ensure_dedup_chain`).
"""

from __future__ import annotations

SOURCE = '''
import time
from collections import OrderedDict

_state = {"count": 0, "age_ms": None, "seen": OrderedDict()}


def _dedup_key(record):
    key = record.key
    return key if key is not None else record.value


def _now_ms(record):
    ts = record.timestamp
    return ts if ts >= 0 else int(time.time() * 1000)


def _evict(now_ms):
    seen = _state["seen"]
    age_ms = _state["age_ms"]
    if age_ms is not None:
        while seen:
            _, ts = next(iter(seen.items()))
            if ts < now_ms - age_ms:
                seen.popitem(last=False)
            else:
                break
    count = _state["count"]
    while count and len(seen) > count:
        seen.popitem(last=False)


def _observe(record):
    seen = _state["seen"]
    key = _dedup_key(record)
    now = _now_ms(record)
    seen.pop(key, None)
    seen[key] = now
    _evict(now)


@smartmodule.init
def init(params):
    _state["count"] = int(params.get("count", "0"))
    age = params.get("age")  # milliseconds (dedup_to_invocation parity)
    _state["age_ms"] = int(age) if age is not None else None
    _state["seen"].clear()


@smartmodule.look_back
def look_back(record):
    _observe(record)


@smartmodule.filter
def dedup(record):
    key = _dedup_key(record)
    now = _now_ms(record)
    _evict(now)
    if key in _state["seen"]:
        return False
    _observe(record)
    return True
'''
