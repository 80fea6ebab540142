"""Poison-batch quarantine: the bounded on-disk dead-letter directory.

The port's counterpart of ``fluvio_tpu/resilience/deadletter.py``, with the
same entry layout, so each package reads the other's entries. A batch
whose fused attempt (after its retries) and card re-run both fail is
poison: crashing the stream on it hands one corrupt record a denial of
service, and dropping it silently loses data with no trace. The
quarantine dumps it, a replayable chain spec, its records and both
errors, into a bounded dead-letter directory, counts it, and the stream
advances.

Entry layout (one JSON file a batch, ``dl-<ms>-<seq>.json``)::

    {
      "ts_ms": 1722672000000,
      "chain": [{"name", "params", "kind", "initial"?}, ...],
      "errors": {"fused": "...", "interpreter": "..."},
      "batch": {
        "base_offset": 0, "base_timestamp": -1,
        "records": [{"value": <b64>, "key": <b64>|null,
                     "offset_delta": 0, "timestamp_delta": 0}, ...]
      }
    }

The second error is the card re-run's; it sits under the reference's key,
``interpreter``, where the JAX package puts its interpreter re-run's.

Bounded: at most ``ResilienceConfig.deadletter_max`` entries (default
64), the oldest evicted first, in ``ResilienceConfig.deadletter_dir``
(default ``/tmp/fluvio-tpu-deadletter``, the reference's, for a bare
engine; an SPU puts it under its own ``log_base_dir``, see
`spu.config.SpuConfig`). An unwritable directory only counts: the
quarantine never crashes the stream it exists to protect. Each write sets
the ``deadletter_entries`` gauge to the entries resident. The write is
synchronous on the thread that runs the chain, and an entry grows with
its batch (every value base64 in JSON), so a large poison batch holds its
stream for the write's time.

`load_entry` rebuilds the `SmartModuleInput` (and returns the chain spec)
so an operator, or a test, can replay a quarantined batch after a fix.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import time
from typing import List, Optional, Tuple

from fluvio_tpu_torch.resilience.policy import DEFAULT_RESILIENCE, ResilienceConfig
from fluvio_tpu_torch.telemetry import TELEMETRY

logger = logging.getLogger(__name__)


_SEQ = [0]


def _b64(data: Optional[bytes]) -> Optional[str]:
    if data is None:
        return None
    return base64.b64encode(bytes(data)).decode("ascii")


def _unb64(data: Optional[str]) -> Optional[bytes]:
    if data is None:
        return None
    return base64.b64decode(data)


def _entry_paths(path: str) -> List[str]:
    try:
        names = sorted(n for n in os.listdir(path) if n.startswith("dl-") and n.endswith(".json"))
    except OSError:
        return []
    return [os.path.join(path, n) for n in names]


def quarantine_batch(
    chain_spec: List[dict],
    inp,
    fused_error: BaseException,
    rerun_error: BaseException,
    config: ResilienceConfig = DEFAULT_RESILIENCE,
) -> Optional[str]:
    """Write one dead-letter entry into ``config.deadletter_dir``; returns
    its path (None when the directory is unwritable: the caller still
    counts the quarantine)."""
    path = config.deadletter_dir
    try:
        return _write_entry(chain_spec, inp, fused_error, rerun_error, path,
                            config.deadletter_max)
    except Exception as e:  # noqa: BLE001 — never crash the stream this path protects
        logger.error("dead-letter write failed (%s): %s", path, e)
        return None


def _write_entry(chain_spec, inp, fused_error, rerun_error, path: str, limit: int) -> str:
    try:
        records = inp.into_records()
    except Exception:  # noqa: BLE001 — a poison batch may not even decode
        records = []
    entry = {
        "ts_ms": int(time.time() * 1000),
        "chain": chain_spec,
        "errors": {
            "fused": f"{type(fused_error).__name__}: {fused_error}",
            "interpreter": f"{type(rerun_error).__name__}: {rerun_error}",
        },
        "batch": {
            "base_offset": int(getattr(inp, "base_offset", 0)),
            "base_timestamp": int(getattr(inp, "base_timestamp", -1)),
            "records": [
                {
                    "value": _b64(r.value),
                    "key": _b64(r.key),
                    "offset_delta": int(r.offset_delta),
                    "timestamp_delta": int(r.timestamp_delta),
                }
                for r in records
            ],
        },
    }
    _SEQ[0] += 1
    name = f"dl-{entry['ts_ms']:013d}-{_SEQ[0]:06d}.json"
    os.makedirs(path, exist_ok=True)
    # evict the oldest first so the directory stays bounded even when a
    # poison storm outpaces any operator
    existing = _entry_paths(path)
    while len(existing) >= max(limit, 1):
        victim = existing.pop(0)
        try:
            os.remove(victim)
        except OSError:  # a concurrent eviction
            pass
    full = os.path.join(path, name)
    tmp = full + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            # default=repr: a chain spec with a non-JSON param value
            # degrades to its repr instead of aborting the quarantine
            json.dump(entry, f, indent=1, default=repr)
        os.replace(tmp, full)
    finally:
        if os.path.exists(tmp):  # a failed dump leaves no debris
            os.remove(tmp)
    TELEMETRY.gauge_set("deadletter_entries", len(_entry_paths(path)))
    return full


def load_entry(path: str) -> Tuple[List[dict], "object"]:
    """Rebuild (chain_spec, SmartModuleInput) from a dead-letter entry."""
    from fluvio_tpu_torch.protocol.record import Record
    from fluvio_tpu_torch.smartmodule.types import SmartModuleInput

    with open(path, "r", encoding="utf-8") as f:
        entry = json.load(f)
    batch = entry.get("batch") or {}
    records = [
        Record(
            value=_unb64(r.get("value")) or b"",
            key=_unb64(r.get("key")),
            offset_delta=int(r.get("offset_delta", 0)),
            timestamp_delta=int(r.get("timestamp_delta", 0)),
        )
        for r in batch.get("records") or []
    ]
    inp = SmartModuleInput.from_records(
        records,
        base_offset=int(batch.get("base_offset", 0)),
        base_timestamp=int(batch.get("base_timestamp", -1)),
    )
    return entry.get("chain") or [], inp
