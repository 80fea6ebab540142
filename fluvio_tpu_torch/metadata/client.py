"""MetadataClient: the SC's metadata backends (the port's copy of
``fluvio_tpu/metadata/client.py``).

Capability parity: fluvio-stream-dispatcher/src/metadata/{mod.rs:19,
local.rs:28} — the `MetadataClient` trait (retrieve_items / apply /
delete_item, a change hint) with a local-filesystem backend (one file per
object under ``<base>/<kind>/<key>.yaml``) and an in-memory backend. The
K8s CRD backend and its event stream are not ported.

`LocalMetadataClient` writes each object as JSON text through
`yaml_subset` (the JAX package's ``yaml.safe_load`` reads it) and reads
that or the block YAML the JAX package's SC writes, so either SC restarts
from a directory the other wrote. A file outside the YAML subset raises
`YamlSubsetError` rather than being skipped; an entry that parses but is
no object of its kind is skipped, as local.rs does.
"""

from __future__ import annotations

import asyncio
import os
from typing import Dict, List, TypeVar

from fluvio_tpu_torch.metadata import yaml_subset
from fluvio_tpu_torch.stream_model.core import MetadataStoreObject, Spec

S = TypeVar("S", bound=Spec)


class MetadataClient:
    """Backend interface. All methods are per-spec-type."""

    async def retrieve_items(self, spec_type: type) -> List[MetadataStoreObject]:
        raise NotImplementedError

    async def apply(self, obj: MetadataStoreObject) -> None:
        raise NotImplementedError

    async def delete_item(self, spec_type: type, key: str) -> None:
        raise NotImplementedError

    async def watch_changed(self, spec_type: type, timeout: float) -> bool:
        """Block up to ``timeout`` for a hint that the backend changed.

        Local backend: filesystem mtime polling; in-memory: an event. The
        dispatcher also resyncs periodically, so this is a wake-up hint,
        not a precise change feed.
        """
        await asyncio.sleep(timeout)
        return False


class InMemoryMetadataClient(MetadataClient):
    """Read-only / test backend (parity: SC ReadOnly run mode)."""

    def __init__(self) -> None:
        self._objects: Dict[str, Dict[str, MetadataStoreObject]] = {}
        self._changed = asyncio.Event()

    def _bucket(self, spec_type: type) -> Dict[str, MetadataStoreObject]:
        return self._objects.setdefault(spec_type.KIND, {})

    async def retrieve_items(self, spec_type: type) -> List[MetadataStoreObject]:
        return list(self._bucket(spec_type).values())

    async def apply(self, obj: MetadataStoreObject) -> None:
        self._bucket(type(obj.spec))[obj.key] = obj
        self._changed.set()

    async def delete_item(self, spec_type: type, key: str) -> None:
        self._bucket(spec_type).pop(key, None)
        self._changed.set()

    async def watch_changed(self, spec_type: type, timeout: float) -> bool:
        try:
            await asyncio.wait_for(self._changed.wait(), timeout)
            self._changed.clear()
            return True
        except asyncio.TimeoutError:
            return False


class LocalMetadataClient(MetadataClient):
    """Filesystem store: ``<base>/<kind>/<key>.yaml``.

    Parity: LocalMetadataStorage (metadata/local.rs), the SC Local run
    mode's durable store. Writes are atomic (tmp + rename); the change
    hint is directory-mtime polling.
    """

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self._last_seen: Dict[str, float] = {}

    def _dir_for(self, spec_type: type) -> str:
        d = os.path.join(self.base_dir, spec_type.KIND)
        os.makedirs(d, exist_ok=True)
        return d

    def _path_for(self, spec_type: type, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self._dir_for(spec_type), f"{safe}.yaml")

    async def retrieve_items(self, spec_type: type) -> List[MetadataStoreObject]:
        d = self._dir_for(spec_type)
        out: List[MetadataStoreObject] = []
        for name in sorted(os.listdir(d)):
            if not name.endswith(".yaml"):
                continue
            with open(os.path.join(d, name), "r", encoding="utf-8") as f:
                data = yaml_subset.loads(f.read())
            if not data:
                continue
            try:
                out.append(MetadataStoreObject.from_dict(spec_type, data))
            except (KeyError, TypeError, ValueError):
                continue  # an entry that is no object of this kind (local.rs skips)
        return out

    async def apply(self, obj: MetadataStoreObject) -> None:
        path = self._path_for(type(obj.spec), obj.key)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(yaml_subset.dumps(obj.to_dict(), sort_keys=True))
        os.replace(tmp, path)

    async def delete_item(self, spec_type: type, key: str) -> None:
        try:
            os.remove(self._path_for(spec_type, key))
        except FileNotFoundError:
            pass

    def _mtime(self, spec_type: type) -> float:
        d = self._dir_for(spec_type)
        latest = os.stat(d).st_mtime
        for name in os.listdir(d):
            try:
                latest = max(latest, os.stat(os.path.join(d, name)).st_mtime)
            except FileNotFoundError:
                continue
        return latest

    async def watch_changed(self, spec_type: type, timeout: float) -> bool:
        deadline = asyncio.get_running_loop().time() + timeout
        # fast polling only for short timeouts; the 300 s reconcile window
        # polls at 0.5 s to keep idle I/O negligible
        poll = min(0.05 if timeout <= 5 else 0.5, timeout)
        while True:
            m = self._mtime(spec_type)
            if m != self._last_seen.get(spec_type.KIND):
                self._last_seen[spec_type.KIND] = m
                return True
            if asyncio.get_running_loop().time() >= deadline:
                return False
            await asyncio.sleep(poll)
