"""SPU global context (the port's copy of ``fluvio_tpu/spu/context.py``;
parity: fluvio-spu/src/core/global_context.rs:36-80).

Holds the config, the leader replicas with the topic config the SC
mirrors to each (`replica_configs`), the local SmartModule store (seeded
with the port's built-in module sources, and fed by the SC dispatcher),
the one `SmartEngine` every chain is built on, the metrics, and the cache
of stateless stream chains (`smart_chain.acquire_stream_chain`). Created
once per broker and shared by reference with every service handler. Constructing it without CUDA
and without ``smart_engine.device`` raises `EngineError`.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

from fluvio_tpu_torch.models import builtin_sources
from fluvio_tpu_torch.smartengine.engine import SmartEngine
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.metrics import SpuMetrics
from fluvio_tpu_torch.spu.replica import LeaderReplicaState
from fluvio_tpu_torch.types import partition_replica_key


class SmartModuleLocalStore:
    """Named SmartModule source payloads that Predefined invocations
    resolve against (parity: fluvio-spu/src/smartengine/context.rs:95)."""

    def __init__(self) -> None:
        self._modules: Dict[str, bytes] = {}

    def insert(self, name: str, payload: bytes) -> None:
        self._modules[name] = payload

    def get(self, name: str) -> Optional[bytes]:
        return self._modules.get(name)

    def remove(self, name: str) -> None:
        self._modules.pop(name, None)

    def names(self) -> list[str]:
        return sorted(self._modules)


class GlobalContext:
    def __init__(self, config: SpuConfig):
        self.config = config
        self.leaders: Dict[str, LeaderReplicaState] = {}
        # mirrored topic config per replica key (dedup / storage knobs),
        # pushed by the SC inside Replica.config
        self.replica_configs: Dict[str, dict] = {}
        self.smartmodules = SmartModuleLocalStore()
        for name, payload in builtin_sources().items():
            self.smartmodules.insert(name, payload)
        self.engine = SmartEngine(
            device=config.smart_engine.device,
            store_max_memory=config.smart_engine.store_max_memory,
        )
        self.metrics = SpuMetrics()
        # stateless stream chains keyed by invocation fingerprint (LRU): a
        # chain built once serves every stream that sends the same modules
        self.stream_chains: "OrderedDict[str, object]" = OrderedDict()

    def create_replica(
        self, topic: str, partition: int = 0, topic_config: Optional[dict] = None
    ) -> LeaderReplicaState:
        """Create or load a leader replica (control-plane
        `ReplicaChange::Add`); ``topic_config`` is the topic config the SC
        mirrors into the assignment."""
        key = partition_replica_key(topic, partition)
        if topic_config is not None:
            self.replica_configs[key] = topic_config
        if key not in self.leaders:
            self.leaders[key] = LeaderReplicaState(topic, partition, self._storage_config(key))
        return self.leaders[key]

    def leader_for(self, topic: str, partition: int) -> Optional[LeaderReplicaState]:
        return self.leaders.get(partition_replica_key(topic, partition))

    def replica_config(self, topic: str, partition: int) -> dict:
        return self.replica_configs.get(partition_replica_key(topic, partition), {})

    def _storage_config(self, key: str):
        """The process's ReplicaConfig with the topic's segment size
        applied, as the reference maps TopicStorageConfig onto the
        replica's storage. Retention and the partition size are not
        ported (`unenforced_retention`)."""
        cfg = self.config.replication
        storage = (self.replica_configs.get(key) or {}).get("storage") or {}
        if storage.get("segment_size") is None:
            return cfg
        return dataclasses.replace(cfg, segment_max_bytes=int(storage["segment_size"]))

    def unenforced_retention(self, topic: str, partition: int) -> Optional[str]:
        """What of retention the topic's config sets, or None: its
        ``retention_seconds`` or ``storage.max_partition_size``. The
        reference's cleaner drops old segments by them; the port has no
        cleaner, so a produce to such a topic answers ``STORAGE_ERROR``
        rather than keep data the topic says to drop."""
        config = self.replica_config(topic, partition)
        set_ = []
        if config.get("retention_seconds") is not None:
            set_.append(f"retention_seconds={config['retention_seconds']}")
        max_size = (config.get("storage") or {}).get("max_partition_size")
        if max_size is not None:
            set_.append(f"max_partition_size={max_size}")
        return ", ".join(set_) or None

    def close(self) -> None:
        for leader in self.leaders.values():
            leader.close()
        self.leaders.clear()
