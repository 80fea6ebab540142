"""SPU global context (the port's copy of ``fluvio_tpu/spu/context.py``;
parity: fluvio-spu/src/core/global_context.rs:36-80).

Holds the config, the leader replicas, the local SmartModule store (seeded
with the port's built-in module sources), the one `SmartEngine` every
chain is built on, the metrics, and the cache of stateless stream chains
(`smart_chain.acquire_stream_chain`). Created once per broker and shared
by reference with every service handler. Constructing it without CUDA
and without ``smart_engine.device`` raises `EngineError`.
"""

from __future__ import annotations

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

    def create_replica(self, topic: str, partition: int = 0) -> LeaderReplicaState:
        """Create or load a leader replica."""
        key = partition_replica_key(topic, partition)
        if key not in self.leaders:
            self.leaders[key] = LeaderReplicaState(topic, partition, self.config.replication)
        return self.leaders[key]

    def leader_for(self, topic: str, partition: int) -> Optional[LeaderReplicaState]:
        return self.leaders.get(partition_replica_key(topic, partition))

    def close(self) -> None:
        for leader in self.leaders.values():
            leader.close()
        self.leaders.clear()
