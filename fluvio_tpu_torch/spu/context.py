"""SPU global context (the port's copy of ``fluvio_tpu/spu/context.py``;
parity: fluvio-spu/src/core/global_context.rs:36-80).

Holds the config, the leader replicas and the replicas this SPU follows
(`followers`), with the topic config the SC mirrors to each
(`replica_configs`: its retention window, segment size and partition
size become the replica's storage config), the peer SPUs' endpoints the
SC pushes (`peers`), the local SmartModule store (seeded with the port's
built-in module sources, and fed by the SC dispatcher), the one
`SmartEngine` every chain is built on, the metrics, and the cache of
stateless stream chains (`smart_chain.acquire_stream_chain`). A leader's
in-sync quorum is the size of its replica set. A follower is promoted to
leader, and a leader demoted to follower, on the storage it has on disk.
Created once per broker and shared by reference with every service
handler. Constructing it without CUDA and without
``smart_engine.device`` raises `EngineError`.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import TYPE_CHECKING, Dict, Optional

from fluvio_tpu_torch.models import builtin_sources
from fluvio_tpu_torch.smartengine.engine import SmartEngine
from fluvio_tpu_torch.spu.config import SpuConfig
from fluvio_tpu_torch.spu.metrics import SpuMetrics
from fluvio_tpu_torch.spu.replica import LeaderReplicaState
from fluvio_tpu_torch.types import partition_replica_key

if TYPE_CHECKING:
    from fluvio_tpu_torch.spu.follower import FollowerReplicaState


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
        # replicas this SPU follows, keyed like leaders
        self.followers: Dict[str, "FollowerReplicaState"] = {}
        # peer SPU endpoints pushed by the SC (id -> SpuUpdate)
        self.peers: Dict[int, object] = {}
        # set by SpuServer: woken when assignments or peers change
        self.followers_controller = None
        # mirrored topic config per replica key (dedup / storage knobs),
        # pushed by the SC inside Replica.config
        self.replica_configs: Dict[str, dict] = {}
        self.smartmodules = SmartModuleLocalStore()
        for name, payload in builtin_sources().items():
            self.smartmodules.insert(name, payload)
        self.engine = SmartEngine(
            device=config.smart_engine.device,
            store_max_memory=config.smart_engine.store_max_memory,
            hook_budget_ms=config.smart_engine.hook_budget_ms,
        )
        self.metrics = SpuMetrics()
        # stateless stream chains keyed by invocation fingerprint (LRU): a
        # chain built once serves every stream that sends the same modules
        self.stream_chains: "OrderedDict[str, object]" = OrderedDict()

    def create_replica(
        self,
        topic: str,
        partition: int = 0,
        replica_count: Optional[int] = None,
        topic_config: Optional[dict] = None,
    ) -> LeaderReplicaState:
        """Create or load a leader replica (control-plane
        `ReplicaChange::Add`); ``topic_config`` is the topic config the SC
        mirrors into the assignment.

        ``replica_count`` (the SC-pushed replica set's size) sets the
        in-sync quorum: the HW advances once every follower in the set has
        the record. A replica created without it (no SC) takes the
        process's ``in_sync_replica`` (default 1: the HW advances on the
        local write).
        """
        key = partition_replica_key(topic, partition)
        if topic_config is not None:
            self.replica_configs[key] = topic_config
        if key not in self.leaders:
            in_sync = replica_count if replica_count is not None else self.config.in_sync_replica
            self.leaders[key] = LeaderReplicaState(
                topic, partition, self._storage_config(key), max(1, in_sync)
            )
        elif replica_count is not None:
            self.leaders[key].in_sync_replica = max(1, replica_count)
        return self.leaders[key]

    def create_follower(
        self, topic: str, partition: int, leader: int, topic_config: Optional[dict] = None
    ) -> "FollowerReplicaState":
        from fluvio_tpu_torch.spu.follower import FollowerReplicaState

        key = partition_replica_key(topic, partition)
        if topic_config is not None:
            self.replica_configs[key] = topic_config
        if key not in self.followers:
            self.followers[key] = FollowerReplicaState(
                topic, partition, leader, self._storage_config(key)
            )
        return self.followers[key]

    def promote_follower(self, topic: str, partition: int) -> LeaderReplicaState:
        """Follower -> leader on election; the storage carries over on
        disk (parity: the SPU's replica-change handling when the SC
        re-points a partition's leader at this SPU,
        control_plane/dispatcher.rs)."""
        key = partition_replica_key(topic, partition)
        follower = self.followers.pop(key, None)
        if follower is not None:
            follower.close()  # FileReplica reloads the same directory
        return self.create_replica(topic, partition)

    def demote_leader(self, topic: str, partition: int, new_leader: int) -> "FollowerReplicaState":
        """Leader -> follower of ``new_leader``, on the same storage."""
        key = partition_replica_key(topic, partition)
        leader = self.leaders.pop(key, None)
        if leader is not None:
            leader.close()
        return self.create_follower(topic, partition, new_leader)

    def leader_for(self, topic: str, partition: int) -> Optional[LeaderReplicaState]:
        return self.leaders.get(partition_replica_key(topic, partition))

    def follower_for(self, topic: str, partition: int) -> Optional["FollowerReplicaState"]:
        return self.followers.get(partition_replica_key(topic, partition))

    def replica_config(self, topic: str, partition: int) -> dict:
        return self.replica_configs.get(partition_replica_key(topic, partition), {})

    def notify_followers_changed(self) -> None:
        if self.followers_controller is not None:
            self.followers_controller.notify()

    def _storage_config(self, key: str):
        """The process's ReplicaConfig with the topic's storage overrides
        (retention, segment size, partition size) applied, as the
        reference maps TopicStorageConfig onto the replica's storage."""
        cfg = self.config.replication
        topic_config = self.replica_configs.get(key) or {}
        overrides = {}
        if topic_config.get("retention_seconds") is not None:
            overrides["retention_seconds"] = int(topic_config["retention_seconds"])
        storage = topic_config.get("storage") or {}
        if storage.get("segment_size") is not None:
            overrides["segment_max_bytes"] = int(storage["segment_size"])
        if storage.get("max_partition_size") is not None:
            overrides["max_partition_size"] = int(storage["max_partition_size"])
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    def close(self) -> None:
        for leader in self.leaders.values():
            leader.close()
        self.leaders.clear()
        for follower in self.followers.values():
            follower.close()
        self.followers.clear()
