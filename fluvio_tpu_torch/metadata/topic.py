"""Topic spec/status.

Capability parity: fluvio-controlplane-metadata/src/topic/
{spec.rs:21-33,160,299, status.rs:229, deduplication.rs} — computed vs
assigned replica maps, cleanup policy, storage knobs, compression,
deduplication (bounds + filter transform), and the topic resolution state
machine the SC topic controller drives.

The port's copy of ``fluvio_tpu/metadata/topic.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional

from fluvio_tpu_torch.stream_model.core import Spec, Status


class CleanupPolicy(str, enum.Enum):
    DELETE = "delete"  # time/size retention drops old segments


@dataclass
class TopicStorageConfig:
    segment_size: Optional[int] = None  # bytes per segment
    max_partition_size: Optional[int] = None  # size-based retention


@dataclass
class Bounds:
    """Dedup window: how many records / how old (seconds)."""

    count: int = 0
    age_seconds: Optional[int] = None


@dataclass
class Transform:
    uses: str = ""  # SmartModule name
    with_params: Dict[str, str] = field(default_factory=dict)


@dataclass
class Filter:
    transform: Transform = field(default_factory=Transform)


@dataclass
class Deduplication:
    bounds: Bounds = field(default_factory=Bounds)
    filter: Filter = field(default_factory=Filter)


@dataclass
class PartitionMap:
    """One partition's assigned replica set (first entry = leader)."""

    id: int = 0
    replicas: List[int] = field(default_factory=list)


@dataclass
class ReplicaSpec:
    """Computed (partitions x replication, scheduler places) or Assigned
    (explicit partition maps). Parity: ReplicaSpec enum, spec.rs:160."""

    # computed form
    partitions: int = 1
    replication_factor: int = 1
    ignore_rack_assignment: bool = False
    # assigned form (non-empty wins over computed)
    maps: List[PartitionMap] = field(default_factory=list)

    @classmethod
    def computed(
        cls, partitions: int, replication_factor: int = 1, ignore_rack: bool = False
    ) -> "ReplicaSpec":
        return cls(
            partitions=partitions,
            replication_factor=replication_factor,
            ignore_rack_assignment=ignore_rack,
        )

    @classmethod
    def assigned(cls, maps: List[PartitionMap]) -> "ReplicaSpec":
        return cls(maps=maps)

    def is_assigned(self) -> bool:
        return bool(self.maps)


@dataclass
class TopicSpec(Spec):
    LABEL: ClassVar[str] = "Topic"
    KIND: ClassVar[str] = "topic"

    replicas: ReplicaSpec = field(default_factory=ReplicaSpec)
    cleanup_policy: Optional[CleanupPolicy] = None
    retention_seconds: Optional[int] = None  # time-based retention window
    storage: Optional[TopicStorageConfig] = None
    compression_type: str = "any"  # any|none|gzip|snappy|lz4|zstd
    deduplication: Optional[Deduplication] = None
    system: bool = False

    @classmethod
    def computed(cls, partitions: int, replication: int = 1) -> "TopicSpec":
        return cls(replicas=ReplicaSpec.computed(partitions, replication))


class TopicResolution(str, enum.Enum):
    INIT = "init"
    PENDING = "pending"
    INSUFFICIENT_RESOURCES = "insufficient_resources"
    INVALID_CONFIG = "invalid_config"
    PROVISIONED = "provisioned"

    def is_final(self) -> bool:
        return self in (
            TopicResolution.PROVISIONED,
            TopicResolution.INVALID_CONFIG,
        )


@dataclass
class TopicStatus(Status):
    resolution: TopicResolution = TopicResolution.INIT
    replica_map: Dict[int, List[int]] = field(default_factory=dict)
    reason: str = ""

    @classmethod
    def invalid(cls, reason: str) -> "TopicStatus":
        return cls(resolution=TopicResolution.INVALID_CONFIG, reason=reason)

    @classmethod
    def insufficient(cls, reason: str) -> "TopicStatus":
        return cls(resolution=TopicResolution.INSUFFICIENT_RESOURCES, reason=reason)


TopicSpec.STATUS = TopicStatus
