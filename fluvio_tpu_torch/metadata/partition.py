"""Partition spec/status.

Capability parity: fluvio-controlplane-metadata/src/partition/
{spec.rs:85, status.rs:209} — leader + replica set, mirrored topic config,
and the status the SC partition controller / election reducer drives
(resolution, leader replica status, live-replica set).

The port's copy of ``fluvio_tpu/metadata/partition.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, List, Optional

from fluvio_tpu_torch.metadata.topic import CleanupPolicy, Deduplication, TopicStorageConfig
from fluvio_tpu_torch.stream_model.core import Spec, Status


@dataclass
class PartitionSpec(Spec):
    LABEL: ClassVar[str] = "Partition"
    KIND: ClassVar[str] = "partition"

    leader: int = 0
    replicas: List[int] = field(default_factory=list)
    # config mirrored down from the topic at provisioning time
    cleanup_policy: Optional[CleanupPolicy] = None
    storage: Optional[TopicStorageConfig] = None
    retention_seconds: Optional[int] = None  # mirrored topic retention
    compression_type: str = "any"
    deduplication: Optional[Deduplication] = None
    system: bool = False

    def has_spu(self, spu_id: int) -> bool:
        return spu_id in self.replicas

    def followers(self) -> List[int]:
        return [r for r in self.replicas if r != self.leader]


class PartitionResolution(str, enum.Enum):
    OFFLINE = "offline"  # no live leader
    ONLINE = "online"  # leader is up
    LEADER_OFFLINE = "leader_offline"  # leader down, election needed
    ELECTION_LEADER_FOUND = "election_leader_found"


@dataclass
class ReplicaStatus:
    spu: int = 0
    hw: int = -1
    leo: int = -1


@dataclass
class PartitionStatus(Status):
    resolution: PartitionResolution = PartitionResolution.OFFLINE
    leader: ReplicaStatus = field(default_factory=ReplicaStatus)
    replicas: List[ReplicaStatus] = field(default_factory=list)
    lsr: int = 0  # live + in-sync replica count
    size: int = -1

    def is_online(self) -> bool:
        return self.resolution == PartitionResolution.ONLINE


PartitionSpec.STATUS = PartitionStatus


def partition_key(topic: str, index: int) -> str:
    return f"{topic}-{index}"


def parse_partition_key(key: str) -> tuple[str, int]:
    topic, _, index = key.rpartition("-")
    return topic, int(index)
