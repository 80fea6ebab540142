"""Partitioned-topic execution: partition -> device-group placement over a
device fold, per-partition carries and consumer offsets over one shared
chain executor, the lag-driven rebalancer and carry replication.

- `placement`  — rules, `PlacementPlan`, the device fold
- `runtime`    — `PartitionRuntime` (the carry bank), `PartitionOffsets`
- `rebalancer` — `PartitionRebalancer` (lag burn rates -> voluntary moves)
- `failover`   — `CarryReplica` (the follower's replicated carries)
"""

from fluvio_tpu_torch.partition.failover import CarryReplica
from fluvio_tpu_torch.partition.placement import (
    DEFAULT_RULES,
    PARTITION_AXIS,
    RECORD_AXIS,
    PlacementPlan,
    PlacementRule,
    device_for_group,
    make_partition_fold,
    match_placement,
    parse_placement_rules,
    partition_key,
    plan_placement,
    validate_rules,
)
from fluvio_tpu_torch.partition.rebalancer import (
    MOVE_REASONS,
    PartitionRebalancer,
    RebalanceConfig,
    partition_of,
)
from fluvio_tpu_torch.partition.runtime import (
    PartitionOffsets,
    PartitionRuntime,
    PartitionState,
)

__all__ = [
    "CarryReplica",
    "DEFAULT_RULES",
    "MOVE_REASONS",
    "PARTITION_AXIS",
    "PartitionOffsets",
    "PartitionRebalancer",
    "PartitionRuntime",
    "PartitionState",
    "PlacementPlan",
    "PlacementRule",
    "RECORD_AXIS",
    "RebalanceConfig",
    "device_for_group",
    "make_partition_fold",
    "match_placement",
    "parse_placement_rules",
    "partition_key",
    "partition_of",
    "plan_placement",
    "validate_rules",
]
