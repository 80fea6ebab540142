"""Partitioned-topic execution: partition -> device-group placement over a
device fold, per-partition carries and consumer offsets over one shared
chain executor, the lag-driven rebalancer and carry replication.

- `placement`  — rules, `PlacementPlan`, the device fold
- `runtime`    — `PartitionRuntime` (the carry bank), `PartitionOffsets`
- `rebalancer` — `PartitionRebalancer` (lag burn rates -> voluntary moves)
- `failover`   — `CarryReplica` (the follower's replicated carries),
                 `FailoverCoordinator` (promotion replay, migration),
                 `chain_from_spec`

The broker's seam is `gate()`: the process's `BrokerPartitionGate`, or
None. `configure` builds it from a `PartitionGateConfig` at once (an
SPU's ``SpuConfig.partitions``; never from the environment), so an
unarmed gate costs the stream handler one global read a slice. A config
the gate cannot be built from (a rule pinning a group past ``groups``,
no device) is logged and leaves the gate unarmed. `set_gate` installs a
gate directly, or disarms it with None.
"""

import logging
from typing import Optional

from fluvio_tpu_torch.partition.failover import (
    CarryReplica,
    FailoverCoordinator,
    chain_from_spec,
)
from fluvio_tpu_torch.partition.placement import (
    DEFAULT_RULES,
    PARTITION_AXIS,
    RECORD_AXIS,
    PartitionGateConfig,
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
    BrokerPartitionGate,
    PartitionOffsets,
    PartitionRuntime,
    PartitionState,
)

logger = logging.getLogger(__name__)

_GATE: Optional[BrokerPartitionGate] = None


def configure(config: PartitionGateConfig, devices=None) -> Optional[BrokerPartitionGate]:
    """Build the process's gate from ``config`` now, its groups folding onto
    ``devices`` (None: the visible CUDA devices), and install it: None for
    ``groups`` 0, and None, logged, for a config the gate cannot be built
    from (a rule pinning a group past ``groups``, no device). Returns the
    installed gate."""
    set_gate(_build(config, devices))
    return _GATE


def gate() -> Optional[BrokerPartitionGate]:
    """The broker seam: the process's `BrokerPartitionGate`, or None when
    unarmed."""
    return _GATE


def _build(config: PartitionGateConfig, devices) -> Optional[BrokerPartitionGate]:
    if config.groups <= 0:
        return None
    try:
        built = BrokerPartitionGate(config.groups, parse_placement_rules(config.rules),
                                    devices=devices)
    except Exception as e:  # noqa: BLE001 — serving beats a crash: log, stay unarmed
        logger.error("partition gate unavailable (%s: %s); serving unpartitioned",
                     type(e).__name__, e)
        return None
    logger.warning("partition gate armed: %d device groups", config.groups)
    return built


def set_gate(g: Optional[BrokerPartitionGate]) -> None:
    """Install a gate object directly (None disarms)."""
    global _GATE
    _GATE = g


__all__ = [
    "BrokerPartitionGate",
    "CarryReplica",
    "DEFAULT_RULES",
    "FailoverCoordinator",
    "MOVE_REASONS",
    "PARTITION_AXIS",
    "PartitionGateConfig",
    "PartitionOffsets",
    "PartitionRebalancer",
    "PartitionRuntime",
    "PartitionState",
    "PlacementPlan",
    "PlacementRule",
    "RECORD_AXIS",
    "RebalanceConfig",
    "chain_from_spec",
    "configure",
    "device_for_group",
    "gate",
    "make_partition_fold",
    "match_placement",
    "parse_placement_rules",
    "partition_key",
    "partition_of",
    "plan_placement",
    "set_gate",
    "validate_rules",
]
