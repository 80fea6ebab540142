"""Rack-aware round-robin partition scheduler.

Capability parity: fluvio-sc/src/controllers/scheduler/partition.rs — given
the online SPU set, place `partitions x replication_factor` replicas:
round-robin over SPUs with a rotating start (so partition i's leader is
spu[(i + offset) % n]), and when racks are present interleave SPUs from
distinct racks so a partition's replica set spans racks.

The port's copy of ``fluvio_tpu/sc/scheduler.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from fluvio_tpu_torch.metadata.spu import SpuSpec


class SchedulingError(Exception):
    pass


def rack_interleaved_order(spus: Sequence[SpuSpec]) -> List[int]:
    """SPU ids ordered so consecutive entries come from distinct racks.

    Parity: the reference's rack-aware list used by `generate_replica_map`
    — SPUs are grouped per rack (racks sorted, SPUs sorted within), then
    emitted column-by-column across racks.
    """
    by_rack: "OrderedDict[str, List[int]]" = OrderedDict()
    for spu in sorted(spus, key=lambda s: (s.rack or "", s.id)):
        by_rack.setdefault(spu.rack or "", []).append(spu.id)
    columns = max((len(v) for v in by_rack.values()), default=0)
    out: List[int] = []
    for col in range(columns):
        for rack_spus in by_rack.values():
            if col < len(rack_spus):
                out.append(rack_spus[col])
    return out


def generate_replica_map(
    spus: Sequence[SpuSpec],
    partitions: int,
    replication_factor: int,
    ignore_rack: bool = False,
    start_index: Optional[int] = None,
) -> Dict[int, List[int]]:
    """partition id -> ordered replica SPU ids (first = leader).

    Raises SchedulingError when there are fewer online SPUs than the
    replication factor (parity: NoResourceForReplicaMap resolution).
    """
    if partitions <= 0:
        raise SchedulingError("partition count must be > 0")
    if replication_factor <= 0:
        raise SchedulingError("replication factor must be > 0")
    if len(spus) < replication_factor:
        raise SchedulingError(
            f"need {replication_factor} SPUs for replication, have {len(spus)}"
        )
    use_rack = not ignore_rack and any(s.rack for s in spus)
    if use_rack:
        order = rack_interleaved_order(spus)
    else:
        order = [s.id for s in sorted(spus, key=lambda s: s.id)]
    n = len(order)
    # rotating start distributes leaders when topics are created repeatedly
    base = start_index if start_index is not None else 0
    replica_map: Dict[int, List[int]] = {}
    for p in range(partitions):
        start = (base + p) % n
        replica_map[p] = [order[(start + r) % n] for r in range(replication_factor)]
    return replica_map
