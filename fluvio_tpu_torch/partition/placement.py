"""Rule-driven partition -> device-group placement over a device fold.

The port's counterpart of ``fluvio_tpu/partition/placement.py``. A topic
scales by its partitions; each ``(topic, partition)`` is owned by one
*device group*. Declarative :class:`PlacementRule`\\ s (first regex match
over the ``topic/partition`` key wins) map partitions onto groups, and
:meth:`PlacementPlan.rebalance` reassigns a failed group's partitions onto
the survivors deterministically. The rules, the plan and every choice
they make are copies of the reference's.

In place of the reference's 2-axis JAX mesh, `make_partition_fold` lays
the torch devices out as rows (one per group, ``partitions``) of
``group_size`` devices (``records``), with the reference's folding rule: a
device-poor host keeps as many rows as it has devices, and logical groups
fold onto rows round-robin (`device_for_group`). Placement decisions are
made for ``n_groups`` whatever the fold, so a plan is portable unchanged
to a bigger pool.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from fluvio_tpu_torch.smartengine.engine import EngineError, resolve_device

PARTITION_AXIS = "partitions"
RECORD_AXIS = "records"

# rule grammar: "orders/.*=0;logs/[0-3]=spread;.*=hash"
_GROUP_WORDS = ("hash", "spread")


def partition_key(topic: str, partition: int) -> str:
    """The canonical rule-matching key: ``topic/partition``."""
    return f"{topic}/{partition}"


@dataclass(frozen=True)
class PlacementRule:
    """One declarative placement rule.

    ``pattern`` is a regex searched against the ``topic/partition`` key;
    ``group`` is either a concrete group index, ``"hash"`` (a stable digest
    of the key modulo the group count), or ``"spread"`` (least-loaded group
    at assignment time).
    """

    pattern: str
    group: object  # int | "hash" | "spread"

    def __post_init__(self):
        re.compile(self.pattern)  # fail loud at rule build, not at match
        if not isinstance(self.group, int) and self.group not in _GROUP_WORDS:
            raise ValueError(
                f"rule group must be an int or one of {_GROUP_WORDS}, "
                f"got {self.group!r}"
            )


DEFAULT_RULES: Tuple[PlacementRule, ...] = (PlacementRule(".*", "hash"),)


@dataclass(frozen=True)
class PartitionGateConfig:
    """The broker's partition gate (the reference's ``FLUVIO_PARTITIONS``
    and ``FLUVIO_PARTITION_RULES``): ``groups`` device groups (0: the gate
    is unarmed) placed by ``rules`` in `parse_placement_rules` syntax
    (None: `DEFAULT_RULES`)."""

    groups: int = 0
    rules: Optional[str] = None


def parse_placement_rules(spec: Optional[str]) -> Tuple[PlacementRule, ...]:
    """Parse the rule grammar ``"pat=group;pat=group"``; empty or None
    yields the default hash-everything rule. Malformed specs raise
    ``ValueError`` (a bad regex raises ``re.error``)."""
    if not spec or not spec.strip():
        return DEFAULT_RULES
    rules: List[PlacementRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"placement rule {part!r} is not pat=group")
        pat, _, grp = part.rpartition("=")
        grp = grp.strip()
        group: object = int(grp) if grp.lstrip("-").isdigit() else grp
        rules.append(PlacementRule(pat.strip(), group))
    return tuple(rules) if rules else DEFAULT_RULES


def validate_rules(rules: Sequence[PlacementRule], n_groups: int) -> None:
    """Reject rule sets that can only fail at match time: a pinned group
    index outside the groups is a deploy error and surfaces at plan
    construction, not on the first batch of some topic."""
    for rule in rules:
        if isinstance(rule.group, int) and not 0 <= rule.group < n_groups:
            raise ValueError(
                f"placement rule {rule.pattern!r} pins group {rule.group} "
                f"but the mesh has {n_groups} groups"
            )


def match_placement(
    rules: Sequence[PlacementRule],
    key: str,
    n_groups: int,
    loads: Optional[Dict[int, int]] = None,
) -> int:
    """Resolve one key against the rule list (first match wins).

    ``loads`` carries current per-group assignment counts for ``"spread"``
    resolution. No matching rule raises: an unplaced partition is a deploy
    error, not a silent default.
    """
    for rule in rules:
        if re.search(rule.pattern, key) is None:
            continue
        if isinstance(rule.group, int):
            if not 0 <= rule.group < n_groups:
                raise ValueError(
                    f"rule {rule.pattern!r} names group {rule.group} but the "
                    f"mesh has {n_groups} groups"
                )
            return rule.group
        if rule.group == "hash":
            # blake2s, not crc32: crc has no avalanche, so sequential
            # partition suffixes ("t/0".."t/3") would land on one group
            digest = hashlib.blake2s(key.encode(), digest_size=8).digest()
            return int.from_bytes(digest, "little") % n_groups
        # "spread": least-loaded group, lowest index breaking ties
        loads = loads or {}
        return min(range(n_groups), key=lambda g: (loads.get(g, 0), g))
    raise ValueError(f"no placement rule matched partition {key!r}")


@dataclass
class PlacementPlan:
    """An immutable-by-convention partition -> group assignment.

    Every change returns a NEW plan (the runtime swaps plans under its own
    lock); ``failed`` accumulates dead groups so a rebalanced plan never
    routes back onto them.
    """

    n_groups: int
    assignments: Dict[str, int] = field(default_factory=dict)
    rules: Tuple[PlacementRule, ...] = DEFAULT_RULES
    failed: frozenset = frozenset()
    rebalances: int = 0
    moves: int = 0

    def loads(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for g in self.assignments.values():
            out[g] = out.get(g, 0) + 1
        return out

    def live_groups(self) -> List[int]:
        return [g for g in range(self.n_groups) if g not in self.failed]

    def with_partitions(self, keys: Iterable[str]) -> "PlacementPlan":
        """Extend the plan with newly-seen partitions (idempotent)."""
        assignments = dict(self.assignments)
        loads = self.loads()
        live = set(self.live_groups())
        for key in keys:
            if key in assignments:
                continue
            g = match_placement(self.rules, key, self.n_groups, loads)
            if g not in live:
                # the rule targets a dead group: spread onto survivors
                g = min(live, key=lambda x: (loads.get(x, 0), x))
            assignments[key] = g
            loads[g] = loads.get(g, 0) + 1
        return replace(self, assignments=assignments)

    def move_partition(self, key: str, group: int) -> "PlacementPlan":
        """Voluntarily move ONE partition onto ``group``.

        Unlike :meth:`rebalance`, the vacated group stays schedulable
        (``failed`` is untouched). Moving onto a failed or out-of-range
        group is a caller bug and raises; a move onto the partition's own
        group returns this plan.
        """
        if key not in self.assignments:
            raise KeyError(f"partition {key!r} is not in the placement plan")
        if not 0 <= group < self.n_groups:
            raise ValueError(
                f"move target group {group} outside mesh of {self.n_groups}"
            )
        if group in self.failed:
            raise ValueError(f"move target group {group} has failed")
        if self.assignments[key] == group:
            return self  # already there: a no-op move is not a move
        assignments = dict(self.assignments)
        assignments[key] = group
        return replace(self, assignments=assignments, moves=self.moves + 1)

    def split_group(self, group: int, target: int) -> "PlacementPlan":
        """Move every second key of ``group`` (sorted order, so every
        control-plane replica computes the same split) onto ``target``.
        Both groups stay schedulable."""
        if group == target:
            raise ValueError("split target must differ from the source")
        keys = sorted(k for k, g in self.assignments.items() if g == group)
        plan = self
        for key in keys[1::2]:
            plan = plan.move_partition(key, target)
        return plan

    def merge_groups(self, src: int, dst: int) -> "PlacementPlan":
        """Fold every partition of ``src`` onto ``dst`` (voluntary: ``src``
        stays live, unlike :meth:`rebalance`'s failure path)."""
        if src == dst:
            raise ValueError("merge source must differ from destination")
        plan = self
        for key in sorted(k for k, g in self.assignments.items() if g == src):
            plan = plan.move_partition(key, dst)
        return plan

    def rebalance(self, failed_group: int) -> "PlacementPlan":
        """Reassign a failed group's partitions onto the survivors:
        orphaned keys move in sorted order onto the least-loaded surviving
        group (ties to the lowest index)."""
        failed = frozenset(self.failed | {failed_group})
        live = [g for g in range(self.n_groups) if g not in failed]
        if not live:
            raise ValueError("no surviving device groups to rebalance onto")
        assignments = dict(self.assignments)
        loads = {g: n for g, n in self.loads().items() if g not in failed}
        for key in sorted(k for k, g in self.assignments.items() if g == failed_group):
            target = min(live, key=lambda g: (loads.get(g, 0), g))
            assignments[key] = target
            loads[target] = loads.get(target, 0) + 1
        return replace(self, assignments=assignments, failed=failed,
                             rebalances=self.rebalances + 1)

    def rows(self) -> List[Tuple[str, int]]:
        """(key, group) rows in stable order."""
        return sorted(self.assignments.items())

    def to_dict(self) -> dict:
        return {
            "n_groups": self.n_groups,
            "assignments": dict(sorted(self.assignments.items())),
            "failed": sorted(self.failed),
            "rebalances": self.rebalances,
            "moves": self.moves,
        }


def plan_placement(
    rules: Sequence[PlacementRule],
    keys: Iterable[str],
    n_groups: int,
) -> PlacementPlan:
    """Build a plan by resolving every key against the rules."""
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    plan = PlacementPlan(n_groups=n_groups, rules=tuple(rules))
    return plan.with_partitions(keys)


def make_partition_fold(
    n_groups: int, group_size: Optional[int] = None, devices=None
) -> List[Tuple[torch.device, ...]]:
    """The ``(partitions, records)`` device fold for ``n_groups`` groups:
    ``min(n_groups, len(devices))`` rows of ``group_size`` devices (by
    default ``len(devices) // rows``), contiguous in ``devices`` order.
    ``devices=None`` takes every visible CUDA device and raises
    :class:`EngineError` when there is none: nothing drifts to the CPU."""
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    if devices is None:
        resolve_device(None)  # raises without CUDA
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if not devs:
        raise EngineError("a partition fold needs at least one device")
    rows = min(n_groups, len(devs))
    if group_size is None:
        group_size = max(1, len(devs) // rows)
    if rows * group_size > len(devs):
        raise ValueError(f"mesh wants {rows}x{group_size} devices, have {len(devs)}")
    return [tuple(devs[r * group_size:(r + 1) * group_size]) for r in range(rows)]


def fold_shape(fold) -> Dict[str, int]:
    """The fold's shape under the reference mesh's axis names."""
    return {PARTITION_AXIS: len(fold), RECORD_AXIS: len(fold[0])}


def device_for_group(fold, group: int) -> torch.device:
    """The group's lead device (its partitions' dispatch target); logical
    group g folds onto row ``g % len(rows)``."""
    return fold[group % len(fold)][0]
