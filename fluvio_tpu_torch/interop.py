"""Carry state across from the JAX package to the port.

This system has no weights: what a run depends on is the compiled chain
state (DFA tables), the staged record columns, with the glz link on the
compressed token streams, the live carry of a windowed stream (its spec
and its state bank) and a partitioned topic's placement plan (each
partition's carries go across as the plain ints that
`PartitionRuntime.seed_partition` takes, and a follower's replicated
carry snapshot, `carry_state_from_reference`) and, for the cluster, the SC's
metadata objects (topics, partitions, SPUs, SmartModules). These
functions take them as plain values and numpy arrays — as the JAX package's `CompiledDfa`,
`RecordBuffer` and glz `Compressed` hold them — and build the port's
objects, so a test can run
the port on exactly the reference's tables, columns and streams and tell
a kernel fault from a fault in the port's copy of the compiler.
"""

from __future__ import annotations

import numpy as np

from fluvio_tpu_torch.metadata import SPEC_BY_KIND
from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa
from fluvio_tpu_torch.partition.placement import PlacementPlan, PlacementRule
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartengine.gpu.executor import GpuChainExecutor
from fluvio_tpu_torch.smartengine.gpu.glz import Compressed
from fluvio_tpu_torch.stream_model import MetadataStoreObject
from fluvio_tpu_torch.windows.spec import WindowSpec
from fluvio_tpu_torch.windows.state import WindowStateBank


def dfa_from_reference(table, byte_class, accept, start, eos_class, pad_class) -> CompiledDfa:
    """numpy DFA tables -> the port's `CompiledDfa` (copies)."""
    return CompiledDfa(
        table=np.array(table, dtype=np.int16),
        byte_class=np.array(byte_class, dtype=np.int16),
        eos_class=int(eos_class),
        pad_class=int(pad_class),
        accept=np.array(accept, dtype=bool),
        start=int(start),
    )


def buffer_from_reference(
    values, lengths, count, keys, key_lengths, offset_deltas, timestamp_deltas,
    base_offset, base_timestamp,
) -> RecordBuffer:
    """numpy record columns -> the port's `RecordBuffer` (copies)."""
    return RecordBuffer(
        values=np.array(values, dtype=np.uint8),
        lengths=np.array(lengths, dtype=np.int32),
        keys=np.array(keys, dtype=np.uint8),
        key_lengths=np.array(key_lengths, dtype=np.int32),
        offset_deltas=np.array(offset_deltas, dtype=np.int32),
        timestamp_deltas=np.array(timestamp_deltas, dtype=np.int64),
        count=int(count),
        base_offset=int(base_offset),
        base_timestamp=int(base_timestamp),
    )


def glz_from_reference(comp) -> Compressed:
    """A glz stream with numpy fields (the JAX package's `Compressed`)
    -> the port's `Compressed` (copies)."""
    return Compressed(
        lit_lens=np.array(comp.lit_lens, dtype=np.uint8),
        match_lens=np.array(comp.match_lens, dtype=np.uint8),
        srcs=np.array(comp.srcs, dtype=np.int32),
        lits=np.array(comp.lits, dtype=np.uint8),
        depth=int(comp.depth),
        out_len=int(comp.out_len),
        chunk_bytes=int(comp.chunk_bytes),
        chunk_seqs=None if comp.chunk_seqs is None else np.array(comp.chunk_seqs, dtype=np.int32),
    )


def window_spec_from_reference(
    window_ms, slide_ms, op, keyed, lateness_ms, capacity, emit_capacity, delta_only,
) -> WindowSpec:
    """The JAX package's `WindowSpec` fields, as plain values -> the
    port's `WindowSpec` (every field given, so nothing resolves to a
    default)."""
    return WindowSpec(
        window_ms=int(window_ms),
        slide_ms=int(slide_ms),
        op=str(op),
        keyed=bool(keyed),
        lateness_ms=int(lateness_ms),
        capacity=int(capacity),
        emit_capacity=int(emit_capacity),
        delta_only=bool(delta_only),
    )


def window_bank_from_reference(entries, watermark, spec: WindowSpec, device) -> WindowStateBank:
    """A JAX state bank's ``snapshot()`` ([(id, acc, count), ...] live
    entries and the watermark, plain ints) -> a port bank on ``device``
    that carries on from the same state."""
    bank = WindowStateBank(spec, device=device)
    bank.restore([tuple(int(x) for x in e) for e in entries], int(watermark))
    return bank


def placement_plan_from_reference(plan_dict, rules) -> PlacementPlan:
    """A JAX `PlacementPlan`'s ``to_dict()`` plus its rules as ``(pattern,
    group)`` pairs (``to_dict`` omits them) -> the port's plan, which makes
    the same choices from there on."""
    return PlacementPlan(
        n_groups=int(plan_dict["n_groups"]),
        assignments={str(k): int(g) for k, g in plan_dict["assignments"].items()},
        rules=tuple(PlacementRule(str(p), g if isinstance(g, str) else int(g)) for p, g in rules),
        failed=frozenset(int(g) for g in plan_dict["failed"]),
        rebalances=int(plan_dict["rebalances"]),
        moves=int(plan_dict["moves"]),
    )


def carries_from_reference(executor, carries):
    """A JAX chain executor's aggregate carries (``_ensure_host_state()``,
    then ``carries``: one (accumulator, window, has) triple per aggregate,
    plain values) -> the port's executor ``executor`` of the same chain,
    whose next batch continues from them. Returns the executor."""
    carries = [(int(acc), int(win), bool(has)) for acc, win, has in carries]
    if len(carries) != len(executor.agg_configs):
        raise ValueError(
            f"{len(carries)} carries for a chain of {len(executor.agg_configs)} aggregates"
        )
    executor.carries = carries
    executor._device_carries = None  # the host list is the state now
    return executor


def carry_state_from_reference(latest, chain):
    """A JAX `CarryReplica.latest(key)`, ``(committed, carries,
    inst_state)`` as plain values, -> the port's, for ``chain`` (the port's
    `SmartModuleChainInstance` of the same spec): the carries as
    ``(accumulator, window, has)`` ints, and the reference's per-instance
    ``(accumulator, window_start)`` state as the port's segment snapshot
    (`SmartModuleChainInstance._snapshot` form: a card segment's carries,
    its slice of ``carries`` in order; a host segment's accumulator, its
    instance's). Seeding a port `FailoverCoordinator`'s replica with it
    promotes from the JAX leader's last commit."""
    committed, carries, inst = latest
    if carries is None:
        return int(committed), None, None
    carries = [(int(acc), int(win), bool(has)) for acc, win, has in carries]
    if inst is None:
        return int(committed), carries, None
    snapshot, slot = [], 0
    for seg in chain.segments:
        if isinstance(seg, GpuChainExecutor):
            n = len(seg.agg_configs)
            snapshot.append((None, carries[slot: slot + n]))
            slot += n
        else:
            k = next(i for i, x in enumerate(chain.instances) if x is seg)
            snapshot.append(bytes(inst[k][0] or b""))
    if slot != len(carries):
        raise ValueError(f"{len(carries)} carries for a chain of {slot} card aggregates")
    return int(committed), carries, snapshot


def metadata_from_reference(objects) -> list:
    """The JAX package's metadata store objects as plain dicts (each its
    ``MetadataStoreObject.to_dict()``: key, kind, revision, spec, status)
    -> the port's `MetadataStoreObject`s, spec and status rebuilt as the
    port's dataclasses of that kind. Applied to the stores of an SC's
    `ScContext`, they make it hold what the JAX SC holds."""
    return [
        MetadataStoreObject.from_dict(SPEC_BY_KIND[data["kind"]], data) for data in objects
    ]
