"""The SPU's consume path over the GPU chain: stored batches in, wire
batches out.

The port's counterpart of ``fluvio_tpu/spu/smart_chain.py`` (parity:
fluvio-spu/src/smartengine/): a chain is built from the wire invocations a
consumer sends (`build_chain`), and a read slice of stored batches runs
through it in two phases, so the stream loop (`stream_slices`, the core of
the reference's ``StreamFetchHandler._run_pipelined``) dispatches slice
k+1 before it finishes slice k:

1. `gpu_stage_dispatch`: decompress each batch, decode its records into
   columns natively (`native/records.cpp`, 4-aligned: the upload form),
   coalesce the slice with offsets rebased to the first batch's base and
   timestamps to its first timestamp, check the width and staging bounds,
   cut stateless chains into chunks of `_DISPATCH_CHUNK_ROWS` and
   dispatch every chunk before any is read;
2. `gpu_finish`: wait for each chunk, drop outputs below the consume
   cursor, cut at ``max_bytes`` (stateless chains) and encode the
   survivors natively into ONE batch spanning the consumed offset range.

A slice whose data the coalesced form cannot stage (mixed present and
absent base timestamps, a slab that disagrees with its header, a record
too wide for the chain, the staging cap, the engine's memory bound) is
declined, counted by reason, and served by `process_batches_per_record`,
which still runs every batch on the card. So is a slice whose finish
meets a transform error (``transform-error-spill``, as the reference
declines it): served batch by batch, it gives the reference's response,
the batches before, the failing batch's output before the failing record,
the error, and the next offset at the failing batch's end. So is a slice
whose dispatch or finish fails once the executor's retries are spent
(``fused-error``, the reference's decline): its chunks are discarded,
newest first, and each batch goes through ``chain.process``, whose
resilience ladder re-runs it on the card and quarantines a poison batch.
A `GpuSpill` and a fatal device error (a sticky CUDA error) propagate to
the caller: nothing reruns in an interpreter. A chain that is not one
card segment (a user Python SmartModule's host segment, or a DSL run cut
into several card segments) has no batched form: every slice goes through
`process_batches_per_record` (``chain.process`` a batch).

The SPU's stream handler gets its chains from `acquire_stream_chain`,
which caches stateless card chains, and feeds the chain's ``look_back``
hooks with `chain_look_back`. A topic whose config deduplicates gets a
persistent dedup chain on its leader (`dedup_to_invocation`,
`ensure_dedup_chain`). With the process's partition gate armed
(`fluvio_tpu_torch.partition.gate`), the handler passes its stream's
topic and partition, and each slice's dispatch and finish run in the
partition's scope (`_enter_partition_scope`).

The admission seam is the reference's (`admission_check`,
`admission_note_warm`, `admission_require_warm`, `admission_chain_sig`):
with the process's admission gate armed (`fluvio_tpu_torch.admission`),
`stream_slices` asks its ``admit`` callable before each read, and a shed
slice is yielded as a `SliceHold` for the caller to wait out (on its event
loop) before the generator asks again at the same offset. A shed comes
before `gpu_stage_dispatch`, so ``inflight_queue_depth`` does not move
for it.

A `PendingSlice` records its host phases in ``phase_ms`` (decompress,
decode, stage, dispatch) and the `BatchProcessResult` of its finish adds
``finish`` and ``encode``. The telemetry seams are the reference's: a
slice's staging books the ``stage`` and ``glz_decode`` (stored-batch
decompression) phases, its dispatched chunks the
``inflight_queue_depth`` gauge until its finish or discard, a declined
slice its reason on the ``declines`` family; `stream_slices` gives each
slice a `SliceFlow` (``flow_label``), which rides the slice's result to
the caller that serves it and ends it (`telemetry.TELEMETRY.end_flow`).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from fluvio_tpu_torch.native import records as native_records
from fluvio_tpu_torch.partition import gate as partition_gate
from fluvio_tpu_torch.protocol.compression import Compression, decompress
from fluvio_tpu_torch.protocol.error import ErrorCode
from fluvio_tpu_torch.protocol.record import Batch, RecordSet
from fluvio_tpu_torch.resilience.policy import is_fatal
from fluvio_tpu_torch.schema.smartmodule import (
    SmartModuleInvocation,
    SmartModuleInvocationWasm,
)
from fluvio_tpu_torch.smartengine.config import Lookback
from fluvio_tpu_torch.smartengine.engine import SmartEngine, SmartModuleChainInstance
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartengine.gpu.executor import GpuSpill, fetch_mat_pool
from fluvio_tpu_torch.smartmodule.types import (
    SmartModuleInput,
    SmartModuleRecord,
    SmartModuleTransformRuntimeError,
)
from fluvio_tpu_torch.telemetry import TELEMETRY
from fluvio_tpu_torch.types import NO_TIMESTAMP

logger = logging.getLogger(__name__)

# the device-side padded matrix (rows x width) a chunk may stage
_MAX_STAGING_BYTES = 1 << 29
# records a dispatch on the stateless path: a 16 MB read slice of short
# records becomes several chunks in flight at once
_DISPATCH_CHUNK_ROWS = 65536


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _slice_columns(cols: dict, lo: int, hi: int) -> dict:
    """Record range [lo, hi) of merged aligned-decode columns, as numpy
    views: val_flat/val_off keep the decoder's 4-aligned form (`from_flat`
    adopts them as they are), key_flat/key_off are exact-packed."""
    if lo == 0 and hi == cols["count"]:
        return cols
    v0, v1 = int(cols["val_off"][lo]), int(cols["val_off"][hi])
    k0, k1 = int(cols["key_off"][lo]), int(cols["key_off"][hi])
    return {
        "count": hi - lo,
        "val_flat": cols["val_flat"][v0:v1],
        "val_len": cols["val_len"][lo:hi],
        "val_off": cols["val_off"][lo : hi + 1] - v0,
        "key_flat": cols["key_flat"][k0:k1],
        "key_off": cols["key_off"][lo : hi + 1] - k0,
        "key_present": cols["key_present"][lo:hi],
        "off_delta": cols["off_delta"][lo:hi],
        "ts_delta": cols["ts_delta"][lo:hi],
    }


def _varint_sizes(x: np.ndarray) -> np.ndarray:
    """Exact zigzag-varint encoded sizes, vectorized."""
    xi = x.astype(np.int64)
    u = ((xi << 1) ^ (xi >> 63)).view(np.uint64)
    nb = np.ones(len(u), dtype=np.int64)
    for k in range(1, 10):
        nb += (u >= np.uint64(1 << (7 * k))).astype(np.int64)
    return nb


def _encoded_record_sizes_at(outbuf, drop: int, deltas: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Wire sizes (`Record.write_size`) of output rows [drop, drop +
    len(deltas))."""
    n = len(deltas)
    vlens = outbuf.lengths[drop : drop + n].astype(np.int64)
    klens_raw = outbuf.key_lengths[drop : drop + n].astype(np.int64)
    has_key = klens_raw >= 0
    klens = np.maximum(klens_raw, 0)
    inner = (
        1  # attributes
        + _varint_sizes(ts)
        + _varint_sizes(deltas)
        + 1  # key tag
        + np.where(has_key, _varint_sizes(klens) + klens, 0)
        + _varint_sizes(vlens)
        + vlens
        + 1  # varint(0) header count
    )
    return _varint_sizes(inner) + inner


class SmartModuleResolutionError(Exception):
    def __init__(self, code: ErrorCode, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def resolve_invocation(
    invocation: SmartModuleInvocation, smartmodules: Mapping[str, bytes]
) -> tuple:
    """(payload bytes, name) of an invocation: an AdHoc payload passes
    through, a Predefined name resolves against ``smartmodules`` (the
    local store's source by name; parity: context.rs:95)."""
    wasm = invocation.wasm
    if wasm.tag == SmartModuleInvocationWasm.ADHOC:
        return wasm.payload, invocation.name or "adhoc"
    payload = smartmodules.get(wasm.name)
    if payload is None:
        raise SmartModuleResolutionError(
            ErrorCode.SMARTMODULE_NOT_FOUND,
            f"SmartModule {wasm.name!r} not found in local store",
        )
    return payload, invocation.name or wasm.name


def dedup_to_invocation(topic_config: dict) -> Optional[SmartModuleInvocation]:
    """A topic's ``deduplication`` config as the filter invocation its
    leader runs (parity: fluvio-spu/src/smartengine/mod.rs:152
    `dedup_to_invocation`): the Predefined module that
    ``deduplication.filter.transform.uses`` names, its params the window
    bounds (``count``; ``age`` in milliseconds) then the transform's
    ``with`` params (which may override them), seeded from the log by a
    look-back of ``count`` records (and ``age``). None without one."""
    dedup = topic_config.get("deduplication")
    if not dedup:
        return None
    bounds = dedup.get("bounds") or {}
    transform = (dedup.get("filter") or {}).get("transform") or {}
    uses = transform.get("uses", "")
    count = int(bounds.get("count") or 0)
    age_seconds = bounds.get("age_seconds")
    params = {"count": str(count)}
    if age_seconds is not None:
        params["age"] = str(int(age_seconds) * 1000)
    params.update(transform.get("with_params") or {})
    inv = SmartModuleInvocation(
        wasm=SmartModuleInvocationWasm.predefined(uses),
        params=params,
        lookback_last=count,
        name=f"dedup/{uses}",
    )
    if age_seconds is not None:
        inv.lookback_age_ms = int(age_seconds) * 1000
    return inv


def build_chain(
    invocations: Sequence[SmartModuleInvocation],
    engine: SmartEngine,
    smartmodules: Optional[Mapping[str, bytes]] = None,
    version: Optional[int] = None,
) -> SmartModuleChainInstance:
    """Build and initialize a chain from wire invocations (parity:
    context.rs:63). A payload that does not load raises
    :class:`SmartModuleResolutionError` (``SMARTMODULE_INVALID``)."""
    builder = engine.builder()
    for invocation in invocations:
        payload, name = resolve_invocation(invocation, smartmodules or {})
        config = invocation.to_config()
        if version is not None:
            config.version = version
        try:
            builder.add_smart_module(config, payload, name=name)
        except Exception as e:  # noqa: BLE001 — the artifact's compile boundary
            raise SmartModuleResolutionError(
                ErrorCode.SMARTMODULE_INVALID, f"invalid SmartModule {name!r}: {e}"
            ) from e
    return builder.initialize()


_STREAM_CHAIN_CACHE_MAX = 32


def acquire_stream_chain(
    invocations: Sequence[SmartModuleInvocation], ctx, version: Optional[int] = None
) -> SmartModuleChainInstance:
    """`build_chain` on ``ctx.engine`` with the SPU's cache of stateless
    chains (parity: ``fluvio_tpu.spu.smart_chain.acquire_stream_chain``).

    ``ctx`` is the SPU's `GlobalContext` (its ``engine``, ``smartmodules``
    and ``stream_chains``). The key is the version and, for each module,
    its kind, the payload's sha256, the accumulator and the params. A chain is
    cached, and handed to every later stream with the same key, only when
    it is one card segment (no host hook, which may keep state), keeps no
    carries and asks for no look-back; any other chain is built fresh for
    each stream, so a look-back seeds a chain of its own
    (`chain_look_back`, which the stream handler runs)."""
    key_parts = [str(version)]
    cacheable = True
    look_back = any(inv.lookback() is not None for inv in invocations)
    for inv in invocations:
        if look_back:
            cacheable = False
            break
        payload = (
            inv.wasm.payload
            if inv.wasm.tag == SmartModuleInvocationWasm.ADHOC
            else ctx.smartmodules.get(inv.wasm.name)
        )
        if payload is None:  # an unresolved Predefined name: build_chain raises
            cacheable = False
            break
        key_parts.append(
            "%d:%s:%s:%r" % (
                int(inv.kind),
                hashlib.sha256(payload).hexdigest(),
                inv.accumulator.hex(),
                sorted((inv.params or {}).items()),
            )
        )
    key = "|".join(key_parts)
    if cacheable:
        chain = ctx.stream_chains.get(key)
        if chain is not None:
            ctx.stream_chains.move_to_end(key)
            return chain
    chain = build_chain(invocations, ctx.engine, ctx.smartmodules, version)
    gpu = chain.gpu_chain
    if cacheable and gpu is not None and not gpu.agg_configs:
        ctx.stream_chains[key] = chain
        while len(ctx.stream_chains) > _STREAM_CHAIN_CACHE_MAX:
            ctx.stream_chains.popitem(last=False)
    return chain


async def chain_look_back(chain: SmartModuleChainInstance, leader) -> None:
    """Feed a leader's recent stored records to the chain's ``look_back``
    hooks (parity: context.rs:117-240): each module's `Lookback`, the last
    ``last`` records below the HW, bounded by ``age_ms`` against the wall
    clock when set. The records go to the hooks as the reference hands
    them over: their offsets are their deltas in their stored batch, with
    no timestamp."""

    async def read_fn(lookback: Lookback) -> List[SmartModuleRecord]:
        if lookback.age_ms is not None:
            floor = int(time.time() * 1000) - lookback.age_ms
            records = leader.storage.read_last_records(lookback.last, min_timestamp=floor)
        else:
            records = leader.storage.read_last_records(lookback.last)
        return [SmartModuleRecord(rec) for rec in records]

    await chain.look_back(read_fn)


async def ensure_dedup_chain(ctx, leader) -> None:
    """Attach the topic's dedup filter chain to a leader replica, once
    (parity: ``Uninit<LeaderReplicaState>::init``, replica_state.rs:392-405):
    a replica whose topic config carries a deduplication gets a persistent
    chain, seeded once by a look-back from its log, that every produced
    record set runs through (`LeaderReplicaState.write_record_set`). The
    build and the seed run under the leader's write lock, so no produce
    appends between them; a failure (the module not yet pushed by the SC,
    an init or look-back hook that fails) raises, and the next produce
    tries again."""
    if leader.sm_chain is not None:
        return
    inv = dedup_to_invocation(ctx.replica_config(leader.topic, leader.partition))
    if inv is None:
        return
    async with leader._write_lock:
        if leader.sm_chain is not None:  # another produce attached it meanwhile
            return
        chain = await asyncio.to_thread(build_chain, [inv], ctx.engine, ctx.smartmodules)
        await chain_look_back(chain, leader)
        leader.sm_chain_metrics = ctx.metrics.smartmodule
        leader.sm_chain = chain


def apply_chain(chain, records: RecordSet, metrics=None):
    """Run an in-memory record set through a chain, one output batch per
    input batch (the produce-side transform, parity:
    produce_handler.rs:215). Returns (RecordSet, error)."""
    out = RecordSet()
    for batch in records.batches:
        inp = SmartModuleInput.from_records(
            batch.memory_records(),
            base_offset=0,  # offsets are not assigned until the log write
            base_timestamp=batch.header.first_timestamp,
        )
        output = chain.process(inp, metrics)
        if output.error is not None:
            return out, output.error
        if output.successes:
            out.add(
                Batch.from_records(
                    output.successes,
                    first_timestamp=(
                        batch.header.first_timestamp
                        if batch.header.first_timestamp != NO_TIMESTAMP
                        else None
                    ),
                )
            )
    return out, None


@dataclass
class BatchProcessResult:
    """Output of one pass over a read slice."""

    records: RecordSet = field(default_factory=RecordSet)
    next_offset: int = 0  # where the consumer continues
    error: Optional[SmartModuleTransformRuntimeError] = None
    phase_ms: Dict[str, float] = field(default_factory=dict)
    # the slice's flow record, for the caller that serves it to end
    # (None when `stream_slices` was given no flow label or capture is off)
    flow: Optional[object] = None


@dataclass
class PendingSlice:
    """A read slice staged and dispatched to the card, results pending.

    ``chunks`` holds (RecordBuffer, dispatch handle) pairs in slice order:
    stateless chains cut a large slice into several chunks, all in flight
    at once; stateful and explode chains stage one."""

    batches: List[Batch]
    chunks: List[tuple]
    planned_next: int  # the next offset when max_bytes cuts nothing
    total_raw: int
    base0: int
    ts0: int
    count: int  # input records across the chunks
    read_from: Optional[int] = None  # consume cursor: outputs below it drop
    phase_ms: Dict[str, float] = field(default_factory=dict)
    # chunks counted in the inflight_queue_depth gauge (released once, by
    # the finish or the discard)
    tracked_depth: int = 0
    flow: Optional[object] = None  # the slice's flow record

    def release_depth(self) -> None:
        if self.tracked_depth:
            TELEMETRY.gauge_add("inflight_queue_depth", -self.tracked_depth)
            self.tracked_depth = 0

    def discard(self, gpu) -> None:
        """Drop the dispatched chunks unread (newest first, so the carries
        end where the slice found them); the flow dies with them."""
        self.release_depth()
        for _, handle in reversed(self.chunks):
            gpu.discard_dispatch(handle)


def _decline(metrics, reason: str):
    if metrics is not None:
        metrics.add_fallback(reason)
    TELEMETRY.add_decline(reason)
    return None


# --- admission seam (fluvio_tpu_torch.admission) -----------------------------
# One source of truth: admission.gate() owns the resolve-once state, so
# admission.configure()/set_gate()/reset_gate() affect the broker seam
# immediately. Only the import is cached here; disarmed (the default) the
# per-slice cost is one resolved-flag check returning None.
_GATE_FN = None


def _admission_gate():
    global _GATE_FN
    if _GATE_FN is None:
        from fluvio_tpu_torch.admission import gate

        _GATE_FN = gate
    return _GATE_FN()


def _enter_partition_scope(topic, partition, gpu):
    """Enter the partition gate's scope for one slice's dispatches or its
    finish (`BrokerPartitionGate.scope`: the ``chain@topic/partition``
    identity, the group's device), or None: an unarmed gate (one
    global read), no partition given, no executor, or a placement
    that fails. A failure (a rule set that matches nothing for this
    topic) is logged and counted on its own typed decline,
    ``partition-placement-error``: a decline counter only, no per-batch
    fallback, since the slice still serves on the card, unpartitioned.
    The dispatch and the finish both come through here, and either can be
    the first to meet the bad rule."""
    pgate = partition_gate()
    if pgate is None or partition is None or gpu is None:
        return None
    scope = pgate.scope(topic or "t", partition, gpu)
    try:
        scope.__enter__()
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        logger.error("partition placement failed for %s/%s (%s: %s); serving unpartitioned",
                     topic, partition, type(e).__name__, e)
        TELEMETRY.add_decline("partition-placement-error")
        return None
    return scope


def admission_chain_sig(chain, topic=None, partition=None) -> str:
    """A served chain's admission identity: the executor's chain
    signature, and ``sig@topic/partition`` with a partition (its own
    token bucket and SLO-verdict family: a hot partition sheds without
    starving its siblings; the lag, flow and tenant families key on it
    too). Warm bookkeeping stays per chain: the controller strips the
    suffix for warm lookups."""
    gpu = chain.gpu_chain
    sig = gpu._chain_sig if gpu is not None else "chain"
    if partition is None:
        return sig
    return f"{sig}@{topic or 't'}/{partition}"


def admission_check(chain, topic=None, partition=None, tenant=""):
    """The broker front door: one admission decision for one read slice.

    Returns None when admitted (or admission is disarmed), else the typed
    ``Rejected`` decline. A health/credit shed means HOLD the slice — the
    stream handler waits ``retry_after_s`` and asks again, so offsets
    never advance past unserved records (no loss, no duplicates) and no
    exception ever reaches the client. A ``breaker-open`` rejection
    (none arises in the port, which has no breakers yet) is counted on
    the same decline surface, and the caller proceeds.

    A shed happens BEFORE `gpu_stage_dispatch`, so a shed slice never
    constructs a dispatched `PendingSlice`: the ``inflight_queue_depth``
    gauge does not move for it.

    ``tenant`` attributes real sheds (not breaker-open) to the per-tenant
    accounting plane. The attribution happens HERE, not inside the gate:
    `set_gate` installs duck-typed controllers whose ``admit(chain, cost,
    breaker)`` contract predates tenancy and must keep working."""
    ctl = _admission_gate()
    if ctl is None:
        return None
    decision = ctl.admit(
        admission_chain_sig(chain, topic, partition), breaker=getattr(chain, "breaker", None)
    )
    if decision:
        return None
    if tenant and decision.reason != "breaker-open":
        TELEMETRY.add_tenant_shed(tenant)
    return decision


def admission_note_warm(chain, buckets) -> None:
    """Register warmed width buckets with the live controller (the serve
    gate's cold-chain shed lifts once the chain's buckets are warm)."""
    ctl = _admission_gate()
    if ctl is not None:
        ctl.note_warm(admission_chain_sig(chain), buckets)


def admission_require_warm(chain) -> None:
    ctl = _admission_gate()
    if ctl is not None:
        ctl.require_warm(admission_chain_sig(chain))


@dataclass
class SliceHold:
    """`stream_slices`' answer for a slice the admission gate shed: no
    records were read; the caller waits ``retry_after_s`` and takes the
    next step, which asks again at the same offset."""

    decision: object  # the `Rejected` decline

    @property
    def retry_after_s(self) -> float:
        return self.decision.retry_after_s


def _begin_flow(flow_label):
    """A new slice's flow record under ``flow_label`` (key, tenant), or
    None. Its decision is ``admit`` until an admission check says
    otherwise."""
    if flow_label is None:
        return None
    flow = TELEMETRY.begin_flow(*flow_label)
    if flow is not None:
        flow.decision = "admit"
    return flow


def gpu_pipelinable(chain) -> bool:
    """Safe to dispatch ahead: stateless, row-preserving chains only (no
    carries to roll back when a speculative slice is discarded, no
    explode overflow re-runs)."""
    gpu = chain.gpu_chain
    return gpu is not None and not gpu.agg_configs and not gpu._fanout


def gpu_stage_dispatch(
    chain: SmartModuleChainInstance,
    batches: List[Batch],
    metrics=None,
    start_offset: Optional[int] = None,
    flow=None,
    topic: Optional[str] = None,
    partition: Optional[int] = None,
) -> Optional[PendingSlice]:
    """Phase 1 of the coalesced path (`tpu_stage_dispatch` in the
    reference): stage the slice through the native decoder into
    flat-backed chunk buffers and dispatch them all without blocking.
    With the partition gate armed and a ``partition`` given, the dispatch
    runs in the partition's scope (`_enter_partition_scope`).

    Returns None for a chain with no executor or an empty slice, and,
    counting the reason, when the slice's data declines (see the module
    docstring): the caller serves it with `process_batches_per_record`.
    A failed dispatch raises, after discarding the chunks before it.
    ``flow`` (the slice's `SliceFlow`) is marked dispatched and rides
    the pending slice."""
    gpu = chain.gpu_chain
    if gpu is None or not batches:
        return None
    phase = {"decompress": 0.0, "decode": 0.0}
    staged: List[tuple] = []
    total_raw = 0
    for batch in batches:
        raw = batch.raw_records
        if raw is None:
            return _decline(metrics, "no-raw-records")
        if batch.header.compression() != Compression.NONE:
            t0 = time.perf_counter()
            raw = decompress(batch.header.compression(), raw)
            phase["decompress"] += _ms(t0)
        t0 = time.perf_counter()
        cols = native_records.decode_record_columns(raw, align=4)
        phase["decode"] += _ms(t0)
        if cols["count"] != batch.records_len() or cols["parsed"] != len(raw):
            return _decline(metrics, "malformed-slab")
        staged.append((batch, cols))
        total_raw += len(raw)
    if total_raw > chain.engine.store_max_memory:
        return _decline(metrics, "store-memory")  # the per-batch path raises

    t_stage = time.perf_counter()
    base0 = staged[0][0].base_offset
    ts0 = staged[0][0].header.first_timestamp
    ts_list = [b.header.first_timestamp for b, _ in staged]
    if any(t < 0 for t in ts_list) and any(t >= 0 for t in ts_list):
        return _decline(metrics, "mixed-base-timestamps")  # no rebase defined
    merged = {
        "count": sum(c["count"] for _, c in staged),
        # every per-batch flat is 4-aligned, so the concat is too
        "val_flat": np.concatenate([c["val_flat"] for _, c in staged]),
        "val_len": np.concatenate([c["val_len"] for _, c in staged]),
        "key_flat": np.concatenate([c["key_flat"] for _, c in staged]),
        "key_present": np.concatenate([c["key_present"] for _, c in staged]),
    }
    off_parts, ts_parts, val_offs, key_offs = [], [], [], []
    v_base = k_base = 0
    for b, c in staged:
        off_parts.append(c["off_delta"] + (b.base_offset - base0))
        ts_parts.append(c["ts_delta"] + (b.header.first_timestamp - ts0 if ts0 >= 0 else 0))
        val_offs.append(c["val_off"][:-1] + v_base)
        key_offs.append(c["key_off"][:-1] + k_base)
        v_base += int(c["val_off"][-1])
        k_base += int(c["key_off"][-1])
    merged["off_delta"] = np.concatenate(off_parts)
    merged["ts_delta"] = np.concatenate(ts_parts)
    merged["val_off"] = np.concatenate(val_offs + [np.array([v_base], dtype=np.int64)])
    merged["key_off"] = np.concatenate(key_offs + [np.array([k_base], dtype=np.int64)])

    # stateless chains: chunks of equal size, every one in flight while
    # the first downloads; stateful and explode chains keep one dispatch
    n_total = merged["count"]
    chunk_rows = _DISPATCH_CHUNK_ROWS
    stateless = not gpu.agg_configs and not gpu._fanout
    if stateless and n_total > chunk_rows * 3 // 2:
        bounds = list(range(0, n_total, chunk_rows)) + [n_total]
        if bounds[-1] == bounds[-2]:
            bounds.pop()
    else:
        bounds = [0, n_total]  # an empty slice still stages one chunk
    # every guard runs before any dispatch: a decline never abandons a
    # chunk already on the card
    if n_total and int(merged["val_len"].max()) > gpu.max_stageable_width():
        return _decline(metrics, "record-too-wide")
    chunk_bufs: List[RecordBuffer] = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        try:
            buf = RecordBuffer.from_flat(
                _slice_columns(merged, lo, hi), base_offset=base0, base_timestamp=ts0
            )
        except ValueError:  # a value past the hard ceiling
            return _decline(metrics, "record-too-wide")
        if buf.rows * buf.width > _MAX_STAGING_BYTES:
            return _decline(metrics, "staging-cap")
        if gpu._fanout:
            # explode outputs are fresh records of their source record's
            # batch: they inherit that batch's rebase (one chunk)
            fo = np.zeros(buf.rows, dtype=np.int32)
            ft = np.zeros(buf.rows, dtype=np.int64)
            pos = 0
            for b, c in staged:
                n_b = c["count"]
                fo[pos : pos + n_b] = b.base_offset - base0
                if ts0 >= 0:
                    ft[pos : pos + n_b] = b.header.first_timestamp - ts0
                pos += n_b
            buf.fresh_offset_deltas = fo
            buf.fresh_timestamp_deltas = ft
        chunk_bufs.append(buf)
    phase["stage"] = _ms(t_stage)
    if TELEMETRY.enabled:
        # slice-level staging cost (native decode, column merge, chunk
        # builds), net of stored-batch decompression; the chunks' device
        # work books into their own spans
        TELEMETRY.add_phase("glz_decode", phase["decompress"] / 1e3)
        TELEMETRY.add_phase("stage", (phase["decode"] + phase["stage"]) / 1e3)
    t0 = time.perf_counter()
    pscope = _enter_partition_scope(topic, partition, gpu)
    try:
        chunks = gpu.dispatch_buffers(chunk_bufs)
    except (GpuSpill, KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        # the executor's retries are spent (it discarded the chunks before
        # the failed one): the per-batch path's ladder decides each batch
        if is_fatal(e):
            raise
        logger.warning("slice dispatch failed (%s: %s); served per batch", type(e).__name__, e)
        return _decline(metrics, "fused-error")
    finally:
        if pscope is not None:
            pscope.__exit__(None, None, None)
    phase["dispatch"] = _ms(t0)
    if flow is not None:
        # the trace joins batch spans against [dispatch, serve] of the flow
        flow.mark_dispatch()
    pending = PendingSlice(
        batches=batches,
        chunks=chunks,
        planned_next=staged[-1][0].computed_last_offset(),
        total_raw=total_raw,
        base0=base0,
        ts0=ts0,
        count=n_total,
        read_from=start_offset,
        phase_ms=phase,
        flow=flow,
    )
    if TELEMETRY.enabled:
        # pipelined occupancy: every dispatched chunk counts until its
        # slice's finish or discard retires it
        TELEMETRY.gauge_add("inflight_queue_depth", len(chunks))
        pending.tracked_depth = len(chunks)
    return pending


class _MergedOut:
    """Concatenated live rows of per-chunk output buffers, with the
    surface `gpu_finish` reads (count, the offset, timestamp and length
    columns, `to_columns`); the chunks meet only in the one encode."""

    def __init__(self, outbufs: List[RecordBuffer]):
        ns = [b.count for b in outbufs]
        self.count = sum(ns)
        self._outbufs = outbufs
        self.offset_deltas = np.concatenate([b.offset_deltas[:n] for b, n in zip(outbufs, ns)])
        self.timestamp_deltas = np.concatenate(
            [b.timestamp_deltas[:n] for b, n in zip(outbufs, ns)])
        self.lengths = np.concatenate([b.lengths[:n] for b, n in zip(outbufs, ns)])
        self.key_lengths = np.concatenate([b.key_lengths[:n] for b, n in zip(outbufs, ns)])

    def to_columns(self) -> dict:
        parts = [b.to_columns() for b in self._outbufs]
        val_off = np.zeros(self.count + 1, dtype=np.int64)
        key_off = np.zeros(self.count + 1, dtype=np.int64)
        pos = v = k = 0
        for c in parts:
            n = c["count"]
            val_off[pos : pos + n + 1] = c["val_off"] + v
            key_off[pos : pos + n + 1] = c["key_off"] + k
            pos += n
            v += int(c["val_off"][-1])
            k += int(c["key_off"][-1])
        return {
            "count": self.count,
            "val_flat": np.concatenate([c["val_flat"] for c in parts]),
            "val_off": val_off,
            "key_flat": np.concatenate([c["key_flat"] for c in parts]),
            "key_off": key_off,
            "key_present": np.concatenate([c["key_present"] for c in parts]),
            "off_delta": self.offset_deltas.astype(np.int64),
            "ts_delta": self.timestamp_deltas.astype(np.int64),
        }


def gpu_finish(
    chain: SmartModuleChainInstance,
    pending: PendingSlice,
    max_bytes: int,
    metrics=None,
    topic: Optional[str] = None,
    partition: Optional[int] = None,
) -> Optional[BatchProcessResult]:
    """Phase 2 (`tpu_finish` in the reference): wait for each chunk's
    results and encode the survivors into one wire batch.

    Survivors keep their stored offsets (rebased to the slice's first
    batch), so a consumer resuming mid-slice filters correctly; a
    stateless chain drops outputs below the consume cursor and keeps the
    longest prefix that fits ``max_bytes`` (at least one record).
    Aggregate chains deliver every output: their carries have moved on.
    The batch's ``last_offset_delta`` spans the consumed range, filtered
    records included. A slice of several chunks finishes each through
    `finish_buffer_deferred` and rebuilds it on `fetch_mat_pool()`;
    ``phase_ms["finish"]`` includes the wait for the last rebuild. A chunk
    that raises discards the chunks after it and leaves the carries where
    that chunk found them, once the rebuilds in flight have ended; then a
    `GpuSpill` or a fatal error propagates, and any other failure (the
    executor's retries spent) returns None, the decline counted as
    ``fused-error``. A chunk whose finish met a transform error discards
    the slice (the carries go back to where the slice found them) and
    returns None, the decline counted as ``transform-error-spill``. On a
    None the caller serves the slice per batch. With the partition gate
    armed and a ``partition`` given, the whole finish runs in the
    partition's scope, so its fetch-side families book per partition as
    the dispatch's do."""
    pscope = _enter_partition_scope(topic, partition, chain.gpu_chain)
    try:
        return _gpu_finish(chain, pending, max_bytes, metrics)
    finally:
        if pscope is not None:
            pscope.__exit__(None, None, None)


def _gpu_finish(chain: SmartModuleChainInstance, pending: PendingSlice, max_bytes: int,
                metrics) -> Optional[BatchProcessResult]:
    gpu = chain.gpu_chain
    base0, ts0 = pending.base0, pending.ts0
    result = BatchProcessResult(next_offset=pending.planned_next, phase_ms=dict(pending.phase_ms),
                                flow=pending.flow)
    # whatever the outcome below, the slice's chunks leave the queue now
    pending.release_depth()
    t0 = time.perf_counter()
    # each chunk's downloads and failures settle here, in order, and its
    # pure rebuild runs on the fetch worker: chunk k materializes while
    # chunk k+1's results download
    overlap = len(pending.chunks) > 1
    parts = []
    try:
        for b, h in pending.chunks:
            out = gpu.finish_buffer_deferred(b, h)
            if h.error is not None:
                break
            if callable(out):
                out = fetch_mat_pool().submit(out) if overlap else out()
            parts.append(out)
        outbufs = [p.result() if isinstance(p, Future) else p for p in parts]
    except BaseException as e:
        for p in parts:  # drain what is in flight before the error propagates
            if isinstance(p, Future):
                p.exception()
        for _, h in reversed(pending.chunks[len(parts):]):
            gpu.discard_dispatch(h)
        if isinstance(e, GpuSpill) or not isinstance(e, Exception) or is_fatal(e):
            raise
        logger.warning("slice finish failed (%s: %s); served per batch", type(e).__name__, e)
        return _decline(metrics, "fused-error")
    if len(parts) < len(pending.chunks):
        # a transform error: the reference discards the slice and serves it
        # batch by batch (its `transform-error-spill`); newest first, so the
        # carries end where the slice found them
        for p in parts:
            if isinstance(p, Future):
                p.exception()
        for _, h in reversed(pending.chunks):
            gpu.discard_dispatch(h)
        return _decline(metrics, "transform-error-spill")
    outbuf = outbufs[0] if len(outbufs) == 1 else _MergedOut(outbufs)
    n_out = outbuf.count
    out_deltas = outbuf.offset_deltas[:n_out].astype(np.int64)
    out_ts = outbuf.timestamp_deltas[:n_out].astype(np.int64)
    drop = 0
    stateless = not gpu.agg_configs and not gpu._fanout
    if stateless and n_out and pending.read_from is not None and pending.read_from > base0:
        # resuming mid-batch: outputs below the cursor were served by an
        # earlier (cut) response; survivor deltas ascend
        drop = int(np.searchsorted(out_deltas, pending.read_from - base0, side="left"))
        out_deltas = out_deltas[drop:]
        out_ts = out_ts[drop:]
        n_out -= drop
    if n_out and stateless and max_bytes > 0:
        sizes = _encoded_record_sizes_at(outbuf, drop, out_deltas, out_ts)
        keep = int(np.searchsorted(np.cumsum(sizes), max_bytes, side="left")) + 1
        if keep < n_out:
            n_out = max(keep, 1)
            result.next_offset = base0 + int(out_deltas[n_out - 1]) + 1
    result.phase_ms["finish"] = _ms(t0)
    t0 = time.perf_counter()
    if n_out:
        cols = outbuf.to_columns()
        vo, ko = cols["val_off"], cols["key_off"]
        v0, k0 = int(vo[drop]), int(ko[drop])
        raw_out = native_records.encode_record_columns(
            cols["val_flat"][v0 : int(vo[drop + n_out])],
            vo[drop : drop + n_out + 1] - v0,
            cols["key_flat"][k0 : int(ko[drop + n_out])],
            ko[drop : drop + n_out + 1] - k0,
            cols["key_present"][drop : drop + n_out],
            out_deltas[:n_out],
            out_ts[:n_out],
        )
        out_batch = Batch(base_offset=base0, raw_records=raw_out, raw_record_count=n_out)
        now = int(time.time() * 1000) if ts0 == NO_TIMESTAMP else ts0
        out_batch.header.first_timestamp = now
        out_batch.header.max_time_stamp = now
        # span the whole consumed range so the consumer's next fetch moves
        # past every input record, filtered ones included
        out_batch.header.last_offset_delta = result.next_offset - 1 - base0
        result.records.add(out_batch)
    result.phase_ms["encode"] = _ms(t0)
    if metrics is not None:
        metrics.add_bytes_in(pending.total_raw)
        metrics.add_fuel_used(pending.count * max(len(gpu.stages), 1))
        metrics.add_records_out(n_out)
        metrics.add_fastpath()
    if gpu.agg_configs:
        gpu._ensure_host_state()
    return result


def process_batches(
    chain: SmartModuleChainInstance,
    batches: List[Batch],
    max_bytes: int,
    metrics=None,
    start_offset: Optional[int] = None,
    topic: Optional[str] = None,
    partition: Optional[int] = None,
) -> BatchProcessResult:
    """Run stored batches through the chain and re-batch the outputs: the
    coalesced path when it takes the slice, else (a decline, a transform
    error in its finish, a chain with a host segment) one `chain.process`
    a batch (`process_batches_per_record`). ``topic`` / ``partition``
    place the coalesced path through the partition gate."""
    pending = gpu_stage_dispatch(chain, batches, metrics, start_offset, topic=topic,
                                 partition=partition)
    if pending is not None:
        result = gpu_finish(chain, pending, max_bytes, metrics, topic=topic,
                            partition=partition)
        if result is not None:
            return result
    return process_batches_per_record(chain, batches, max_bytes, metrics)


def process_batches_per_record(
    chain: SmartModuleChainInstance,
    batches: List[Batch],
    max_bytes: int,
    metrics=None,
) -> BatchProcessResult:
    """One `chain.process` a stored batch (parity: batch.rs:41-140), each
    output batch at its input batch's base offset, survivors keeping their
    stored offsets and the batch spanning the input's offset range; stops
    once ``max_bytes`` of output is reached or at an output's error."""
    result = BatchProcessResult()
    total_bytes = 0
    for batch in batches:
        inp = SmartModuleInput.from_records(
            batch.memory_records(),
            base_offset=batch.base_offset,
            base_timestamp=batch.header.first_timestamp,
        )
        output = chain.process(inp, metrics)
        result.next_offset = batch.computed_last_offset()
        if output.successes:
            out_batch = Batch.from_records(
                output.successes,
                base_offset=batch.base_offset,
                first_timestamp=(
                    batch.header.first_timestamp
                    if batch.header.first_timestamp != NO_TIMESTAMP
                    else None
                ),
                preserve_offsets=True,
            )
            # the next fetch offset comes from last_offset_delta: it covers
            # the records consumed from the log, not those produced
            out_batch.header.last_offset_delta = (
                batch.computed_last_offset() - 1 - batch.base_offset
            )
            total_bytes += out_batch.write_size()
            result.records.add(out_batch)
        if output.error is not None:
            result.error = output.error
            break
        if total_bytes >= max_bytes:
            break
    return result


def stream_slices(
    chain: SmartModuleChainInstance,
    read: Callable[[int], List[Batch]],
    start: int,
    end: int,
    max_bytes: int,
    metrics=None,
    flow_label: Optional[Tuple[str, str]] = None,
    admit: Optional[Callable[[object], object]] = None,
    topic: Optional[str] = None,
    partition: Optional[int] = None,
) -> Iterator[object]:
    """Serve offsets [start, end) slice by slice: the SPU's stream loop
    (the core of the reference's ``StreamFetchHandler._run`` and
    ``_run_pipelined``). ``read(offset)`` returns the stored batches of the
    slice that holds ``offset`` (none past the log's end); its time is the
    slice's ``read`` phase. For a pipelinable chain (`gpu_pipelinable`),
    slice k+1 is read, staged and dispatched before slice k is finished
    and encoded; when ``max_bytes`` cuts slice k, slice k+1 (read from the
    wrong offset) is discarded and read again. Other chains run one slice
    at a time (`process_batches`). An error, or closing the generator,
    discards what is in flight. With ``flow_label`` (``(key, tenant)``)
    each slice gets a `SliceFlow` when it arrives, carried on its result
    (``result.flow``) for the caller to end when it serves the slice; a
    discarded slice's flow is dropped.

    ``admit(flow)``, when given, is asked before each read with the
    slice's flow (None without a flow label): None admits, a `Rejected`
    decline holds the slice. A held slice is yielded as a `SliceHold` (no
    read, no dispatch: ``inflight_queue_depth`` does not move); the slice
    in flight, if any, is finished and yielded first, and the next step
    asks again at the same offset with the same flow. The caller waits
    the hold out between steps. Yields `BatchProcessResult` and
    `SliceHold`. ``topic`` / ``partition`` (the stream's) place every
    slice's dispatches and finish through the partition gate."""
    gpu = chain.gpu_chain
    current = start
    flow = None  # the next slice's flow, born at its arrival, kept across holds
    if not gpu_pipelinable(chain):
        while current < end:
            if flow is None:
                flow = _begin_flow(flow_label)
            if admit is not None:
                shed = admit(flow)
                if shed is not None:
                    yield SliceHold(shed)
                    continue
            t0 = time.perf_counter()
            batches = read(current)
            if not batches:
                return
            read_ms = _ms(t0)
            result = process_batches(chain, batches, max_bytes, metrics, current, topic=topic,
                                     partition=partition)
            result.phase_ms["read"] = read_ms
            result.flow, flow = flow, None
            yield result
            current = result.next_offset
        return
    pending: Optional[PendingSlice] = None
    nxt: Optional[PendingSlice] = None
    try:
        while True:
            planned = pending.planned_next if pending is not None else current
            shed = None
            nxt_batches: List[Batch] = []
            read_ms = 0.0
            read_flow = None
            if planned < end:
                if flow is None:
                    flow = _begin_flow(flow_label)
                if admit is not None:
                    shed = admit(flow)
                if shed is None:
                    read_flow, flow = flow, None
                    t0 = time.perf_counter()
                    nxt_batches = read(planned)
                    read_ms = _ms(t0)
            if nxt_batches:
                nxt = gpu_stage_dispatch(chain, nxt_batches, metrics, start_offset=planned,
                                         flow=read_flow, topic=topic, partition=partition)
                if nxt is not None:
                    nxt.phase_ms["read"] = read_ms
            if pending is not None:
                # gpu_finish consumes the slice's handles, or discards
                # those it leaves unread (a pipelinable chain has no
                # explode: its finish meets no transform error; a failure
                # past the executor's retries declines the slice, served
                # per batch while slice k+1 stays in flight)
                finished, pending = pending, None
                result = gpu_finish(chain, finished, max_bytes, metrics, topic=topic,
                                    partition=partition)
                if result is None:
                    result = process_batches_per_record(chain, finished.batches, max_bytes,
                                                        metrics)
                    result.phase_ms["read"] = finished.phase_ms.get("read", 0.0)
                    result.flow = finished.flow
                yield result
                current = result.next_offset
                if current != finished.planned_next:
                    # a max_bytes cut: slice k+1 was read from the wrong offset
                    if nxt is not None:
                        nxt.discard(gpu)
                        nxt = None
                    continue
            if shed is not None:
                # nothing in flight now: the caller waits the hold out
                yield SliceHold(shed)
                continue
            if nxt is not None:
                pending, nxt = nxt, None
            elif nxt_batches:
                # the coalesced path declined this slice: serve it per batch
                result = process_batches_per_record(chain, nxt_batches, max_bytes, metrics)
                result.phase_ms["read"] = read_ms
                result.flow = read_flow
                yield result
                current = result.next_offset
            else:
                return
    finally:
        for p in (nxt, pending):
            if p is not None:
                p.discard(gpu)
