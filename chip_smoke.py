"""Chip smoke run of the PyTorch/CUDA port (``fluvio_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; build the CUDA kernels from
   ``fluvio_tpu_torch/smartengine/gpu/csrc`` (one nvcc per source, in
   parallel) and report the build time;
2. kernels: each CUDA kernel against its plain torch version on the card,
   at the main path's shapes (1,048,576 records of the bench JSON corpus,
   width 64) and on an adversarial set, with exact equality (all outputs
   are integers or bytes); kernel, device, plain and library times. The two JSON
   span kernels first, every design their launchers pick: the adversarial
   sets at widths 64 and 100 (a thread a record, with and without 16-byte
   loads) and 1024 and 1000 (a warp a record), with the keys ``name``,
   ``n``, the empty key, a UTF-8 key and one holding a backslash, and at
   64-byte stripes; the main path's shapes; two late-key narrow batches
   (131,072 records of ~1 KB and of ~0.5 KB with ``name`` after a pad,
   one in eight without it); the striped check geometry (stated in the
   output) against the plain version; the fat bench shape and a late-key
   fat batch (``name`` after the 70 KiB body) against ``json_get_bytes``.
   Their times are per call (CUDA events around one call, as for every
   kernel), the device time and per call in a run of back-to-back calls.
   ``--json-only`` builds the kernels and runs only these checks and times.
   Then long keys: ``json-map(field=key)`` through ``SmartEngine(device=
   "cuda")`` against the interpreter for a 49,151-byte key (its needle past
   48 KB of shared memory) on the narrow and the striped paths, and a
   240,000-byte key (past a block's shared memory: the needle stays in
   global memory) on the striped path. Then the DFA scan: against its
   plain version on the JSON adversarial set and on rows at the edge
   lengths (-1, 0, 1, 15, 16, 17, W-1, W, W+5) at widths 1 to 64, 16-byte
   aligned and one byte off, for compiled DFAs of 8 to 257 states (packed
   and unpacked) and two hand-built tables whose PAD column changes
   acceptance (the kernel's tail walk); timed at (a) the 22-state bench
   regex over the extracted names (the row's own numbers), (b) flu[vV]io
   over the whole bench records and (c) the 257-state DFA, packed and
   unpacked, over 1,048,576 x 64 records of its alphabet, each with its
   bound (the log line adds the sector floor). ``--dfa-scan-only`` builds
   the kernels and runs only these. Every kernel row gives its device
   time: torch.profiler's records of every kernel of one call, summed;
3. headline chain: ``regex-filter(regex="fluvio")`` -> ``json-map(field=
   "name")`` over 4 batches of 1,048,576 records through
   ``SmartEngine(device="cuda")`` and ``process_stream``; one whole batch
   checked record by record against the DSL interpreter on the host;
4. json-regex-filter chain: ``key="name", regex="^(fluvio|kafka|pulsar)-
   [0-3]$"`` over 1,048,576 records; survivors checked against ``re`` over
   ``json_get_bytes`` on the host; all three kernels must have launched;
   then ``regex-filter("flu[vV]io")`` -> ``json-map(field="name")`` over
   1,048,576 records (a pattern that is no literal: the whole record goes
   through the DFA scan); survivors against ``re``, the DFA scan launched;
5. striped kernels: the column-split DFA composition kernel against its
   plain version at the fat bench shape (1,024 records of 71,709 bytes,
   10,240 stripe rows of 8,192 bytes) for the 22-state in-span classes and
   the ``flu[vV]io`` record-level classes (with the time of the torch class
   pass, ``stripes.stripe_classes``, that builds them), and on an
   adversarial set (the 257-state table, identity runs, ragged row and
   column counts, rows shorter than a segment, column counts that are no
   multiple of the segment, 8 states with a lane a segment, segment
   lengths of 32, 64 and past the row);
6. striped chains over 4 batches of 1,024 ``gen_fat_70k`` records each
   (bench configs ``7_fat70k``, ``10_regex_json_fat`` and
   ``regex-filter("flu[vV]io")`` -> ``json-map(field="name")``), one whole
   batch of each checked against ``re`` / ``json_get_bytes`` on the host;
7. glz kernels: the fused token-to-byte decode (the up link's kernel)
   against its plain version, the byte plan plus the resolve, and against
   the raw bytes, on the compressed flat of the headline batch (256 KiB
   chunks), on the striped fat batch's flat and on an adversarial set
   (zeros, a period-28 corpus, a mixed corpus with a random run, a depth-6
   stream, bare and padded token arrays, ragged last chunks, 16 and 64 KiB
   chunks), timed beside the old path (the torch byte plan and the resolve
   kernel); the resolve kernel, which keeps the Pallas kernel's (base,
   midx) contract but is off the main path, against its plain version on
   the same streams; the encode window match against its plain
   version on the headline chain's descriptor stream at chunks of 256 and
   512 KiB (with the kernels a call launches: at most two), on period-2
   and mixed streams of 300,000 groups at 128 to 262,144 groups a chunk (one
   tile, many, past the join's window) and on seven corpora at chunks of 4,
   16, 256 and 512 KiB, with every encoded stream decoded back on the host;
   all exact. The extract kernel's adversarial set holds random spans with
   overruns, negative starts and lengths past the width at widths 1 to
   1,000, on 16-byte aligned rows and not;
8. glz chains: the headline chain with ``LinkParams(compress=True,
   result_compress=True)`` over the same 4 batches as phase 3 (batch 0
   checked against the interpreter; records/s beside phase 3's, link
   bytes, down-link forms and the host compress time; the fused decode
   launched and the resolve not), and the
   ``regex-filter("flu[vV]io")`` -> ``json-map`` striped chain with the
   link on over 4 x 1,024 fat records, whose constant descriptors must
   come back as tokens;
9. the aggregate and array_map slice, each over 4 batches of 1,048,576
   records through ``SmartEngine(device="cuda")`` and ``process_stream``,
   every output value and offset against the DSL interpreter (running
   sums continued across batches, and the carries after the last batch):
   ``3_aggregate`` (``aggregate-field(field="n", combine="add")`` over the
   bench JSON corpus; the JSON span and extract kernels launched every
   batch), ``4_array_map`` (``array-map-json`` over ``gen_arrays``, ~6
   elements a record; the chain starts at the default capacity, so its
   first batches overflow and run again, which must happen) and
   ``filter_aggregate`` (``regex-filter("fluvio")`` -> ``aggregate-field``,
   bench config ``9_partitioned``'s chain on one partition); records/s,
   output rows/s, link bytes, re-dispatches and the learned capacity;
   then the device time and kernel launches of one call of each torch op
   of the two stages the chains ran (``parse_int``, the scans,
   ``json_array_bounds``, ``fanout_scatter``; torch.profiler, every
   kernel of the call) at the shapes the chains gave them.
   ``--slice-only`` builds the kernels and runs only this phase;
10. the windowed-state engine at ``bench.py``'s windowed settings (event
   time every 4 ms from 1,000,000): the delta arms of ``5_windowed``
   (tumbling 1,000 ms, 1,000,000 ``gen_ints`` records in batches of
   16,384), ``11_windowed_sliding`` (window 1,000, slide 250; 500,000
   records) and ``12_windowed_keyed`` (tumbling, keyed, emit 4,096;
   500,000 ``gen_keyed_ints`` records in batches of 8,192) through
   ``WindowedRuntime(spec).process_buffer``, the bank against the host
   reference after every batch and the materialized view's table at the
   end; ``5_windowed``'s classic arm, ``windowed-sum`` through
   ``SmartEngine(device="cuda")`` over its 1,000,000 records as one batch,
   every output value and key against the interpreter; warm records/s,
   the first batch's ms, d2h ms, H2D bytes a record, the delta-vs-full
   byte ratio, then the device time and launches of one update and of its
   torch ops. ``--windowed-only`` runs only this phase (no kernel build);
11. partitioned-topic execution at ``bench.py``'s ``9_partitioned``
   settings: ``regex-filter("fluvio")`` -> ``aggregate-field(field="n")``
   over 524,288 ``gen_json`` records split round-robin into 4 partitions
   of 131,072, placed ``.*=spread`` over 2 groups that both fold onto the
   card, through ``PartitionRuntime`` as ``bench._run_partitioned_config``
   drives it: a first pass, the lag rebalancer's move of partition 0,
   three measured passes with ``fail_group(0)`` before the second, the
   offsets advancing per batch; each partition's sum against its host
   truth times 4 and every output of the first pass against the running
   sums; records/s, pass ms, the first pass's s, link bytes a record and
   the plans; then runtime passes in turns with the same records through
   one executor's ``process_stream`` (no runtime; the swap's cost is the
   difference) and one runtime pass's device busy ms, every runtime pass
   checked again. ``--partitioned-only`` builds the kernels and runs only
   this phase;
12. byte mode's packed payload and its down link, and the striped
   aggregate and explode: (1) the D2H bytes a record of ``3_aggregate``,
   ``filter_aggregate`` (phase 9) and ``9_partitioned`` (phase 11), whose
   byte-mode outputs now cross as one packed payload and must be
   flat-backed, beside the parent's figures; (2) one batch of 1,048,576
   ``gen_json`` records through ``aggregate-field(field="n",
   combine="max")`` with ``LinkParams(result_compress=True)``, whose
   settled running max must ship as glz tokens (the encode window match
   launched), then ``3_aggregate`` likewise, logging the form it shipped,
   both against the interpreter; (3) ``regex-filter("flu[vV]io")`` ->
   ``aggregate-sum`` over 4 x 1,024 records of ~71.7 KB (a signed integer
   and a space, then ``gen_fat_70k``'s record with the name cycling over
   fluvio, kafka, fluVio, pulsar), striped, the running sums of every
   batch and the carries after the last against the interpreter, the DFA
   composition launched every batch; (4) ``regex-filter("flu[vV]io")`` ->
   ``array-map-lines`` over 4 x 1,024 log records of ~71.7 KB (~1,000
   lines of 40-100 bytes, runs of empty lines), striped, batch 0 row by
   row and every batch by count and bytes against the interpreter, the
   first batch overflowing the default capacity and running again;
   records/s, bytes/s, output rows/s and D2H. ``--striped-slice-only``
   builds the kernels and runs phase 9's two aggregate chains, phase 11
   and this phase;
13. the broker's consume path, ``bench.run_broker_e2e`` below its socket:
   1,048,576 ``gen_json`` records stored in 64 batches of 16,384 (offsets
   from 0, first timestamp 1,000,000, records encoded by the port's native
   encoder), read in slices of whole batches up to 16 MiB and served by
   ``smart_chain.stream_slices`` (slice k+1 staged and dispatched before
   slice k is finished and encoded): the bench's two AdHoc invocations
   (``regex-filter("fluvio")`` -> ``Upper(JsonGet("name"))``, encoded and
   decoded with the port's codec, built by ``smart_chain.build_chain``),
   then ``regex-filter("flu[vV]io")`` and ``3_aggregate``'s chain (one
   slice at a time) through the same slices. Every output batch of every
   pass is decoded with the port's codec (CRC checked) and held to the DSL
   interpreter over every stored record: base offset, last offset delta
   over the consumed range, offsets, timestamps, keys and values; no slice
   may decline. A warm pass, then consume passes in turns with
   ``process_stream`` over the same records (medians): records/s,
   ``vs_engine_only``, p50/p99 slice latency (read to encoded batch), the
   host ms a slice of each phase, the engine-only staging, link bytes a
   record, device busy. ``--broker-only`` builds the kernels and runs only
   this phase;
14. the SPU server, ``bench.run_broker_e2e`` whole: phase 13's log written
   through the port's ``SpuServer`` (its SmartEngine on the card; the
   leader's ``write_record_set``, one stored batch a record set) into log
   files under a temporary directory, then each of phase 13's three
   chains, sent as AdHoc invocations, consumed through ``Fluvio.connect``
   -> ``partition_consumer`` -> ``stream_batches`` with the bench's
   ``ConsumerConfig`` (``disable_continuous``, ``max_bytes`` 16 MiB) over a
   localhost socket: a warm pass, then passes in turns with phase 13's
   below-socket ``stream_slices`` and with ``process_stream`` over the same
   records, every pushed batch held to the DSL interpreter as in phase 13
   and no slice declined (the server's chain metrics): records/s over the
   socket, ``vs_engine_only``, ``vs_below_socket`` (the server, its
   storage reads and the ack wait: both sides run ``stream_slices``), the
   client's batch inter-arrival p50 and max (three slices a pass give too
   few gaps for a p99), the server's host ms a slice by phase (storage
   read to ack wait) and the kernels one socket pass launches.
   ``--server-only`` builds the kernels and runs only this phase;
15. the cluster path (the JAX package's ``boot_cluster``): a port
   ``ScServer`` and one port ``SpuServer`` on the card, registered through
   ``admin.register_custom_spu``, topics created through the admin API
   (topic names allow ``[a-zA-Z0-9.-]``): (a) phase 13's 1,048,576
   records produced through ``Fluvio.connect(sc).topic_producer``
   (``send_all``, ``flush``) into ``bench`` with the default
   ``ProducerConfig`` and the first 262,144 of them into ``bench-1m`` with
   1 MiB batches and requests, every returned offset 0..n-1 in order and each log read back
   equal to the values, then the SC's LRS offsets for ``bench-0``; (b) the
   north star's two modules pushed by name (namespace form), ``bench``
   consumed by name through SC routing with the bench's ``ConsumerConfig``,
   in turns with phase 14's direct-SPU consume (AdHoc), every pass held to
   the DSL interpreter; (c) the records produced into ``bench-flu`` through
   a produce-side ``flu[vV]io`` filter by name (the SPU's
   ``handle_produce`` on the card), the log equal to the ``re`` truth; (d)
   ``multi`` (2 partitions) produced keyed and consumed merged through
   ``consumer(PartitionSelectionStrategy.all)`` with ``3_aggregate``'s
   chain by name, each partition's outputs equal to its running sums in
   its order. It prints records/s of each produce and consume, the batches
   of each produce request and the launches of each arm.
   ``--cluster-only`` builds the kernels and runs only this phase;
16. replication (the JAX package's replicated ``boot_cluster``,
   ``tests/test_replication.py:186-200``): a port ``ScServer`` and three
   port ``SpuServer``s (ids 5000-5002, each SmartEngine on the card),
   ``repl`` created with ``TopicSpec.computed(1, 3)``; (a) phase 13's
   1,048,576 records produced through the SC-routed producer with
   ``ProducerConfig(isolation=READ_COMMITTED, timeout_ms=60_000)``, each
   request answered with the leader's HW over its records before the
   timeout, both followers at LEO = HW = n with the leader's bytes, the
   SC's LRS listing them (lsr 3); (b) the leader's ``SpuServer`` stopped,
   a follower elected by the SC and promoted on its storage; (c) a fresh
   ``Fluvio.connect(sc)`` consuming by name from the new leader the north
   star (in turns with the direct-SPU consume), ``flu[vV]io`` and
   ``3_aggregate``, each pass held to the DSL interpreter with 0 fallback
   slices; (d) the stopped SPU started again on its log directory, a
   follower of the new leader at its LEO and in the SC's LRS. It prints
   the produce records/s, the followers' lag, the failover time (stop to
   the first consumed batch), the consume records/s and the rejoin time.
   ``--replication-only`` builds the kernels and runs only this phase;
17. the durable, secure cluster: TLS on the SC's and the SPU's public
   endpoints, an RBAC policy, lz4 and snappy topics, an SC restart on its
   metadata directory, consumes through a fresh profile client
   (``--secure-cluster-only``);
18. the pipeline telemetry (``fluvio_tpu_torch.telemetry``): a port
   ``SpuServer`` on the card with its monitoring socket and a
   ``TelemetryConfig`` whose SLO no batch meets (``e2e_p99`` under 1 µs,
   1 s windows, a ``torch.profiler`` breach capture) serves phase 13's
   log to the port's client, the north star then ``3_aggregate``, each
   pass held to host truth, the ``memory`` mode read over the socket
   while batches are in flight; then ``5_windowed``'s first 8 batches and
   one ``9_partitioned`` pass. It checks that all seven modes answer,
   every fused span has a ``device`` phase, the served records are the
   consumer's, lag is 0 at the end, the card allocator's live bytes are
   at least the ledger's, the ledger drains, the one SLO capture holds
   CUDA kernel events, each native library loaded has one build event,
   that capture's own calls for one batch take under 200 µs, and that
   capture costs the headline chain's ``process_stream`` (4 x 1,048,576
   records, on and off in turns, best of 3, in a fresh process) at most
   2 % or 200 µs a batch, in one of up to 5 rounds as the JAX gate.
   ``--telemetry-only`` builds the kernels and runs only this phase.
19. admission (``fluvio_tpu_torch.admission``) on phase 13's log behind
   the port's ``SpuServer``: (a) the serve gate's warm-up (consumers of a
   fresh north star and ``3_aggregate`` held ``cold-chain`` while the
   chain warms, then served; no warm-up error, no build but the warms';
   each chain's first slice warmed against not warmed), (b) four tenants
   at once under a token bucket of 1 refilled 1 a second (``no-tokens``
   sheds, every tenant held, ``held_slices`` back at 0), (c) a
   ``record_age_p99`` target of 1 ms: ``breach-shed`` until the windows
   age out, then served, (d) ``AdmissionPipeline``'s batcher coalescing
   the four tenants' 16,384-record slices into warmed 65,536-row buckets
   (no ``cold-bucket``), each tenant's outputs split back. Every consumer
   and tenant is held to host truth. ``--admission-only`` builds the
   kernels and runs only this phase.
20. user Python SmartModules beside the card's segments (`phase_hooks`):
   (a) the first error on the card: ``array-map-json`` ->
   ``regex-filter("a1[0-9]")`` -> ``aggregate-count`` over 1,048,576
   ``gen_arrays`` records with ``{"no":1}`` planted at row 0, 786,431 or
   nowhere, then a clean batch (the count's carry); (b) that chain over
   the ``SpuServer`` socket, the error response against the truth; (c) a
   dedup topic (``dedup-filter``, count 10,000): 262,144 keyed records
   produced through the SC, the SPU restarted (look-back re-seed), 65,536
   more, the stored log against the filter's rule, then the north star;
   (d) a look-back stream (a DSL ``flu[vV]io`` filter with a ``look_back``
   hook, 1,000 records of phase 13's log); (e) a mixed chain (card filter,
   host hook map, card ``json-map``) over 1,048,576 records. Each arm is
   exact against a host truth computed without the port's engine.
   ``--hooks-only`` builds the kernels and runs only this phase.

Standard output ends with three lines: the card's name and power limit as
``nvidia-smi`` reports them, one JSON object describing every kernel, and
the result line ``{"ok": true, "device": {...}}``.

``--encode-extract-only`` builds the kernels and prints only the extract
and encode window match rows at the main path's shapes; ``--dfa-scan-only``
the DFA scan's checks and its row. Copied into a checkout of another
commit, the script times that commit's kernels (it imports the package
beside it and reads the kernel names from its sources).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa, compile_regex
from fluvio_tpu_torch.partition import (
    PartitionRebalancer,
    PartitionRuntime,
    RebalanceConfig,
    parse_placement_rules,
    partition_key,
    plan_placement,
)
from fluvio_tpu_torch.smartengine import LinkParams, SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels, stripes
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartengine.gpu.executor import _bucket_rows, desc_stream, pad_glz_tokens
from fluvio_tpu_torch.smartengine.gpu.native import CSRC, KERNELS, SIGNATURES
from fluvio_tpu_torch.smartmodule import dsl
from fluvio_tpu_torch.windows import (
    HostWindowReference,
    MaterializedView,
    WindowSpec,
    WindowedRuntime,
)
from fluvio_tpu_torch.windows import engine as window_engine
from fluvio_tpu_torch.windows import kernels as window_kernels

N = 1 << 20
HEADLINE_BATCHES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
JSON_REGEX = "^(fluvio|kafka|pulsar)-[0-3]$"
FAT_RECORDS = 1 << 10  # bench.py's fat configs: 1,048,576 records / divisor 1024
FAT_BATCHES = 4
FAT_PARAMS = stripes.StripeParams()  # the JAX package's default stripe geometry
# the striped JSON span check's geometry: the plain version walks kmax x s
# byte columns one torch step each, so it runs on shorter stripes
SPAN_CHECK = stripes.StripeParams(threshold=1024, width=256, overlap=64)
GLZ_LINK = LinkParams(compress=True, result_compress=True)  # 256 KiB chunks
HEADLINE = [("regex-filter", {"regex": "fluvio"}), ("json-map", {"field": "name"})]
# the JAX package's JSON corner cases (tests/test_tpu_kernels.py JSON_DOCS)
JSON_DOCS = [
    b'{"name":"fluvio"}', b'{"a":1,"name":"x"}', b'{"name": "spaced" }', b'{"name":42}',
    b'{"name":-3.5,"z":1}', b'{"name":true}', b'{"name":null}', b'{"name":{"inner":1}}',
    b'{"name":[1,2]}', b'{"other":"x"}', b"not json", b"",
    b'{"nested":{"name":"inner"},"name":"outer"}', b'{"val":"name","name":"real"}',
    b'{"namer":"no","name":"yes"}', b'{"outer":{"name":"inner"}}', b'{"name":""}',
    b'{"x":[{"name":"in-array"}],"name":"top"}', b'{"name":"unterminated',
    b'{"name":  12345  ,"q":2}', b'{ "padded" : 1, "name" : "v" }',
    b'{"name":"with \\"escape\\""}',
]


def log(msg: str) -> None:
    print(msg, flush=True)


def gen_json(n: int, seed: int):
    """The bench corpus (`bench.gen_json`): ~half the names contain "fluvio"."""
    return shared_cases().gen_json(n, seed)


def gen_arrays(n: int, seed: int):
    """The bench's JSON-array corpus (`bench.gen_arrays`): ~6 elements a record."""
    return shared_cases().gen_arrays(n, seed)


def adversarial(width: int):
    docs = list(JSON_DOCS) + [b'{"name":123\x0b,"m":1}', b'{"name":12 \x0c}', b"", b""]
    docs.append((b'{"name":"' + b"y" * width)[:width])  # exactly W, unterminated
    docs.append((b'{"name":' + b"7" * width)[:width])  # exactly W, raw to EOF
    docs.append((b'{"a":"' + b"q" * width)[: width - 2] + b'"}')  # exactly W, no key
    docs.append(b'{"name":"fluvio-1"}' + b" " * (width - 19))  # exactly W
    rng = np.random.default_rng(17)
    alphabet = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)
    for _ in range(256):
        docs.append(alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(0, width + 1)))].tobytes())
    for _ in range(256):
        docs.append(rng.integers(0, 256, size=int(rng.integers(0, width + 1))).astype(np.uint8).tobytes())
    return docs


def gen_fat_70k(n: int):
    """The bench's fat corpus (`bench.gen_fat_70k`): 71,709-byte records."""
    body = "x" * (70 * 1024)
    return [f'{{"name":"fluvio-{i & 7}","body":"{body}"}}'.encode() for i in range(n)]


def stage(docs, width: int, device):
    values = np.zeros((len(docs), width), dtype=np.uint8)
    lengths = np.zeros(len(docs), dtype=np.int32)
    for i, d in enumerate(docs):
        values[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    return torch.from_numpy(values).to(device), torch.from_numpy(lengths).to(device)


def time_ms(fn, reps: int = 15, warm: bool = True) -> float:
    """Median device time of one call (CUDA events), after a warm-up."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = max_abs_err(got, want)
    if err != 0 or not torch.equal(got, want):
        bad = (got != want).reshape(got.shape[0], -1).any(dim=1).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"{name}: kernel differs from its plain version at rows {bad}")
    return err


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, corpus: RecordBuffer):
    """Every kernel against its plain version on the card; times at the
    main path's shapes (``corpus``: the bench corpus, 1,048,576 x 64)."""
    width = corpus.width
    if width != 64:
        raise AssertionError(f"bench corpus bucketed to width {width}, expected 64")
    v = torch.from_numpy(corpus.values).to(dev)
    ln = torch.from_numpy(corpus.lengths).to(dev)

    # adversarial set first: corner cases exactly equal (the span kernel's
    # own adversarial checks are in phase_json_span)
    av, al = stage(adversarial(width), width, dev)
    st_a, vl_a = cuda_kernels.json_get_span(av, al, "name")
    require_equal("extract adversarial", cuda_kernels.extract_span(av, st_a, vl_a),
                  kernels.extract_span(av, st_a, vl_a))
    extract_adversarial(dev)
    dfa_scan_adversarial(dev, av, al)
    torch.cuda.synchronize()
    log(f"kernels: adversarial set equal (extract: the span kernel's spans and random spans with "
        f"overruns and negative starts at widths {EXTRACT_WIDTHS}, 16-byte aligned rows and not; "
        f"dfa_scan: see above)")

    rows = []
    # the JSON span of the name field (both chains' first kernel; its row
    # is phase_json_span's)
    st, vl = cuda_kernels.json_get_span(v, ln, "name")

    # 2. extract of the name field (json-regex-filter's byte-mode JsonGet),
    # and of the "n" field (the bytes 3_aggregate's ParseInt reads)
    rows.append(extract_row(v, st, vl))
    st_n, vl_n = cuda_kernels.json_get_span(v, ln, "n")
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], require_equal(
        "extract key n", cuda_kernels.extract_span(v, st_n, vl_n),
        kernels.extract_span(v, st_n, vl_n)))
    del st_n, vl_n

    # 3. DFA verdict: over the extracted names (the 22-state bench regex),
    # whole records, the 257-state DFA
    rows.append(dfa_scan_row(dev, corpus))
    torch.cuda.synchronize()
    for r in rows:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms a call, device {r['device_ms']} ms (plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
            f"{r['library_ms']}) at N={N} W={width}, exact")
    return rows


@functools.lru_cache(maxsize=None)
def shared_cases():
    """The case builders shared with the port's tests
    (``tests/test_torch_isolation.py``, free of jax): the bench corpora,
    and the DFA scan's patterns, widths, edge-length rows and the
    hand-built tables whose PAD column changes acceptance."""
    path = Path(__file__).resolve().parent / "tests" / "test_torch_isolation.py"
    spec = importlib.util.spec_from_file_location("shared_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def dfa_scan_adversarial(dev, av, al):
    """The DFA scan against its plain version: the JSON adversarial set at
    width 64, and the edge lengths at widths 1 to 64 on 16-byte aligned
    rows and on rows one byte off; for the compiled DFAs of every shape
    (the bench regex packed and unpacked, flu[vV]io, the 257-state DFA
    packed and unpacked) and the hand-built tables."""
    cases = shared_cases()
    dfas = [compile_regex(p, packed=k)
            for p, k in cases.DFA_SCAN_PATTERNS + ((JSON_REGEX, False),)]
    dfas += [CompiledDfa(**t) for t in cases.non_invariant_tables()]
    for d in dfas:
        require_equal(f"dfa_scan adversarial {d.pattern[:24]} S={d.n_states} C={d.n_classes}",
                      cuda_kernels.dfa_match(av, al, d), kernels.dfa_match(av, al, d))
    rng = np.random.default_rng(77)
    for width in cases.DFA_SCAN_WIDTHS:
        values, lengths = cases.dfa_scan_inputs(rng, width, per_length=64)
        v = torch.from_numpy(values).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        buf = torch.zeros(values.size + 1, dtype=torch.uint8, device=dev)
        buf[1:] = v.reshape(-1)
        for label, vv in (("aligned", v), ("offset", buf[1:].view(values.shape))):
            for d in dfas:
                require_equal(f"dfa_scan edge lengths W={width} {label} {d.pattern[:24]} "
                              f"S={d.n_states} C={d.n_classes}",
                              cuda_kernels.dfa_match(vv, ln, d), kernels.dfa_match(vv, ln, d))
    torch.cuda.synchronize()
    shapes = ", ".join(f"{d.pattern[:24]} ({d.n_states}x{d.n_classes})" for d in dfas)
    log(f"kernel dfa_scan: adversarial set equal (the JSON set at W=64; edge lengths -1, 0, 1, "
        f"15, 16, 17, W-1, W, W+5 at widths {cases.DFA_SCAN_WIDTHS}, aligned and one byte off; "
        f"{len(dfas)} DFAs: {shapes}; the last two fail the PAD check)")


def big_rows(n: int, width: int, seed: int = 257):
    """Records of the 257-state DFA's alphabet (abcxd) at lengths 0 to
    ``width``, a match a(a|b){6}c planted after byte min(length, 40) of
    every fourth record, as ``test_257_state_table`` builds them."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcxd", dtype=np.uint8)
    lengths = rng.integers(0, width + 1, size=n)
    values = alphabet[rng.integers(0, 5, size=(n, width))]
    rows = np.arange(0, n, 4)
    at = np.minimum(lengths[rows], 40)
    plant = np.concatenate([np.full((len(rows), 1), ord("a"), dtype=np.uint8),
                            alphabet[rng.integers(0, 2, size=(len(rows), 6))],
                            np.full((len(rows), 1), ord("c"), dtype=np.uint8)], axis=1)
    values[rows[:, None], at[:, None] + np.arange(8)] = plant
    lengths[rows] = at + 8
    values[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return values, lengths.astype(np.int32)


def dfa_scan_case(label: str, values, lengths, dfa):
    """The DFA scan on one shape against its plain version: exactness, a
    call, device time and launches a call, the plain version's time and
    the bound (live bytes, lengths and verdicts over the memory rate). The
    log line adds the sector floor (each record's live bytes in whole
    32-byte sectors), which the kernels line leaves out."""
    got = cuda_kernels.dfa_match(values, lengths, dfa)
    err = require_equal(f"dfa_scan {dfa.pattern[:24]} S={dfa.n_states}", got,
                        kernels.dfa_match(values, lengths, dfa))
    call = lambda: cuda_kernels.dfa_match(values, lengths, dfa)  # noqa: E731
    ms = time_ms(call)
    dev_ms, per_call = device_time(call, kernel_names("dfa_scan.cu"))
    plain_ms = time_ms(lambda: kernels.dfa_match(values, lengths, dfa), reps=3)
    n, width = values.shape
    walk = lengths.to(torch.int64).clamp(0, width)
    live = float(walk.sum().item())
    b_ms, b_by = bound(live + 4 * n + n, live + n)
    sectors = float(((walk + 31) // 32).sum().item()) * 32
    matches = int(got.sum().item())
    log(f"kernel dfa_scan {label}: {ms:.4f} ms a call, device {dev_ms} ms in "
        f"{per_call} launches a call (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by}, "
        f"sector floor {(sectors + 5 * n) / HBM_BYTES_PER_S * 1e3:.5f} ms, library: none) at "
        f"{n} x {width}, {dfa.n_states} states x {dfa.n_classes} classes, {matches} matches, "
        f"exact")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, launches_per_call=per_call,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, records=n,
                width=width, states=dfa.n_states, classes=dfa.n_classes, matches=matches)


def dfa_scan_row(dev, corpus: RecordBuffer):
    """The DFA scan's row at shape (a), the json-regex-filter's: the
    22-state bench regex over the extracted name fields of the bench corpus
    (1,048,576 x 64); beside it (b) flu[vV]io over the whole bench records
    (a regex-filter whose pattern is no literal) and (c) the 257-state DFA
    packed and unpacked over as many records of its alphabet."""
    v = torch.from_numpy(corpus.values).to(dev)
    ln = torch.from_numpy(corpus.lengths).to(dev)
    dfa = compile_regex(JSON_REGEX)
    if dfa.n_states != 22:
        raise AssertionError(f"bench regex compiled to {dfa.n_states} states, expected 22")
    st, vl = cuda_kernels.json_get_span(v, ln, "name")
    ex = cuda_kernels.extract_span(v, st, vl)
    names = dfa_scan_case("names", ex, vl, dfa)
    del st, ex, vl
    shapes = {"records_flu": dfa_scan_case("records_flu", v, ln, compile_regex("flu[vV]io"))}
    del v, ln
    bv, bl = big_rows(N, corpus.width)
    bv, bl = torch.from_numpy(bv).to(dev), torch.from_numpy(bl).to(dev)
    big = shared_cases().BIG_PATTERN
    for packed in (True, False):
        label = f"big_{'packed' if packed else 'unpacked'}"
        shapes[label] = dfa_scan_case(label, bv, bl, compile_regex(big, packed=packed))
    del bv, bl
    return dict(name="dfa_scan", route="cuda",
                source="fluvio_tpu_torch/smartengine/gpu/csrc/dfa_scan.cu",
                replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:651", **names, **shapes)


def extract_row(v, st, vl):
    """The extract kernel at the main path's shape (the name field's spans
    of the bench corpus) against its plain version; times a call, device,
    plain and the library's gather + where."""
    n, width = v.shape
    ex = cuda_kernels.extract_span(v, st, vl)
    err = require_equal("extract", ex, kernels.extract_span(v, st, vl))
    call = lambda: cuda_kernels.extract_span(v, st, vl)  # noqa: E731
    ms, dev_ms = time_ms(call), device_ms(call, kernel_names("extract.cu"))
    plain_ms = time_ms(lambda: kernels.extract_span(v, st, vl), reps=5)
    j = torch.arange(width, device=v.device, dtype=torch.int64)[None, :]
    idx = (st.to(torch.int64)[:, None] + j).clamp(0, width - 1)
    keep = j < vl.to(torch.int64)[:, None]
    library_ms = time_ms(lambda: torch.where(keep, torch.gather(v, 1, idx), 0))
    bytes_moved = float(vl.to(torch.int64).clamp(0, width).sum().item()) + 8 * n + n * width
    b_ms, b_by = bound(bytes_moved, float(n * width))
    return dict(name="extract", route="cuda",
                source="fluvio_tpu_torch/smartengine/gpu/csrc/extract.cu",
                replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:261",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, device_ms=dev_ms, shape=f"{n} x {width}")


EXTRACT_WIDTHS = (1, 3, 15, 16, 17, 63, 64, 65, 100, 1000)


def extract_spans(rng, n: int, width: int):
    """Random rows and spans: in-row spans (what a span kernel emits),
    spans that overrun the row, negative starts, lengths past the width and
    negative lengths."""
    values = rng.integers(0, 256, size=(n, width)).astype(np.uint8)
    start = rng.integers(0, width + 1, size=n)
    vlen = (rng.random(n) * (width - start + 1)).astype(np.int64)
    kind = rng.integers(0, 5, size=n)
    start = np.where(kind == 1, rng.integers(0, 2 * width + 2, size=n), start)  # overrun
    vlen = np.where(kind == 1, rng.integers(0, 2 * width + 2, size=n), vlen)
    start = np.where(kind == 2, -rng.integers(1, 2 * width + 2, size=n), start)  # start < 0
    vlen = np.where(kind == 3, rng.integers(width, 3 * width + 2, size=n), vlen)  # past W
    vlen = np.where(kind == 4, -rng.integers(0, 3, size=n), vlen)  # negative: nothing
    return values, start.astype(np.int32), vlen.astype(np.int32)


def extract_adversarial(dev):
    """The extract kernel against its plain version on random spans at
    widths 1 to 1,000, on 16-byte aligned rows and (the same bytes one
    byte into a buffer) on rows that are not."""
    rng = np.random.default_rng(31)
    for width in EXTRACT_WIDTHS:
        values, start, vlen = extract_spans(rng, 4096, width)
        st, vl = torch.from_numpy(start).to(dev), torch.from_numpy(vlen).to(dev)
        v = torch.from_numpy(values).to(dev)
        buf = torch.zeros(values.size + 1, dtype=torch.uint8, device=dev)
        buf[1:] = v.reshape(-1)
        for label, vv in (("aligned", v), ("offset", buf[1:].view(values.shape))):
            require_equal(f"extract adversarial W={width} {label}",
                          cuda_kernels.extract_span(vv, st, vl), kernels.extract_span(vv, st, vl))


def stage_striped(docs, params: stripes.StripeParams, dev):
    """The executor's striped staging of one batch: (buffer, plan, stripe
    bytes, record lengths on the card, kmax)."""
    buf = RecordBuffer.from_values(docs)
    flat, _ = buf.ragged_values()
    flat_t = torch.from_numpy(np.ascontiguousarray(flat).view(np.int32)).to(dev)
    lengths = torch.from_numpy(buf.lengths).to(dev)
    srows = _bucket_rows(max(stripes.plan_rows(buf.lengths, buf.count, params.width,
                                               params.overlap), 8))
    plan, sv, kmax = stripes.stage_rows(flat_t, lengths, buf.lengths, buf.count, params, srows)
    return buf, plan, sv, lengths, kmax


def compose_row(name, cls, dfa, reps_plain: int = 2):
    """dfa_compose kernel vs plain on one class matrix: (err, ms, plain_ms,
    bound_ms, bound_by, device_ms). The bound counts the class matrix read once, the
    table and the output, and one lookup per state per non-identity
    column."""
    table_t = stripes._dfa_device(dfa, cls.device)[1]
    got = cuda_kernels.dfa_compose_columns(cls, table_t)
    err = require_equal(f"dfa_compose {name}", got, kernels.dfa_compose_columns(cls, table_t))
    call = lambda: cuda_kernels.dfa_compose_columns(cls, table_t)  # noqa: E731
    ms, dev_ms = time_ms(call), device_ms(call, kernel_names("dfa_compose.cu"))
    plain_ms = time_ms(lambda: kernels.dfa_compose_columns(cls, table_t), reps=reps_plain,
                       warm=False)
    live = float((cls >= 0).sum().item())
    bytes_moved = cls.numel() * 4.0 + table_t.numel() * 4.0 + got.numel() * 4.0
    b_ms, b_by = bound(bytes_moved, live * dfa.n_states)
    log(f"kernel dfa_compose {name}: {ms:.4f} ms a call, device {dev_ms} ms (plain "
        f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}) at rows={cls.shape[0]} "
        f"T={cls.shape[1]} S={dfa.n_states} C={dfa.n_classes}, {live:.0f} non-identity columns, "
        f"exact")
    return err, ms, plain_ms, b_ms, b_by, dev_ms


def span_docs(rng):
    """JSON records of 1-3 KB for the reduced-geometry span check: the
    field early, late, straddling stripe joints, missing (a walk of the
    whole record), unterminated and raw to the record's end."""
    docs = []
    for i in range(384):
        pad = b"p" * int(rng.integers(900, 3000))
        where = i % 4
        if where == 0:
            docs.append(b'{"name":"fluvio-%d","pad":"%s"}' % (i & 7, pad))
        elif where == 1:
            docs.append(b'{"pad":"%s","name":"kafka-%d","n":%d}' % (pad, i & 3, i))
        elif where == 2:
            docs.append(b'{"pad":"%s","n":%d}' % (pad, i))
        else:
            docs.append(b'{"pad":"%s","name":%s' % (pad, b"7" * int(rng.integers(1, 400))))
    for m in range(0, 1200, 7):  # key, colon and value across the 192-byte step
        doc = JSON_DOCS[m % len(JSON_DOCS)]
        body = doc[1:] if doc.startswith(b"{") else b'"x":"' + doc + b'"}'
        docs.append(b'{"pad":"' + b"q" * (m + 900) + b'",' + body)
    return docs


WIDE_RECORDS = 1 << 17  # the late-key wide narrow batches
# adversarial keys: the bench key, a short one, the empty key, a UTF-8 one
# and one holding a backslash (which the machine never matches)
SPAN_KEYS = ("name", "n", "", "n\u00e4m\u00e9", "na\\me")
SMALL_STRIPES = stripes.StripeParams(threshold=64, width=64, overlap=16)


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def kernel_names(source: str, *only: str):
    """The ``__global__`` functions of a CUDA source (a file name under the
    imported package's ``csrc/``; ``only``: those whose name holds one of
    these words)."""
    names = _GLOBAL.findall((CSRC / source).read_text(encoding="utf-8"))
    return tuple(n for n in names if not only or any(w in n for w in only))


def device_time(fn, names, reps: int = 20, by_kernel=None):
    """(ms, launches) of one ``fn()`` call: the device time of every kernel
    named in ``names`` (None: every kernel and copy) that the call runs,
    summed, and how many it launches,
    from torch.profiler's kernel records over ``reps`` calls (the wrapper's
    host time excluded); (None, None) where the profiler records none. The
    profiler drops a record now and then, so each kernel counts its mean
    duration times its launches a call (its records over ``reps``,
    rounded). ``by_kernel``, a dict, receives each kernel's ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device events at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = {}
        for ev in prof.key_averages():
            name = ev.key if names is None else next((n for n in names if n in ev.key), None)
            if ev.device_type != DeviceType.CUDA or name is None or not ev.count:
                continue
            us = (getattr(ev, "self_device_time_total", None)
                  or getattr(ev, "self_cuda_time_total", 0))
            us0, count0 = found.get(name, (0.0, 0))
            found[name] = (us0 + us, count0 + ev.count)
        if found and sum(us for us, _ in found.values()) > 0:
            ms, launches = 0.0, 0
            for name, (us, count) in found.items():
                per_call = max(1, round(count / reps))
                ms += us / count * per_call / 1e3
                launches += per_call
                if by_kernel is not None:
                    by_kernel[name] = us / count * per_call / 1e3
            return ms, launches
    log(f"device_time: three profiles recorded no kernel of {names}")
    return None, None


def device_ms(fn, names, reps: int = 20):
    return device_time(fn, names, reps)[0]


def run_ms(fn, reps: int = 50) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def span_bound(st: torch.Tensor, vl: torch.Tensor, lengths: torch.Tensor, side_bytes: float):
    """The bytes a span kernel must read: each record up to one byte past
    its field's end, the whole record where the field is missing (start 0),
    plus ``side_bytes`` of other inputs and outputs."""
    lens = lengths[: st.shape[0]].to(torch.int64)
    scanned = torch.where(st > 0, torch.minimum(lens, (st + vl + 1).to(torch.int64)), lens)
    total = float(scanned.sum().item())
    return bound(total + side_bytes, total)


def late_key_docs(n: int, pad: int):
    """Narrow records with "name" after a ``pad``-byte string (give or take
    15 bytes); one in eight has no name field, a walk of the whole record."""
    docs = []
    for i in range(n):
        p = b"p" * (pad + (i * 7) % 16)
        if i % 8 == 7:
            docs.append(b'{"pad":"%s","n":%d}' % (p, i))
        else:
            docs.append(b'{"pad":"%s","name":"fluvio-%d","n":%d}' % (p, i & 1023, i))
    return docs


def gen_fat_late(n: int):
    """The fat corpus with the name field after the 70 KiB body."""
    body = "x" * (70 * 1024)
    return [f'{{"body":"{body}","name":"fluvio-{i & 7}"}}'.encode() for i in range(n)]


def striped_adversarial(rng):
    """Records for the small-stripe check: JSON_DOCS behind pads of every
    length around the 48-byte step, odd keys, JSON-alphabet garbage and raw
    bytes (quotes and backslashes outside strings) of 40-400 bytes."""
    docs = []
    for m in range(0, 100, 3):
        doc = JSON_DOCS[m % len(JSON_DOCS)]
        body = doc[1:] if doc.startswith(b"{") else b'"x":"' + doc + b'"}'
        docs.append(b'{"pad":"' + b"p" * m + b'",' + (body if body != b"}" else b'"z":1}'))
        docs.append(b'{"pad":"' + b"p" * m + '","n\u00e4m\u00e9":"u","na\\me":1,"":2}'.encode())
    alphabet = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)
    for _ in range(64):
        docs.append(alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(40, 401)))]
                    .tobytes())
        docs.append(rng.integers(0, 256, size=int(rng.integers(40, 401))).astype(np.uint8).tobytes())
    return docs


def narrow_span_case(name: str, docs, width: int, keys, dev) -> int:
    """The narrow span kernel against its plain version on ``docs`` staged
    at ``width`` (the launcher picks the design from the width)."""
    v, ln = stage(docs, width, dev)
    err = 0
    for key in keys:
        got = torch.stack(cuda_kernels.json_get_span(v, ln, key))
        err = max(err, require_equal(f"json_span {name} W={width} key={key!r}", got,
                                     torch.stack(kernels.json_get_span(v, ln, key))))
    return err


def striped_span_case(name: str, docs, params: stripes.StripeParams, keys, dev) -> int:
    _, plan, sv, ln, kmax = stage_striped(docs, params, dev)
    args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], ln)
    err = 0
    for key in keys:
        got = torch.stack(cuda_kernels.striped_json_span(*args, key, kmax, params.step))
        want = torch.stack(kernels.striped_json_span(*args, key, kmax, params.step))
        err = max(err, require_equal(f"json_span_striped {name} key={key!r}", got, want))
    return err


def phase_json_span(dev, corpus: RecordBuffer):
    """Both JSON span kernels against their plain versions (or the host's
    ``json_get_bytes``), every design the launchers pick: the adversarial
    sets at widths of both narrow designs (16-byte aligned and not) and at
    small stripes; the main path's shapes; the late-key shapes. Each time
    is given per call (CUDA events around one call, as earlier rows) and as
    the kernel's device time (torch.profiler). Returns the two rows."""
    rng = np.random.default_rng(29)
    narrow_names = kernel_names("json_span.cu", "json_span_kernel", "warp")
    striped_names = kernel_names("json_span.cu", "striped")
    err = 0
    # narrow adversarial: thread-a-record widths 64 and 100 (no 16-byte
    # loads), warp-a-record widths 1024 and 1000, late and missing keys
    for width in (64, 100, 1024, 1000):
        docs = adversarial(width)
        if width > 512:
            docs += late_key_docs(96, width - 60)
        err = max(err, narrow_span_case("adversarial", docs, width, SPAN_KEYS, dev))
    striped_err = striped_span_case("adversarial", striped_adversarial(rng), SMALL_STRIPES,
                                    SPAN_KEYS, dev)
    torch.cuda.synchronize()
    log(f"json_span: adversarial sets equal at widths 64, 100 (a thread a record) and 1024, 1000 "
        f"(a warp a record); json_span_striped at {SMALL_STRIPES.width}/{SMALL_STRIPES.overlap} "
        f"stripes; keys {SPAN_KEYS}")

    # narrow, main path: the bench corpus, 1,048,576 x 64
    v = torch.from_numpy(corpus.values).to(dev)
    ln = torch.from_numpy(corpus.lengths).to(dev)
    st, vl = cuda_kernels.json_get_span(v, ln, "name")
    err = max(err, require_equal("json_span", torch.stack([st, vl]),
                                 torch.stack(kernels.json_get_span(v, ln, "name"))))
    # and the "n" field, 3_aggregate's JsonGet on the same corpus
    err = max(err, require_equal("json_span key n",
                                 torch.stack(cuda_kernels.json_get_span(v, ln, "n")),
                                 torch.stack(kernels.json_get_span(v, ln, "n"))))
    call = lambda: cuda_kernels.json_get_span(v, ln, "name")  # noqa: E731
    ms, dev_ms, r_ms = time_ms(call), device_ms(call, narrow_names), run_ms(call)
    plain_ms = time_ms(lambda: kernels.json_get_span(v, ln, "name"), reps=3)
    b_ms, b_by = span_bound(st, vl, ln, 12.0 * N)
    narrow = dict(name="json_span", route="cuda",
                  source="fluvio_tpu_torch/smartengine/gpu/csrc/json_span.cu",
                  replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:100",
                  max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  library_ms=None, device_ms=dev_ms, run_ms=r_ms,
                  shape=f"{N} x {corpus.width}, a thread a record")
    log(f"kernel json_span: {ms:.4f} ms a call, device {dev_ms} ms, back to back {r_ms:.4f} ms "
        f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}) at N={N} W={corpus.width}, "
        f"exact")
    del v, ln, st, vl

    # narrow, late key: many rows of ~1 KB and of ~0.5 KB (against the plain
    # version), and few rows of ~60 KB (against json_get_bytes)
    for label, count, pad in (("late_key_1k", WIDE_RECORDS, 940),
                              ("late_key_512", WIDE_RECORDS, 420),
                              ("late_key_60k", FAT_RECORDS, 60000)):
        docs = late_key_docs(count, pad)
        buf = RecordBuffer.from_values(docs)
        v = torch.from_numpy(buf.values).to(dev)
        ln = torch.from_numpy(buf.lengths).to(dev)
        st, vl = cuda_kernels.json_get_span(v, ln, "name")
        if count == FAT_RECORDS:
            fields = [d[a: a + b] for d, a, b in zip(docs, st.tolist(), vl.tolist())]
            if fields != [dsl.json_get_bytes(d, "name") for d in docs]:
                raise AssertionError(f"json_span differs from json_get_bytes on {label}")
        else:
            err = max(err, require_equal(f"json_span {label}", torch.stack([st, vl]),
                                         torch.stack(kernels.json_get_span(v, ln, "name"))))
        call = lambda: cuda_kernels.json_get_span(v, ln, "name")  # noqa: E731
        b_ms, b_by = span_bound(st, vl, ln, 12.0 * count)
        narrow[label] = {"records": count, "width": buf.width, "ms": time_ms(call),
                         "device_ms": device_ms(call, narrow_names), "run_ms": run_ms(call),
                         "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel json_span {label}: {narrow[label]}, exact")
        del v, ln, st, vl
    narrow["max_abs_err"] = err

    # striped: the check geometry against the plain version (keys name, n)
    docs = span_docs(np.random.default_rng(5))
    _, p2, sv2, ln2, kmax2 = stage_striped(docs, SPAN_CHECK, dev)
    args2 = (sv2, stripes.owned_lengths(p2), p2["first_row"], p2["k"], ln2)
    plain = {}

    def run_plain(key):
        plain[key] = kernels.striped_json_span(*args2, key, kmax2, SPAN_CHECK.step)

    plain_ms = time_ms(lambda: run_plain("name"), reps=1, warm=False)  # one call: seconds
    run_plain("n")
    for key in ("name", "n"):
        got = torch.stack(cuda_kernels.striped_json_span(*args2, key, kmax2, SPAN_CHECK.step))
        striped_err = max(striped_err, require_equal(f"json_span_striped key={key}", got,
                                                     torch.stack(plain[key])))
    call = lambda: cuda_kernels.striped_json_span(*args2, "name", kmax2, SPAN_CHECK.step)  # noqa: E731
    check = {"ms": time_ms(call), "device_ms": device_ms(call, striped_names),
             "run_ms": run_ms(call)}
    sizes = [len(d) for d in docs]
    geometry = (f"{len(docs)} records of {min(sizes)}-{max(sizes)} bytes, stripes of "
                f"{SPAN_CHECK.width} bytes overlapping by {SPAN_CHECK.overlap}, kmax {kmax2}")
    log(f"kernel json_span_striped: exact against its plain version on {geometry} ({check}, "
        f"plain {plain_ms:.1f} ms)")

    # striped, the fat bench shape (name first) and the late-key fat batch,
    # each against json_get_bytes
    fat_rows = {}
    for label, fat in (("fat", gen_fat_70k(FAT_RECORDS)), ("late_key_fat", gen_fat_late(FAT_RECORDS))):
        buf, plan, sv, lengths, kmax = stage_striped(fat, FAT_PARAMS, dev)
        args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], lengths)
        vst, vln = cuda_kernels.striped_json_span(*args, "name", kmax, plan["step"])
        fields = [d[int(a): int(a) + int(b)] for d, a, b in zip(fat, vst.tolist(), vln.tolist())]
        if fields != [dsl.json_get_bytes(d, "name") for d in fat]:
            raise AssertionError(f"json_span_striped differs from json_get_bytes on {label}")
        call = lambda: cuda_kernels.striped_json_span(*args, "name", kmax, plan["step"])  # noqa: E731
        b_ms, b_by = span_bound(vst, vln, lengths, 4 * 4 * FAT_RECORDS + 8 * FAT_RECORDS)
        fat_rows[label] = {"records": FAT_RECORDS, "record_bytes": len(fat[0]),
                           "stripe_rows": sv.shape[0], "ms": time_ms(call),
                           "device_ms": device_ms(call, striped_names),
                           "run_ms": run_ms(call),
                           "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel json_span_striped {label}: {fat_rows[label]}, equal to json_get_bytes")
        del sv, vst, vln
    fat = fat_rows.pop("fat")
    striped = dict(name="json_span_striped", route="cuda",
                   source="fluvio_tpu_torch/smartengine/gpu/csrc/json_span.cu",
                   replaces="fluvio_tpu/smartengine/tpu/stripes.py:263",
                   max_abs_err=striped_err, ms=fat["ms"], plain_ms=plain_ms,
                   bound_ms=fat["bound_ms"], bound_by=fat["bound_by"], library_ms=None,
                   device_ms=fat["device_ms"], run_ms=fat["run_ms"], check_geometry=geometry,
                   check_ms=check["ms"], check_device_ms=check["device_ms"],
                   check_run_ms=check["run_ms"], **fat_rows)
    return narrow, striped


# keys whose needle (the key and two quotes) passes 48 KB, and one past the
# H100's 227 KB of shared memory a block, which the kernels read from global
# memory
LONG_KEYS = (49151, 240_000)


def phase_long_keys(dev):
    """Long keys through the user's entry point, ``json-map(field=key)``,
    against the interpreter: a batch of records up to 64 KiB (the narrow
    path, a warp a record) where the key fits one, and a batch past 64 KiB
    (the striped path) for every key; then the narrow kernel called
    directly at a thread-a-record width (the key never fits a row) against
    its plain version."""
    spec = lookup("json-map")
    checked = []
    for klen in LONG_KEYS:
        key = "a" * klen
        kb = key.encode()
        docs = [b'{"' + kb + b'":1}', b'{"a":2,"' + kb + b'":"v"}', b'{"' + kb + b'b":3}',
                b'{"a":4}']
        batches = [("striped", [d[:-1] + b',"pad":"' + b"x" * 70000 + b'"}' for d in docs])]
        if max(len(d) for d in docs) <= stripes.StripeParams().threshold:
            batches.insert(0, ("narrow", docs))
        prog = dsl.resolve_params(spec.dsl_program(spec.transform_kind()), {"field": key})
        for path, batch in batches:
            chain = build_chain([("json-map", {"field": key})])
            cuda_kernels.reset_launches()
            got = chain.process_buffer(RecordBuffer.from_values(batch)).value_list()
            torch.cuda.synchronize()
            kernel = "json_span_striped" if path == "striped" else "json_span"
            if cuda_kernels.LAUNCHES[kernel] <= 0:
                raise AssertionError(f"long key {klen} {path}: no {kernel} launch "
                                     f"({cuda_kernels.LAUNCHES})")
            want = [dsl.eval_expr(prog.value, rec, None) for rec in batch]
            if got != want or got[0] != b"1":
                raise AssertionError(f"long key {klen} {path}: {[g[:8] for g in got]} vs "
                                     f"{[w[:8] for w in want]}")
            checked.append(f"{klen} {path}")
        v, ln = stage([d[:64] for d in docs], 64, dev)
        require_equal(f"json_span long key {klen} W=64",
                      torch.stack(cuda_kernels.json_get_span(v, ln, key)),
                      torch.stack(kernels.json_get_span(v, ln, key)))
    log(f"long keys: json-map through SmartEngine(device='cuda') equal to the interpreter "
        f"({', '.join(checked)}; the first record gives b'1'); the narrow kernel at width 64 "
        f"equal to its plain version")


def phase_striped_kernels(dev):
    """The two striped kernels against their plain versions."""
    rows = []
    # the fat bench corpus, staged as the executor stages it
    fat = gen_fat_70k(FAT_RECORDS)
    buf, plan, sv, lengths, kmax = stage_striped(fat, FAT_PARAMS, dev)
    log(f"fat corpus: {FAT_RECORDS} records of {len(fat[0])} B, width bucket {buf.width}, "
        f"{tuple(sv.shape)} stripe rows, {kmax} stripes per record")

    # the span of the name field, for the in-span classes (the striped span
    # kernel's row is phase_json_span's)
    args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], lengths)
    vst, vln = cuda_kernels.striped_json_span(*args, "name", kmax, plan["step"])

    # DFA composition at the fat bench shape: in-span (22 states) and
    # record-level (flu[vV]io) classes, as the striped chains build them
    # (with the time of the torch class pass that builds each)
    dfa22 = compile_regex(JSON_REGEX)
    span_cls_ms = time_ms(lambda: stripes.stripe_classes(sv, plan, dfa22, (vst, vln)), reps=5)
    cls_span = stripes.stripe_classes(sv, plan, dfa22, (vst, vln))
    span_row = compose_row("in-span 22-state", cls_span, dfa22)
    del cls_span
    dfa_rec = compile_regex("flu[vV]io")
    rec_cls_ms = time_ms(lambda: stripes.stripe_classes(sv, plan, dfa_rec), reps=5)
    cls_rec = stripes.stripe_classes(sv, plan, dfa_rec)
    err, ms, plain_ms, b_ms, b_by, dev_ms = compose_row("record-level flu[vV]io", cls_rec,
                                                         dfa_rec)
    del cls_rec
    log(f"stripe_classes (torch class pass before dfa_compose) at the fat shape: record-level "
        f"{rec_cls_ms:.4f} ms, in-span {span_cls_ms:.4f} ms")
    compose_adversarial(dev)
    rows.append(dict(name="dfa_compose", route="cuda",
                     source="fluvio_tpu_torch/smartengine/gpu/csrc/dfa_compose.cu",
                     replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:850",
                     max_abs_err=max(err, span_row[0]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, device_ms=dev_ms,
                     stripe_classes_ms=rec_cls_ms,
                     in_span={"ms": span_row[1], "plain_ms": span_row[2],
                              "bound_ms": span_row[3], "bound_by": span_row[4],
                              "device_ms": span_row[5], "stripe_classes_ms": span_cls_ms}))
    return rows


def compose_adversarial(dev):
    """dfa_compose against its plain version on the adversarial set: the
    257-state table (two-byte entries, 132 KB unpacked), 258 classes,
    identity runs, ragged row and column counts. The kernel picks the
    segment length from S and T, so the shapes and tables reach its
    geometries: rows shorter than a segment (T = 20), column counts that
    are no multiple of the segment (333, 1000, 4097), 8 states with a
    lane a segment and several warps a row (8192, 4097), 11 states with
    two segments a warp, 43 and 67 states with a segment over two and
    three warps and several segments a row."""
    rng = np.random.default_rng(257)
    big = "(a|b)*a(a|b){6}c|x" + "d" * 125
    shapes = ((1003, 333), (517, 20), (129, 1000), (64, 8192), (1, 4097))
    checked = 0
    for pattern, packed in ((big, True), (big, False), ("flu[vV]io", False),
                            ("flu[vV]io", True), (JSON_REGEX, True), ("(a|b)*a(a|b){2}c", True),
                            ("x" + "d" * 40, True), ("(a|b)*a(a|b){5}c", False)):
        d = compile_regex(pattern, packed=packed)
        table_t = stripes._dfa_device(d, dev)[1]
        for n_rows, t_len in shapes:
            c = rng.integers(0, d.n_classes, size=(n_rows, t_len)).astype(np.int32)
            for i in range(n_rows):
                a = int(rng.integers(0, t_len))
                c[i, a: a + int(rng.integers(0, t_len))] = -1
            c[: min(7, n_rows - 1)] = -1
            if t_len >= 96:
                c[min(7, n_rows - 1):, 32:96] = -1  # identity segments in a live row
            c_t = torch.from_numpy(c).to(dev)
            require_equal(f"dfa_compose adversarial {pattern[:20]} S={d.n_states} "
                          f"packed={packed} {n_rows}x{t_len}",
                          cuda_kernels.dfa_compose_columns(c_t, table_t),
                          kernels.dfa_compose_columns(c_t, table_t))
            checked += 1
    torch.cuda.synchronize()
    log(f"kernel dfa_compose: adversarial set equal ({checked} cases: 257 states packed and "
        f"unpacked, 258 classes, flu[vV]io packed and unpacked (8 states, a lane a segment, "
        f"32 segments a warp), 11, 22, 43 and 67 states; shapes {shapes})")


def json_corpus_bytes(n: int, seed: int) -> np.ndarray:
    """`tests/test_glz_pallas.py`'s JSON corpus, concatenated."""
    rng = np.random.default_rng(seed)
    names = ["fluvio", "kafka", "pulsar", "fluvio-tpu", "redpanda", "flink"]
    vals = [f'{{"name":"{names[rng.integers(0, 6)]}-{i & 255}","n":{rng.integers(0, 100000)}}}'
            .encode() for i in range(n)]
    return np.frombuffer(b"".join(vals), dtype=np.uint8).copy()


def glz_tokens(raw: np.ndarray, chunk: int, dev, max_ratio: float = glz.MAX_RATIO, padded=True):
    """Compress on the host and upload the token arrays as the up link
    does: (stream, (lit_lens, match_lens, srcs, lits) on the card)."""
    comp, reason = glz.compress_link(raw, max_ratio=max_ratio, chunk=chunk)
    if comp is None:
        raise AssertionError(f"compress_link declined a smoke corpus: {reason}")
    tokens = pad_glz_tokens(comp) if padded else comp[:4]
    return comp, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in tokens)


def check_decode(name: str, raw: np.ndarray, chunk: int, dev, **kw) -> int:
    """The fused decode against its plain version (byte plan + plain
    resolve) and the raw bytes; the resolve kernel against its plain
    version on the same plan."""
    comp, tok = glz_tokens(raw, chunk, dev, **kw)
    got = cuda_kernels.glz_decode(*tok, comp.out_len, chunk, comp.depth)
    err = require_equal(f"glz_decode {name}", got,
                        glz.decode_plain(*tok, comp.out_len, chunk))
    if not np.array_equal(got.cpu().numpy(), raw):
        raise AssertionError(f"glz_decode {name}: the decoded bytes differ from the raw bytes")
    base, midx = glz.byte_plan_device(*tok, comp.out_len)
    require_equal(f"glz_resolve {name}", cuda_kernels.glz_resolve(base, midx, chunk),
                  kernels.glz_resolve(base, midx, chunk))
    return err


def pad8(data: bytes) -> np.ndarray:
    out = np.zeros((len(data) + 7) & ~7, np.uint8)
    out[: len(data)] = np.frombuffer(data, np.uint8)
    return out


def encode_corpora():
    """`tests/test_glz_encode.py`'s corpora."""
    rng = np.random.default_rng(0)
    return {
        "json": pad8(b'{"name":"fluvio-7","n":123,"pad":"xyz"}' * 700),
        "periodic5": pad8(bytes(range(5)) * 4000),
        "const": pad8(b"x" * 30000),
        "zeros_tail": np.concatenate([rng.integers(0, 256, 1024).astype(np.uint8),
                                      np.zeros(31744, np.uint8)]),
        "random": rng.integers(0, 256, 16384).astype(np.uint8),
        "tiny": pad8(b"abcdefgh"),
        "vocab": pad8(np.tile(np.array([1, 0, 7, 0, 6, 0, 250, 199], np.uint8), 3000).tobytes()),
    }


def match_inputs(stream: torch.Tensor, chunk_groups: int):
    w0, w1 = glz.enc_group_words(stream)
    const_m, _ = glz.enc_const_runs(w0, w1, chunk_groups)
    return w0, w1, const_m


def check_match(name: str, stream: torch.Tensor, chunk_groups: int) -> int:
    w0, w1, const_m = match_inputs(stream, chunk_groups)
    return require_equal(f"glz_enc_match {name}",
                         cuda_kernels.glz_encode_match(w0, w1, const_m, chunk_groups),
                         kernels.glz_encode_match(w0, w1, const_m, chunk_groups))


def match_ops(w0, w1, const_m, chunk_groups: int) -> float:
    """Probes this data needs (each group until its first hit) plus the
    pointer jumps."""
    g_count = w0.shape[0]
    g = torch.arange(g_count, device=w0.device)
    local = g % chunk_groups
    open_ = ~const_m
    probes = 0
    for d in kernels.GLZ_ENC_DISTANCES:
        if d >= chunk_groups:
            break
        active = open_ & (local >= d)
        probes += int(active.sum().item())
        s = (g - d).clamp(min=0)
        open_ = open_ & ~(active & ~const_m[s] & (w0[s] == w0) & (w1[s] == w1))
    return float(probes + g_count * kernels.glz_square_rounds(chunk_groups))


def enc_match_case(stream: torch.Tensor, chunk: int):
    """The encode window match on ``stream`` at ``chunk`` bytes a chunk
    (clamped as `encode_result` clamps a single window) against its plain
    version: times a call, device time over every kernel of a call and
    the kernels a call launches, the plain version's time and the bound."""
    g_count = stream.numel() // glz.ENC_GROUP
    cg = chunk // glz.ENC_GROUP
    if g_count <= cg:  # encode_result's single-window clamp
        cg = max(128, ((g_count + 127) // 128) * 128)
    w0, w1, const_m = match_inputs(stream, cg)
    err = check_match(f"headline chunk {chunk}", stream, cg)
    call = lambda: cuda_kernels.glz_encode_match(w0, w1, const_m, cg)  # noqa: E731
    ms = time_ms(call)
    by_kernel = {}
    dev_ms, per_call = device_time(call, kernel_names("glz_encode.cu"), by_kernel=by_kernel)
    plain_ms = time_ms(lambda: kernels.glz_encode_match(w0, w1, const_m, cg), reps=3)
    b_ms, b_by = bound(13.0 * g_count, match_ops(w0, w1, const_m, cg))
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, groups=g_count, chunk_groups=cg, launches_per_call=per_call,
                device_ms_by_kernel=by_kernel, outside_constant_runs=int((~const_m).sum().item()))


def enc_match_row(stream: torch.Tensor):
    """The encode window match's row: the headline descriptor stream at the
    link's chunk (256 KiB), and at 512 KiB chunks beside it."""
    head = enc_match_case(stream, glz.GLZ_CHUNK)
    wide = enc_match_case(stream, 2 * glz.GLZ_CHUNK)
    for case in (head, wide):
        log(f"kernel glz_enc_match: {case['ms']:.4f} ms a call, device {case['device_ms']} ms "
            f"in {case['launches_per_call']} launches a call {case['device_ms_by_kernel']} (plain "
            f"{case['plain_ms']:.3f} ms, "
            f"bound {case['bound_ms']:.6f} ms by {case['bound_by']}, library: none (no single "
            f"PyTorch call)) on the headline descriptor stream of {case['groups']} groups "
            f"({case['outside_constant_runs']} outside constant runs), {case['chunk_groups']} "
            f"groups a chunk, exact")
    row = dict(name="glz_enc_match", route="cuda",
               source="fluvio_tpu_torch/smartengine/gpu/csrc/glz_encode.cu",
               replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:541",
               library_ms=None, **head)
    row["max_abs_err"] = max(head["max_abs_err"], wide["max_abs_err"])
    row["chunk_524288"] = {k: wide[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "chunk_groups", "launches_per_call",
                                                 "device_ms_by_kernel")}
    return row


def enc_match_adversarial(dev):
    """The encode window match against its plain version where the tiles
    and their join matter: a period-2 stream (every chain runs back to its
    chunk's start over every tile border), a mixed stream (few values,
    constant runs over tile tails, a stretch with no match), chunks of
    128 groups up to 262,144 (one tile, a tile and a halo, 64 tiles: past
    the join's window), ragged last chunks; at most two launches a call."""
    rng = np.random.default_rng(41)
    g_count = 300_000
    period2 = np.where(np.arange(g_count) % 2 == 0, 7, 9).astype(np.int32)
    mixed0 = rng.integers(0, 6, g_count).astype(np.int32)
    mixed1 = rng.integers(0, 2, g_count).astype(np.int32)
    for at in range(2048 - 128 - 3, g_count - 64, 2048):
        mixed0[at: at + 40] = 3
    mixed0[50_000:60_000] = rng.integers(1000, 1 << 30, 10_000)
    names = kernel_names("glz_encode.cu")
    most = 0
    for label, a, b in (("period-2", period2, np.zeros(g_count, np.int32)),
                        ("mixed", mixed0, mixed1)):
        w0, w1 = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        for cg in (128, 2048, 2176, 4096, 32768, 65536, 131072, 262144):
            const_m, _ = glz.enc_const_runs(w0, w1, cg)
            call = lambda: cuda_kernels.glz_encode_match(w0, w1, const_m, cg)  # noqa: E731
            require_equal(f"glz_enc_match {label} chunk groups {cg}", call(),
                          kernels.glz_encode_match(w0, w1, const_m, cg))
            per_call = device_time(call, names, reps=10)[1]
            if per_call is None or per_call > 2:
                raise AssertionError(f"glz_enc_match {label} cg={cg}: {per_call} launches a call")
            most = max(most, per_call)
    torch.cuda.synchronize()
    log(f"kernel glz_enc_match: tiled adversarial set equal (period-2 and mixed streams of "
        f"{g_count} groups at 128 to 262,144 groups a chunk), at most {most:g} launches a call")


def headline_desc_stream(corpus: RecordBuffer, dev) -> torch.Tensor:
    """The headline chain's down-link stream for one batch: the survivors'
    (start, length) of the name field, compacted and interleaved."""
    v = torch.from_numpy(corpus.values).to(dev)
    ln = torch.from_numpy(corpus.lengths).to(dev)
    valid = kernels.literal_search(v, ln, b"fluvio") & (torch.arange(v.shape[0], device=dev)
                                                       < corpus.count)
    st, vl = cuda_kernels.json_get_span(v, ln, "name")
    _, (cst, cln) = kernels.compact_rows(valid, st, vl)
    return desc_stream(cst, cln, corpus.width)


def phase_glz_kernels(dev, corpus: RecordBuffer):
    """Both glz kernels against their plain versions: the main path's
    shapes, then the adversarial sets."""
    rows = []
    # the fused decode at the headline shape: the compressed flat of one batch
    flat = np.ascontiguousarray(corpus.ragged_values()[0])
    chunk = glz.GLZ_CHUNK
    t0 = time.perf_counter()
    comp, tok = glz_tokens(flat, chunk, dev)
    compress_s = time.perf_counter() - t0
    n = flat.size
    got = cuda_kernels.glz_decode(*tok, n, chunk, comp.depth)
    err = require_equal("glz_decode headline", got, glz.decode_plain(*tok, n, chunk))
    if not np.array_equal(got.cpu().numpy(), flat):
        raise AssertionError("glz_decode headline: the decoded flat differs from the raw flat")
    call = lambda: cuda_kernels.glz_decode(*tok, n, chunk, comp.depth)  # noqa: E731
    ms = time_ms(call)
    dev_ms, per_call = device_time(call, kernel_names("glz_decode.cu", "tile", "literal",
                                                      "round"))
    plain_ms = time_ms(lambda: glz.decode_plain(*tok, n, chunk), reps=3)
    # the old up-link path: the torch byte plan, then the resolve kernel
    old_ms = time_ms(lambda: cuda_kernels.glz_resolve(*glz.byte_plan_device(*tok, n), chunk),
                     reps=5)
    plan_ms = time_ms(lambda: glz.byte_plan_device(*tok, n), reps=5)
    # the tokens the kernel reads: the stream's own (6 B a sequence plus
    # the literals) and the lengths of the pad sequences, which the offset
    # scans read; it never reads a pad's source or the literals' padding
    token_bytes = comp.nbytes + 2 * (tok[0].numel() - len(comp.lit_lens))
    b_ms, b_by = bound(float(token_bytes + n), float(n))
    decode_row = dict(name="glz_decode", route="cuda",
                      source="fluvio_tpu_torch/smartengine/gpu/csrc/glz_decode.cu",
                      replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:434",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=None, device_ms=dev_ms, out_bytes=n, token_bytes=token_bytes,
                      depth=comp.depth, sequences=len(comp.lit_lens), launches_per_call=per_call,
                      old_path_ms=old_ms, byte_plan_ms=plan_ms)
    rows.append(decode_row)
    log(f"kernel glz_decode: {ms:.4f} ms a call, device {dev_ms} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
        f"{b_by}, library: none (no single PyTorch call); old path byte plan + resolve "
        f"{old_ms:.3f} ms, of it the plan {plan_ms:.3f} ms) on the headline flat of {n} B from "
        f"{token_bytes} B of tokens read (ratio {comp.nbytes / n:.3f}, depth {comp.depth}, "
        f"{len(comp.lit_lens)} sequences, {per_call} launches a call, host compress "
        f"{compress_s * 1e3:.1f} ms), exact")

    # the resolve kernel (the Pallas contract, off the main path) on the same plan
    base, midx = glz.byte_plan_device(*tok, n)
    got = cuda_kernels.glz_resolve(base, midx, chunk)
    r_err = require_equal("glz_resolve headline", got, kernels.glz_resolve(base, midx, chunk))
    if not np.array_equal(got.cpu().numpy(), flat):
        raise AssertionError("glz_resolve headline: the decoded flat differs from the raw flat")
    call = lambda: cuda_kernels.glz_resolve(base, midx, chunk)  # noqa: E731
    r_ms = time_ms(call)
    r_dev_ms = device_ms(call, kernel_names("glz_decode.cu", "resolve"))
    r_plain_ms = time_ms(lambda: kernels.glz_resolve(base, midx, chunk), reps=3)
    p, hops = torch.arange(n, device=dev), 0
    m64 = midx.to(torch.int64)
    for _ in range(1 << kernels.GLZ_SQUARE_ROUNDS):
        q = m64[p]
        hops += int((q != p).sum().item())
        p = q
    r_b_ms, r_b_by = bound(6.0 * n, float(hops + n))
    rows.append(dict(name="glz_resolve", route="cuda",
                     source="fluvio_tpu_torch/smartengine/gpu/csrc/glz_decode.cu",
                     replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:434",
                     max_abs_err=r_err, ms=r_ms, plain_ms=r_plain_ms, bound_ms=r_b_ms,
                     bound_by=r_b_by, library_ms=None, device_ms=r_dev_ms, out_bytes=n,
                     main_path=False))
    log(f"kernel glz_resolve: {r_ms:.4f} ms a call, device {r_dev_ms} ms (plain {r_plain_ms:.3f} ms, bound {r_b_ms:.4f} ms "
        f"by {r_b_by}) on the headline flat's byte plan, exact; off the main path")
    del base, midx, m64, p, got, tok

    # the fused decode on the striped fat batch's flat (the striped link cell)
    fat_flat = np.ascontiguousarray(
        RecordBuffer.from_values(gen_fat_70k(FAT_RECORDS)).ragged_values()[0])
    fat_comp, fat_tok = glz_tokens(fat_flat, chunk, dev)
    got = cuda_kernels.glz_decode(*fat_tok, fat_flat.size, chunk, fat_comp.depth)
    require_equal("glz_decode fat", got, glz.decode_plain(*fat_tok, fat_flat.size, chunk))
    if not np.array_equal(got.cpu().numpy(), fat_flat):
        raise AssertionError("glz_decode fat: the decoded flat differs from the raw flat")
    fat_ms = time_ms(lambda: cuda_kernels.glz_decode(*fat_tok, fat_flat.size, chunk,
                                                     fat_comp.depth))
    fat_old_ms = time_ms(lambda: cuda_kernels.glz_resolve(
        *glz.byte_plan_device(*fat_tok, fat_flat.size), chunk), reps=5)
    decode_row["fat_flat"] = {"out_bytes": fat_flat.size, "depth": fat_comp.depth, "ms": fat_ms,
                            "old_path_ms": fat_old_ms}
    log(f"kernel glz_decode: {fat_ms:.4f} ms (old path {fat_old_ms:.3f} ms) on the striped fat "
        f"flat of {fat_flat.size} B ({fat_comp.nbytes} B of tokens, depth {fat_comp.depth}), "
        f"exact and equal to the raw flat")
    del got, fat_tok

    # adversarial decode set
    period28 = np.frombuffer(b'{"name":"fluvio-1","n":123}\n' * 5000, np.uint8).copy()
    mixed = np.concatenate([json_corpus_bytes(2000, 2024),
                            np.random.default_rng(3).integers(0, 256, 8192).astype(np.uint8),
                            json_corpus_bytes(2000, 5)])
    deep = json_corpus_bytes(9000, 2024)
    deep_comp, _ = glz.compress_link(deep, max_ratio=1.0, chunk=64 * 1024)
    if deep_comp.depth != glz.MAX_DEPTH:
        raise AssertionError(f"depth corpus compressed to depth {deep_comp.depth}, expected 6")
    cases = [("zeros", np.zeros(96 * 1024, np.uint8), 16384, {}),
             ("period28", period28, 16384, {}),
             ("mixed", mixed, 16384, {"max_ratio": 1.0}),
             ("mixed 64k", mixed, 65536, {"max_ratio": 1.0}),
             ("depth-6", deep, 65536, {"max_ratio": 1.0}),
             ("depth-6 bare tokens", deep, 65536, {"max_ratio": 1.0, "padded": False}),
             ("headline slice 16k", flat[: 3 * 16384 + 4100], 16384, {})]
    for name, raw, case_chunk, kw in cases:
        check_decode(name, raw, case_chunk, dev, **kw)
    ragged = sum(1 for _, raw, case_chunk, _ in cases if raw.size % case_chunk)
    torch.cuda.synchronize()
    log(f"kernels glz_decode and glz_resolve: adversarial set equal ({', '.join(c[0] for c in cases)}; "
        f"{ragged} of {len(cases)} with a ragged last chunk)")

    # encode window match at the headline chain's descriptor stream
    row = enc_match_row(headline_desc_stream(corpus, dev))
    for per_call in (row["launches_per_call"], row["chunk_524288"]["launches_per_call"]):
        if per_call is None or per_call > 2:
            raise AssertionError(f"glz_enc_match: {per_call} launches a call")
    rows.append(row)
    enc_match_adversarial(dev)

    # adversarial encode set: seven corpora at four chunk sizes
    for name, raw in encode_corpora().items():
        t = torch.from_numpy(raw).to(dev)
        for chunk in (4096, 16384, 262144, 524288):
            check_match(f"{name} chunk {chunk}", t, chunk // glz.ENC_GROUP)
            ll, ml, srcs, lits, n_seq, n_lit, depth = glz.encode_result(t, chunk)
            back = glz.decode_result_host(ll.cpu().numpy(), ml.cpu().numpy(), srcs.cpu().numpy(),
                                          lits.cpu().numpy(), int(n_seq), int(n_lit), raw.size,
                                          int(depth))
            if not np.array_equal(back, raw):
                raise AssertionError(f"encode_result {name} chunk {chunk}: does not decode back")
    torch.cuda.synchronize()
    log("kernel glz_enc_match: adversarial set equal (json, periodic5, const, zeros_tail, random, "
        "tiny, vocab at chunks 4096, 16384, 262144, 524288; every encoded stream decodes back)")
    return rows


def phase_glz_chains(corpora, off_rate: float, off_h2d: int):
    """The headline chain with the glz link on (records/s beside the link-
    off run), then the striped span chain with the link on."""
    launches, rate, chain = phase_headline(corpora, GLZ_LINK)
    counts = dict(chain.link_counts)
    if counts["glz"] != HEADLINE_BATCHES or counts["raw"]:
        raise AssertionError(f"headline chain with the link: the up link did not ship glz: {counts}")
    if min(launches["glz_decode"], launches["glz_enc_match"]) <= 1 or launches["glz_resolve"]:
        raise AssertionError(f"headline chain with the link: glz kernels launched {launches}")
    if counts["h2d_bytes"] >= off_h2d:
        raise AssertionError(f"link-on H2D {counts['h2d_bytes']} B not below link-off {off_h2d} B")
    flat_bytes = sum(RecordBuffer.from_values(c).ragged_values()[0].nbytes for c in corpora[:1])
    compress_ms = []
    for c in corpora:
        flat = RecordBuffer.from_values(c).ragged_values()[0]
        t0 = time.perf_counter()
        glz.compress_link(flat)
        compress_ms.append((time.perf_counter() - t0) * 1e3)
    head = {"records_per_s_link_on": rate, "records_per_s_link_off": off_rate,
            "h2d_bytes_link_on": counts["h2d_bytes"], "h2d_bytes_link_off": off_h2d,
            "d2h_bytes_link_on": counts["d2h_bytes"], "flat_bytes_batch0": flat_bytes,
            "compress_ms_median": statistics.median(compress_ms), "link_counts": counts}
    log(f"glz headline: {rate:.0f} records/s with the link on, {off_rate:.0f} off (same run); "
        f"H2D {counts['h2d_bytes']} B on vs {off_h2d} B off; D2H {counts['d2h_bytes']} B; "
        f"down link {counts['down-glz']} down-glz / {counts['down-packed']} down-packed, "
        f"declines enc-ratio {counts[glz.DECLINE_ENC_RATIO]}; host compress median "
        f"{statistics.median(compress_ms):.1f} ms a batch")

    name = "fluvio_dfa_json_map_fat"
    corpus = gen_fat_70k(FAT_RECORDS)
    chain = build_chain(STRIPED_CHAINS[name], FAT_PARAMS, GLZ_LINK)
    chain.process_buffer(RecordBuffer.from_values(corpus[:8]))  # warm-up, small
    bufs = [RecordBuffer.from_values(corpus) for _ in range(FAT_BATCHES)]
    torch.cuda.synchronize()
    for k in chain.link_counts:
        chain.link_counts[k] = 0
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    outs = list(chain.process_stream(bufs))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fat_launches = dict(cuda_kernels.LAUNCHES)
    keep, want = striped_truth(name, corpus)
    if outs[0].offset_deltas[: outs[0].count].tolist() != keep or outs[0].value_list() != want:
        raise AssertionError("striped chain with the link: batch 0 differs from host truth")
    fat = dict(chain.link_counts)
    if fat_launches["glz_decode"] <= 0 or fat_launches["glz_resolve"]:
        raise AssertionError(f"striped chain with the link: glz kernels launched {fat_launches}")
    if fat["glz"] != FAT_BATCHES or fat["down-glz"] != FAT_BATCHES:
        raise AssertionError(f"striped chain with the link: not every batch shipped tokens: {fat}")
    raw_bytes = FAT_BATCHES * sum(len(r) for r in corpus)
    fat_rate = {"records_per_s": FAT_BATCHES * FAT_RECORDS / elapsed,
                "bytes_per_s": raw_bytes / elapsed, "link_counts": fat}
    log(f"glz striped chain {name}: {FAT_BATCHES} x {FAT_RECORDS} records in {elapsed:.3f} s = "
        f"{fat_rate['records_per_s']:.1f} records/s; batch 0 equal to host truth; H2D "
        f"{fat['h2d_bytes']} B for {raw_bytes} B of records; link {fat}; launches {fat_launches}")
    total = {k: launches[k] + fat_launches[k] for k in launches}
    return total, {"headline": head, name: fat_rate}


STRIPED_CHAINS = {
    "7_fat70k": [("regex-filter", {"regex": "fluvio"})],
    "10_regex_json_fat": [("json-regex-filter", {"key": "name", "regex": JSON_REGEX})],
    "fluvio_dfa_json_map_fat": [("regex-filter", {"regex": "flu[vV]io"}),
                                ("json-map", {"field": "name"})],
}


def striped_truth(name: str, corpus):
    """Host truth of a striped chain over one batch: (offsets, values)."""
    if name == "7_fat70k":
        keep = [i for i, rec in enumerate(corpus) if b"fluvio" in rec]
        return keep, [corpus[i] for i in keep]
    if name == "10_regex_json_fat":
        rx = re.compile(JSON_REGEX.encode())
        keep = [i for i, rec in enumerate(corpus) if rx.search(dsl.json_get_bytes(rec, "name"))]
        return keep, [corpus[i] for i in keep]
    rx = re.compile(rb"flu[vV]io")
    keep = [i for i, rec in enumerate(corpus) if rx.search(rec)]
    return keep, [dsl.ascii_upper(dsl.json_get_bytes(corpus[i], "name")) for i in keep]


def phase_striped_chains():
    """Each striped chain over FAT_BATCHES batches through the user's entry
    point; one whole batch against host truth. Returns the summed launches
    and each chain's rates."""
    corpus = gen_fat_70k(FAT_RECORDS)
    total = {k: 0 for k in cuda_kernels.LAUNCHES}
    rates = {}
    for name, specs in STRIPED_CHAINS.items():
        chain = build_chain(specs, FAT_PARAMS)
        chain.process_buffer(RecordBuffer.from_values(corpus[:8]))  # warm-up, small
        bufs = [RecordBuffer.from_values(corpus) for _ in range(FAT_BATCHES)]
        torch.cuda.synchronize()
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        outs = list(chain.process_stream(bufs))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        for k, c in launches.items():
            total[k] += c
        keep, want = striped_truth(name, corpus)
        out = outs[0]
        if out.offset_deltas[: out.count].tolist() != keep or out.value_list() != want:
            raise AssertionError(f"striped chain {name}: batch 0 differs from host truth "
                                 f"({out.count} vs {len(keep)} survivors)")
        if not keep or any(o.count != len(keep) for o in outs):
            raise AssertionError(f"striped chain {name}: implausible survivor counts "
                                 f"{[o.count for o in outs]}")
        recs = FAT_BATCHES * FAT_RECORDS / elapsed
        nbytes = FAT_BATCHES * sum(len(r) for r in corpus) / elapsed
        rates[name] = {"records_per_s": recs, "bytes_per_s": nbytes}
        log(f"striped chain {name}: {FAT_BATCHES} x {FAT_RECORDS} records of {len(corpus[0])} B "
            f"in {elapsed:.3f} s = {recs:.1f} records/s, {nbytes / 1e9:.3f} GB/s; batch 0 equal "
            f"to host truth ({len(keep)} survivors); launches {launches}")
    return total, rates


def build_chain(specs, stripe_params=None, link=None):
    b = SmartEngine(device="cuda", stripes=stripe_params or stripes.StripeParams(),
                    link=link or LinkParams()).builder()
    for name, params in specs:
        b.add_smart_module(SmartModuleConfig(params=params), lookup(name))
    return b.initialize().gpu_chain


def phase_headline(corpora, link=None):
    """The headline chain over the corpora, one batch each, through
    ``process_stream``; batch 0 against the interpreter. Returns (launches,
    records/s, the chain)."""
    specs = HEADLINE
    chain = build_chain(specs, link=link)
    bufs = [RecordBuffer.from_values(c) for c in corpora]
    chain.process_buffer(RecordBuffer.from_values(corpora[0][:4096]))  # warm-up, small
    torch.cuda.synchronize()
    for k in chain.link_counts:
        chain.link_counts[k] = 0

    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    outs = list(chain.process_stream(bufs))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    if launches["json_span"] <= 0:
        raise AssertionError(f"headline chain launched no json_span kernel: {launches}")

    # host truth: the DSL interpreter over the whole first batch
    progs = [dsl.resolve_params(lookup(n).dsl_program(lookup(n).transform_kind()), p)
             for n, p in specs]
    interp = fork_records(lambda rec: dsl.eval_expr(progs[1].value, rec, None)
                          if dsl.eval_expr(progs[0].predicate, rec, None) else None, corpora[0])
    want = [x for x in interp if x is not None]
    got = outs[0].value_list()
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        raise AssertionError(f"headline batch differs from the interpreter at survivor {first} "
                             f"({len(got)} vs {len(want)} survivors)")
    want_off = [i for i, x in enumerate(interp) if x is not None]
    if outs[0].offset_deltas[: outs[0].count].tolist() != want_off:
        raise AssertionError("headline batch offsets differ from the survivors' offsets")
    for k, o in enumerate(outs):
        if o.count <= 0 or o.count >= N:
            raise AssertionError(f"headline batch {k}: implausible survivor count {o.count}")
    rate = HEADLINE_BATCHES * N / elapsed
    log(f"headline chain{' (glz link on)' if link else ''}: {HEADLINE_BATCHES} x {N} records in "
        f"{elapsed:.3f} s = {rate:.0f} records/s end to end; batch 0 equal to the interpreter "
        f"({len(want)} survivors); launches {launches}; link {chain.link_counts}")
    return launches, rate, chain


def phase_json_regex():
    specs = [("json-regex-filter", {"key": "name", "regex": JSON_REGEX})]
    chain = build_chain(specs)
    corpus = gen_json(N, seed=7)
    buf = RecordBuffer.from_values(corpus)
    chain.process_buffer(RecordBuffer.from_values(corpus[:4096]))  # warm-up, small
    torch.cuda.synchronize()

    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    out = chain.process_buffer(buf)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    if min(launches[k] for k in ("json_span", "extract", "dfa_scan")) <= 0:
        raise AssertionError(f"json-regex-filter chain missed a kernel: {launches}")

    rx = re.compile(JSON_REGEX.encode())
    want_idx = [i for i, rec in enumerate(corpus) if rx.search(dsl.json_get_bytes(rec, "name"))]
    got_idx = out.offset_deltas[: out.count].tolist()
    if got_idx != want_idx or out.value_list() != [corpus[i] for i in want_idx]:
        raise AssertionError(f"json-regex-filter survivors differ from re: {len(got_idx)} vs "
                             f"{len(want_idx)}")
    if not want_idx:
        raise AssertionError("json-regex-filter corpus has no survivors to check")
    rate = N / elapsed
    log(f"json-regex-filter chain: {N} records in {elapsed:.3f} s = {rate:.0f} records/s; "
        f"{len(want_idx)} survivors equal to re over json_get_bytes; launches {launches}")
    return launches, rate


def phase_regex_chain():
    """``regex-filter("flu[vV]io")`` -> ``json-map(field="name")`` over one
    batch of N narrow records: a pattern that is no literal, so every
    whole record goes through the DFA scan. Survivors against ``re``."""
    name = "fluvio_dfa_json_map_fat"  # the same chain as the striped one
    chain = build_chain(STRIPED_CHAINS[name])
    corpus = gen_json(N, seed=11)
    buf = RecordBuffer.from_values(corpus)
    chain.process_buffer(RecordBuffer.from_values(corpus[:4096]))  # warm-up, small
    torch.cuda.synchronize()

    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    out = chain.process_buffer(buf)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    if min(launches[k] for k in ("dfa_scan", "json_span")) <= 0:
        raise AssertionError(f"flu[vV]io chain missed a kernel: {launches}")
    keep, want = striped_truth(name, corpus)
    if out.offset_deltas[: out.count].tolist() != keep or out.value_list() != want:
        raise AssertionError(f"flu[vV]io chain survivors differ from re: {out.count} vs "
                             f"{len(keep)}")
    if not 0 < len(keep) < N:
        raise AssertionError(f"flu[vV]io chain: implausible survivor count {len(keep)}")
    rate = N / elapsed
    log(f"flu[vV]io chain: {N} records in {elapsed:.3f} s = {rate:.0f} records/s; "
        f"{len(keep)} survivors equal to re (name field, upper-cased); launches {launches}")
    return launches, rate


# the aggregate and array_map slice: bench configs 3_aggregate, 4_array_map
# and 9_partitioned's chain on one partition
SLICE_CHAINS = {
    "3_aggregate": [("aggregate-field", {"field": "n", "combine": "add"})],
    "4_array_map": [("array-map-json", {})],
    "filter_aggregate": [("regex-filter", {"regex": "fluvio"}),
                         ("aggregate-field", {"field": "n", "combine": "add"})],
}
SLICE_BATCHES = 4
# records a host-truth task: the interpreter runs in worker processes
TRUTH_CHUNK = 1 << 16
# the slice's torch code on the card (XLA code, not Pallas, in the JAX
# package): the functions of `kernels` the two stages call
SLICE_TORCH_OPS = ("parse_int", "int_to_ascii", "count_words", "segmented_scan",
                   "propagate_last_valid", "last_true_value", "json_array_bounds",
                   "split_bounds", "fanout_scatter")


_TRUTH_CORPORA: list = []  # the batches the forked truth workers read
TRUTH_WORKERS = 8


def _fork_worker(fn, tasks, conn) -> None:
    try:
        conn.send(("ok", [fn(t) for t in tasks]))
    except BaseException as e:  # noqa: BLE001 — sent to the parent, which raises
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


def fork_map(fn, tasks):
    """``[fn(t) for t in tasks]`` over up to TRUTH_WORKERS forked
    processes, each taking every n-th task (``fn`` and what it reads are
    inherited, only the results are pickled). Every process is joined,
    or ended, before this returns; a worker's error raises here."""
    import multiprocessing

    ctx = multiprocessing.get_context("fork")
    n = max(1, min(TRUTH_WORKERS, len(tasks)))
    workers = []
    try:
        for w in range(n):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_fork_worker, args=(fn, tasks[w::n], send), daemon=True)
            proc.start()
            send.close()
            workers.append((proc, recv))
        results = []
        for proc, recv in workers:
            status, value = recv.recv()
            proc.join()
            if status != "ok":
                raise RuntimeError(f"host truth worker failed: {value}")
            results.append(value)
    finally:
        for proc, _ in workers:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    out = [None] * len(tasks)
    for w, values in enumerate(results):
        out[w::n] = values
    return out


def fork_records(fn, records):
    """``[fn(r) for r in records]``, TRUTH_CHUNK records a `fork_map`
    task: the host truths' interpreter loops."""
    parts = fork_map(lambda lo: [fn(r) for r in records[lo:lo + TRUTH_CHUNK]],
                     list(range(0, len(records), TRUTH_CHUNK)))
    return [x for part in parts for x in part]


def json_n(rec: bytes) -> int:
    """The interpreter's ``n`` of a record (JsonGet, then ParseInt)."""
    return dsl.parse_int_prefix(dsl.json_get_bytes(rec, "n"))


def _truth_chunk(task):
    """The DSL interpreter over records [lo, hi) of truth batch ``k``:
    for ``4_array_map`` (elements a record, element lengths, the elements
    joined); for the aggregates (kept, each kept record's ``n`` wrapped
    to int64)."""
    name, k, lo, hi = task
    recs = _TRUTH_CORPORA[k][lo:hi]
    if name == "4_array_map":
        elems = [dsl.json_array_elements(rec) for rec in recs]
        flat = [e for es in elems for e in es]
        return (np.array([len(es) for es in elems], np.int64),
                np.array([len(e) for e in flat], np.int64), b"".join(flat))
    keep = np.array([name != "filter_aggregate" or b"fluvio" in rec for rec in recs], bool)
    nums = [(dsl.parse_int_prefix(dsl.json_get_bytes(rec, "n")) + 2**63) % 2**64 - 2**63
            if kept else 0 for rec, kept in zip(recs, keep)]
    return keep, np.array(nums, np.int64)


def slice_truth(name: str, corpora):
    """Host truth of a slice chain over its batches, from the DSL
    interpreter (in forked worker processes, a chunk of records a task):
    per batch (output lengths, output values joined, source offsets). The
    running sums continue across batches and wrap as int64."""
    global _TRUTH_CORPORA
    _TRUTH_CORPORA = list(corpora)
    tasks = [(name, k, lo, min(lo + TRUTH_CHUNK, len(c)))
             for k, c in enumerate(corpora) for lo in range(0, len(c), TRUTH_CHUNK)]
    try:
        parts = fork_map(_truth_chunk, tasks)
    finally:
        _TRUTH_CORPORA = []
    by_batch = [[p for t, p in zip(tasks, parts) if t[1] == k] for k in range(len(corpora))]
    outs = []
    if name == "4_array_map":
        for chunks in by_batch:
            counts = np.concatenate([c for c, _, _ in chunks])
            lens = np.concatenate([ln for _, ln, _ in chunks])
            offs = np.repeat(np.arange(len(counts)), counts)
            outs.append((lens, b"".join(f for _, _, f in chunks), offs))
        return outs
    keeps = [np.concatenate([kp for kp, _ in chunks]) for chunks in by_batch]
    nums = np.concatenate([np.concatenate([x for _, x in chunks])[kp]
                           for kp, chunks in zip(keeps, by_batch)])
    with np.errstate(over="ignore"):
        sums = np.cumsum(nums)  # int64 wraps, as the chain's carry does
    start = 0
    for kp in keeps:
        text = [str(x).encode() for x in sums[start:start + int(kp.sum())].tolist()]
        start += int(kp.sum())
        outs.append((np.array([len(t) for t in text], np.int64), b"".join(text),
                     np.flatnonzero(kp)))
    return outs


def capture_torch_ops(run, module=kernels, names=SLICE_TORCH_OPS):
    """Run ``run()`` with each function ``names`` of ``module`` wrapped to
    keep the arguments of its first call; returns {name: (function,
    arguments)} of those the run called."""
    originals = {n: getattr(module, n) for n in names}
    seen = {}

    def keep(name, fn):
        def call(*args):
            seen.setdefault(name, args)
            return fn(*args)
        return call

    try:
        for name, fn in originals.items():
            setattr(module, name, keep(name, fn))
        run()
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)
    return {name: (originals[name], args) for name, args in seen.items()}


def phase_slice_chain(name: str, corpora):
    """One slice chain over SLICE_BATCHES full batches through the user's
    entry point, every output record against the interpreter. The chain
    starts from the default explode capacity (its warm-up runs on another
    instance), so 4_array_map's first batch overflows and runs again.
    Returns (launches, the run's numbers, the torch ops' inputs)."""
    specs = SLICE_CHAINS[name]
    build_chain(specs).process_buffer(RecordBuffer.from_values(corpora[0][:4096]))  # warm-up
    chain = build_chain(specs)
    bufs = [RecordBuffer.from_values(c) for c in corpora]
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    outs = list(chain.process_stream(bufs))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    if name != "4_array_map" and min(launches["json_span"], launches["extract"]) < len(corpora):
        raise AssertionError(f"{name}: json_span and extract not launched every batch: {launches}")

    t_truth = time.perf_counter()
    truth = slice_truth(name, corpora)
    for k, ((lens, flat, offs), out) in enumerate(zip(truth, outs)):
        cols = out.to_columns()
        got_lens = np.diff(cols["val_off"])
        if out.count != len(lens) or not (np.array_equal(got_lens, lens)
                                          and cols["val_flat"].tobytes() == flat):
            n = min(len(got_lens), len(lens))
            first = int(np.flatnonzero(got_lens[:n] != lens[:n])[0]) if (
                got_lens[:n] != lens[:n]).any() else n
            raise AssertionError(f"{name} batch {k}: differs from the interpreter at or before "
                                 f"output {first} ({out.count} vs {len(lens)} outputs)")
        want_off = np.zeros(len(offs), np.int32) if name == "4_array_map" else offs
        if not np.array_equal(out.offset_deltas[: out.count], want_off):
            raise AssertionError(f"{name} batch {k}: offsets differ from the interpreter's")
        if (out.key_lengths[: out.count] != -1).any():
            raise AssertionError(f"{name} batch {k}: keys on keyless records")
        if out.values is not None:
            raise AssertionError(f"{name} batch {k}: the output is not flat-backed")
    truth_s = time.perf_counter() - t_truth
    chain._ensure_host_state()
    last = truth[-1][1][len(truth[-1][1]) - int(truth[-1][0][-1]):] if name != "4_array_map" else b""
    if name != "4_array_map" and chain.carries != [(int(last), 0, True)]:
        raise AssertionError(f"{name}: carries {chain.carries} are not the last running sum")
    n_in = len(corpora) * len(corpora[0])
    n_out = sum(o.count for o in outs)
    numbers = {"records_per_s": n_in / elapsed, "output_rows_per_s": n_out / elapsed,
               "records": n_in, "parent_d2h": parent_byte_mode_d2h(outs, len(corpora[0])),
               "output_rows": n_out, "seconds": elapsed, "carries": chain.carries,
               "redispatches": chain.redispatches, "cap_ratio": chain._cap_ratio,
               "link_counts": dict(chain.link_counts), "truth_s": truth_s}
    if name == "4_array_map" and chain.redispatches < 1:
        raise AssertionError("4_array_map: the first batch did not overflow the default capacity")
    log(f"slice chain {name}: {len(corpora)} x {len(corpora[0])} records in {elapsed:.3f} s = "
        f"{numbers['records_per_s']:.0f} records/s, {numbers['output_rows_per_s']:.0f} output "
        f"rows/s; every output equal to the interpreter ({n_out} rows; truth {truth_s:.1f} s); "
        f"carries {chain.carries}; re-dispatches {chain.redispatches}, learned ratio "
        f"{chain._cap_ratio:.4f}; H2D {chain.link_counts['h2d_bytes']} B, D2H "
        f"{chain.link_counts['d2h_bytes']} B; launches {launches}")
    ops = capture_torch_ops(lambda: chain.process_buffer(RecordBuffer.from_values(corpora[0])))
    return launches, numbers, ops


def phase_slice(json_corpora, names=tuple(SLICE_CHAINS)):
    """Every slice chain of ``names`` (`gen_json` batches for the
    aggregates, `gen_arrays` for the explode), then the device time of the
    torch ops they ran. Returns ({chain: numbers, launches included},
    torch op rows)."""
    numbers, captured = {}, {}
    array_corpora = (fork_map(lambda k: gen_arrays(N, seed=200 + k), list(range(SLICE_BATCHES)))
                     if "4_array_map" in names else None)
    for name in names:
        launches, numbers[name], captured[name] = phase_slice_chain(
            name, array_corpora if name == "4_array_map" else json_corpora)
        numbers[name]["launches"] = launches
    return numbers, torch_op_rows(captured)


def torch_op_rows(captured):
    """Device time and kernel launches of one call of each slice torch op
    at the main path's shapes (torch.profiler, every kernel of the call)."""
    rows = []
    for chain_name, ops in captured.items():
        for op, (fn, args) in ops.items():
            ms, launches = device_time(lambda: fn(*args), None, reps=5)
            rows.append({"op": op, "chain": chain_name, "device_ms": ms, "launches": launches})
            log(f"torch op {op} ({chain_name}): device {ms} ms, {launches} kernel launches a call")
    return rows


# bench.py's windowed configs at their published settings (BENCH_RECORDS
# 1,000,000; configs 11 and 12 take divisor 2), event time arange(n) * 4
# stamped at base 1,000,000 as bench._pack does; the bank and emit
# capacities default as the bench's spec leaves them (1,024), but for 12's
# emit of 4,096
WINDOWED = {
    "5_windowed": dict(records=1_000_000, batch=16384, spec=dict(window_ms=1000),
                       corpus="gen_ints"),
    "11_windowed_sliding": dict(records=500_000, batch=16384,
                                spec=dict(window_ms=1000, slide_ms=250), corpus="gen_ints"),
    "12_windowed_keyed": dict(records=500_000, batch=8192,
                              spec=dict(window_ms=1000, keyed=True, emit_capacity=4096),
                              corpus="gen_keyed_ints"),
}
WINDOW_TS_BASE = 1_000_000
WINDOW_SPACING_MS = 4
# the window update's torch code: its sub-functions in `windows.kernels`
WINDOW_TORCH_OPS = ("parse_int", "parse_two_ints", "_segment_merge", "compact_rows",
                    "segmented_scan")


def window_rows(values, ts, keyed: bool):
    """(key, contrib, ts) host rows of the bench's pure-ASCII int records,
    for the host reference."""
    if keyed:
        return [(int(v[: v.index(b" ")]), int(v[v.index(b" ") + 1:]), int(t))
                for v, t in zip(values, ts)]
    return [(0, int(v), int(t)) for v, t in zip(values, ts)]


def window_buffer(values, ts_delta):
    buf = RecordBuffer.from_values(values, base_timestamp=WINDOW_TS_BASE)
    buf.timestamp_deltas[: len(values)] = ts_delta
    return buf


def phase_windowed_config(name: str):
    """One windowed config's delta arm through ``WindowedRuntime(spec)`` on
    the card, as `bench._run_windowed_config` drives it: even batches, the
    bank against the host reference after every batch and the view's table
    at the end. Returns the run's numbers and the update's torch ops."""
    cfg = WINDOWED[name]
    spec = WindowSpec(**cfg["spec"])
    n = cfg["records"]
    values = getattr(shared_cases(), cfg["corpus"])(n)
    ts = np.arange(n, dtype=np.int64) * WINDOW_SPACING_MS
    n_batches = -(-n // cfg["batch"])
    per = -(-n // n_batches)
    slices = [(a, min(a + per, n)) for a in range(0, n, per)]
    rt = WindowedRuntime(spec)
    ref, view = HostWindowReference(spec), MaterializedView(spec)
    d2h_s = []
    download = window_engine._download

    def timed_download(*cols):
        t0 = time.perf_counter()
        out = download(*cols)
        d2h_s.append(time.perf_counter() - t0)
        return out

    bt, ref_s, deltas, ops = [], 0.0, [], {}

    def step(buf):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deltas.append(rt.process_buffer(buf))  # ends in the emit download
        bt.append(time.perf_counter() - t0)

    def step_capturing(buf):
        # a warm batch keeps the arguments of the update and of its torch
        # ops for the profile below (a dict entry a call: no device work)
        update = capture_torch_ops(lambda: step(buf), rt.ops, ("update_values",))
        ops.update(update=update["update_values"])

    window_engine._download = timed_download
    try:
        for k, (a, b) in enumerate(slices):
            buf = window_buffer(values[a:b], ts[a:b])
            if k == 1:
                ops.update(capture_torch_ops(lambda: step_capturing(buf), window_kernels,
                                             WINDOW_TORCH_OPS))
            else:
                step(buf)
            view.apply_delta(deltas[-1])
            t0 = time.perf_counter()
            ref.process_batch(window_rows(values[a:b], ts[a:b] + WINDOW_TS_BASE, spec.keyed))
            ref_s += time.perf_counter() - t0
            if rt.bank.snapshot() != ref.bank_entries():
                raise AssertionError(f"{name}: the device bank left the host reference at "
                                     f"record {b}")
    finally:
        window_engine._download = download
    if view.table() != ref.table():
        raise AssertionError(f"{name}: the materialized view differs from the host reference")
    if any(d.kind != "rows" for d in deltas):
        raise AssertionError(f"{name}: a batch fell back to a resync")
    warm = bt[1:] or bt
    delta_bytes = sum(d.delta_bytes for d in deltas)
    full_bytes = sum(d.full_bytes for d in deltas)
    numbers = {
        "spec": spec.describe(), "records": n, "batches": len(slices), "batch_records": per,
        "warm_records_per_s": per / statistics.median(warm),
        "first_batch_ms": bt[0] * 1e3,
        "warm_batch_ms_median": statistics.median(warm) * 1e3,
        "d2h_ms": sum(d2h_s) * 1e3, "d2h_ms_warm": sum(d2h_s[1:]) * 1e3,
        "h2d_bytes_per_record": rt.h2d_bytes_total / n,
        "delta_bytes": delta_bytes, "full_bytes": full_bytes,
        "delta_ratio": delta_bytes / full_bytes,
        "closed": sum(d.n_closed for d in deltas), "late": sum(d.n_late for d in deltas),
        "keys": len({k for k, _ in ref.table()}), "state_bytes": rt.bank.state_bytes(),
        "host_reference_s": ref_s,
        "update_enqueue_ms": update_enqueue_ms(*ops["update"]) if ops else None,
    }
    log(f"windowed {name}: {spec.describe()}, {n} records in {len(slices)} batches of {per}: "
        f"{numbers['warm_records_per_s']:.0f} records/s warm (median "
        f"{numbers['warm_batch_ms_median']:.3f} ms a batch), first batch "
        f"{numbers['first_batch_ms']:.3f} ms; d2h {numbers['d2h_ms']:.3f} ms; H2D "
        f"{numbers['h2d_bytes_per_record']:.3f} B a record; delta {delta_bytes} B vs full "
        f"{full_bytes} B (ratio {numbers['delta_ratio']:.6f}); host time to enqueue one "
        f"update {numbers['update_enqueue_ms']} ms; bank equal to the host "
        f"reference after every batch, view table equal ({len(ref.table())} windows; host "
        f"reference {ref_s:.1f} s)")
    return numbers, ops


def update_enqueue_ms(fn, args, reps: int = 9) -> float:
    """Median host time of one update call on the card, from the call to
    its return, before the device has run it (the enqueue of its kernels)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def classic_truth(values, ts_abs, window_ms: int):
    """The classic windowed-sum chain's outputs from the port's DSL
    interpreter: per record the running sum of its window (restarting at
    each window, wrapping as int64) and the window's start."""
    vals, keys = [], []
    acc, win = 0, None
    for v, t in zip(values, ts_abs):
        w = int(t) - int(t) % window_ms
        acc = (acc if w == win else 0) + dsl.parse_int_prefix(v)
        acc = (acc + 2**63) % 2**64 - 2**63
        win = w
        vals.append(str(acc).encode())
        keys.append(str(w).encode())
    return vals, keys


def phase_windowed_classic():
    """`5_windowed`'s classic arm: ``windowed-sum(kind=sum_int,
    window_ms=1000)`` through ``SmartEngine(device="cuda")`` over the
    config's 1,000,000 records as one batch; every output value and key
    against the interpreter. Returns its numbers."""
    cfg = WINDOWED["5_windowed"]
    n = cfg["records"]
    values = shared_cases().gen_ints(n)
    ts = np.arange(n, dtype=np.int64) * WINDOW_SPACING_MS
    specs = [("windowed-sum", {"kind": "sum_int", "window_ms": "1000"})]
    build_chain(specs).process_buffer(window_buffer(values[:4096], ts[:4096]))  # warm-up
    chain = build_chain(specs)
    buf = window_buffer(values, ts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chain.process_buffer(buf)
    elapsed = time.perf_counter() - t0
    want_vals, want_keys = classic_truth(values, ts + WINDOW_TS_BASE, 1000)
    if out.count != n or out.value_list() != want_vals or out.key_list() != want_keys:
        raise AssertionError("5_windowed classic arm: outputs differ from the interpreter")
    numbers = {"records": n, "records_per_s": n / elapsed, "seconds": elapsed,
               "h2d_bytes_per_record": chain.link_counts["h2d_bytes"] / n,
               "d2h_bytes_per_record": chain.link_counts["d2h_bytes"] / n}
    log(f"windowed 5_windowed classic arm: {n} records in one batch, {elapsed:.3f} s = "
        f"{numbers['records_per_s']:.0f} records/s; H2D {numbers['h2d_bytes_per_record']:.3f} "
        f"B, D2H {numbers['d2h_bytes_per_record']:.3f} B a record; every output value and key "
        "equal to the interpreter")
    return numbers


def phase_windowed():
    """The windowed-state engine: the three delta arms and `5_windowed`'s
    classic arm, then the device time and launches of one update of each
    config and of its torch ops (torch.profiler, every kernel of the
    call). Returns ({config: numbers}, torch op rows, CUDA kernel launches)."""
    cuda_kernels.reset_launches()
    numbers, captured = {}, {}
    for name in WINDOWED:
        numbers[name], captured[name] = phase_windowed_config(name)
    numbers["5_windowed_classic"] = phase_windowed_classic()
    launches = dict(cuda_kernels.LAUNCHES)
    return numbers, torch_op_rows(captured), launches


# bench.py's 9_partitioned (bench.py:211-225) at its published settings:
# BENCH_RECORDS 1,048,576 over divisor 2, round-robin into 4 partitions,
# placed ".*=spread" over 2 device groups
PARTITIONED = dict(records=N // 2, partitions=4, groups=2,
                   specs=[("regex-filter", {"regex": "fluvio"}),
                          ("aggregate-field", {"field": "n", "combine": "add"})])


def running_sums(values):
    """The aggregate's outputs over one partition's batch, from the host:
    the running sum of ``n`` over the records the filter keeps."""
    acc, out = 0, []
    for v in values:
        if b"fluvio" in v:
            acc += json.loads(v)["n"]
            out.append(str(acc).encode())
    return out


def phase_partitioned():
    """`9_partitioned` through ``PartitionRuntime`` on the card (the
    sequence is `run_partitioned` in ``tests/test_torch_isolation.py``);
    then one pass under the profiler and the same records through one
    executor's ``process_stream``. Returns (launches, the run's numbers)."""
    cfg, cases = PARTITIONED, shared_cases()
    parts = cfg["partitions"]
    values = cases.gen_json(cfg["records"])
    per_part = [values[p::parts] for p in range(parts)]
    t0 = time.perf_counter()
    bufs = [RecordBuffer.from_values(v) for v in per_part]
    stage_s = time.perf_counter() - t0
    truth = [cases.partitioned_truth(v) for v in per_part]
    keys = [partition_key("bench", p) for p in range(parts)]
    chain = build_chain(cfg["specs"])
    runtime = PartitionRuntime(chain, plan_placement(parse_placement_rules(".*=spread"), keys,
                                                     cfg["groups"]))
    plan_before = runtime.plan.to_dict()
    if len({runtime.device_of(g) for g in range(cfg["groups"])}) != 1:
        raise AssertionError("the device groups did not fold onto one card")
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    run = cases.run_partitioned(runtime, bufs, PartitionRebalancer, RebalanceConfig)
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    link = dict(chain.link_counts)  # the four passes'
    batches = 4 * parts
    if launches["json_span"] != batches or launches["extract"] != batches:
        raise AssertionError(f"9_partitioned: json_span and extract not launched once a batch "
                             f"({batches}): {launches}")

    def check(passes: int, when: str):
        for p in range(parts):
            got = runtime.carry_snapshot("bench", p)
            if got != [(passes * truth[p], 0, True)]:
                raise AssertionError(f"9_partitioned {when}: partition {p} carries {got}, host "
                                     f"truth {passes} x {truth[p]}")

    check(4, "after the move and the group failure")
    for p, out in enumerate(run["outs"][:parts]):
        if out.value_list() != running_sums(per_part[p]):
            raise AssertionError(f"9_partitioned: partition {p}'s first-pass outputs differ from "
                                 "the running sums")
    if any(out.values is not None for out in run["outs"]):
        raise AssertionError("9_partitioned: an output is not flat-backed")
    plan_after = runtime.plan.to_dict()
    moves = [(m["key"], m["from"], m["to"]) for m in run["moves"]]
    if (moves != [("bench/0", 0, 1)] or runtime.rebalances != 1 or runtime.moves != 1
            or plan_after["assignments"] != {k: 1 for k in keys}):
        raise AssertionError(f"9_partitioned: moves {moves}, plan {plan_after}")
    want_off = {k: 3 * len(per_part[0]) - 1 for k in keys}  # bench.py's commits from -1
    if runtime.offsets.snapshot() != want_off:
        raise AssertionError(f"9_partitioned: offsets {runtime.offsets.snapshot()}")

    # the swap's cost: the runtime's passes and one executor's
    # `process_stream` over the same buffers (no runtime), in turns after a
    # warm pass of each (a process's early passes run slower), then one
    # runtime pass under the profiler; every runtime pass is checked again
    stream = [("bench", p, buf) for p, buf in enumerate(bufs)]
    plain = build_chain(cfg["specs"])
    extra = [0]

    def runtime_pass():
        extra[0] += 1
        for _ in runtime.process_interleaved(list(stream)):
            pass

    def plain_pass():
        for _ in plain.process_stream(bufs):
            pass

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain_first_s = timed(plain_pass)
    turns = {runtime_pass: [], plain_pass: []}
    for fn in (runtime_pass, plain_pass, plain_pass, runtime_pass) * 2:
        turns[fn].append(timed(fn))
    busy_ms, busy_launches = device_time(runtime_pass, None, reps=1)
    check(4 + extra[0], f"after {extra[0]} more passes")
    plain._ensure_host_state()
    if plain.carries != [(5 * sum(truth), 0, True)]:
        raise AssertionError(f"9_partitioned without the runtime: carries {plain.carries}")

    n = cfg["records"]
    med = statistics.median(run["pass_s"])
    turn_med = statistics.median(turns[runtime_pass])
    plain_med = statistics.median(turns[plain_pass])
    numbers = {
        "records": n, "partitions": parts, "groups": cfg["groups"],
        "records_per_s": n / med, "pass_ms": [t * 1e3 for t in run["pass_s"]],
        "first_call_s": run["first_s"], "stage_s": stage_s,
        "h2d_bytes_per_record": link["h2d_bytes"] / (4 * n),
        "d2h_bytes_per_record": link["d2h_bytes"] / (4 * n),
        "plan_before": plan_before, "plan_after": plan_after,
        "rebalances": runtime.rebalances, "moves": runtime.moves,
        "offsets": runtime.offsets.snapshot(), "lags": run["lags"],
        "device_busy_ms": busy_ms, "device_launches": busy_launches,
        "device_busy_share": busy_ms / (turn_med * 1e3) if busy_ms else None,
        "turn_pass_ms": [t * 1e3 for t in turns[runtime_pass]],
        "plain_records_per_s": n / plain_med, "plain_pass_ms": [t * 1e3 for t in turns[plain_pass]],
        "plain_first_s": plain_first_s, "swap_overhead_ms": (turn_med - plain_med) * 1e3,
        "sums": truth,
    }
    log(f"9_partitioned: {n} records in {parts} partitions over {cfg['groups']} groups (one "
        f"card): {numbers['records_per_s']:.0f} records/s (median pass "
        f"{med * 1e3:.3f} ms; passes {[round(t, 3) for t in numbers['pass_ms']]}), first pass "
        f"{run['first_s']:.3f} s; H2D {numbers['h2d_bytes_per_record']:.3f} B, D2H "
        f"{numbers['d2h_bytes_per_record']:.3f} B a record; plan {plan_before['assignments']} -> "
        f"{plan_after['assignments']} (failed {plan_after['failed']}), rebalances "
        f"{runtime.rebalances}, moves {runtime.moves}; in turns with one executor's "
        f"process_stream (no runtime): {turn_med * 1e3:.3f} vs {plain_med * 1e3:.3f} ms a pass "
        f"({numbers['plain_records_per_s']:.0f} records/s without), swap overhead "
        f"{numbers['swap_overhead_ms']:.3f} ms a pass; device busy {busy_ms} ms a pass "
        f"({busy_launches} kernels and copies); every partition's sum equal to its host truth "
        f"x 4 (and x {4 + extra[0]} after {extra[0]} more passes); launches {launches}")
    return launches, numbers

# phase 12: byte mode's packed payload and its down link, and the striped
# aggregate and split explode over 71.7 KB records (bench.py's fat shape)
STRIPED_SLICE_BATCHES = 4
# D2H bytes a record that PR 10's smoke measured on `9_partitioned` before
# the packed payload (PERF.md, PR 10, call 18)
PR10_PARTITIONED_D2H = 7.625


def parent_byte_mode_d2h(outs, rows_in: int) -> float:
    """The D2H bytes a record of the parent's byte-mode download over the
    same outputs, by its arithmetic (not measured): the 5-column header,
    the mask, each batch's ``[rows, vw]`` decimal matrix and int32 lengths
    over the survivors' bucketed rows."""
    total = 0
    for out in outs:
        rows = _bucket_rows(max(out.count, 1))
        vw = 8
        while vw < max(int(out.lengths[: out.count].max(initial=1)), 1):
            vw <<= 1
        total += 40 + (rows_in + 7) // 8 + rows * (vw + 4)
    return total / (rows_in * len(outs))


def narrow_byte_mode(slice_numbers, part_numbers):
    """Part 1: the D2H bytes a record of the byte-mode chains of phases 9
    and 11, which now ship the packed payload (flat-backed outputs, checked
    there), beside the parent's figures."""
    out = {}
    for name in ("3_aggregate", "filter_aggregate"):
        num = slice_numbers[name]
        out[name] = {"d2h_bytes_per_record": num["link_counts"]["d2h_bytes"] / num["records"],
                     "parent_d2h_bytes_per_record_arithmetic": num["parent_d2h"]}
    out["9_partitioned"] = {"d2h_bytes_per_record": part_numbers["d2h_bytes_per_record"],
                            "pr10_d2h_bytes_per_record": PR10_PARTITIONED_D2H}
    for name, v in out.items():
        log(f"byte mode {name}: D2H {v['d2h_bytes_per_record']:.4f} B a record (packed payload); "
            f"before: {v.get('parent_d2h_bytes_per_record_arithmetic', PR10_PARTITIONED_D2H):.4f}"
            f" ({'PR 10 measured' if name == '9_partitioned' else 'parent layout, arithmetic'})")
    return out


def running_truth(corpus, combine: str, acc: int):
    """The interpreter's running ``combine`` of ``n`` over one batch from
    ``acc``: (outputs, the last accumulator)."""
    vals = []
    for x in fork_records(json_n, corpus):
        acc = max(acc, x) if combine == "max" else (acc + x + 2**63) % 2**64 - 2**63
        vals.append(str(acc).encode())
    return vals, acc


def phase_down_link(corpus):
    """Part 2: one batch of N `gen_json` records through a running max and
    through `3_aggregate` with the down link on; outputs against the
    interpreter. The max settles, so its payload's tokens must win and
    ship; `3_aggregate` logs the form it shipped."""
    cases = shared_cases()
    link = LinkParams(result_compress=True)
    numbers = {}
    buf = RecordBuffer.from_values(corpus)
    for name, specs, combine in (("down_link_max", cases.DOWN_LINK_MAX, "max"),
                                 ("down_link_3_aggregate", SLICE_CHAINS["3_aggregate"], "add")):
        build_chain(specs, link=link).process_buffer(RecordBuffer.from_values(corpus[:4096]))
        chain = build_chain(specs, link=link)
        torch.cuda.synchronize()
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        out = chain.process_buffer(buf)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        want, _ = running_truth(corpus, combine, kernels.INT64_MIN if combine == "max" else 0)
        if out.value_list() != want or out.values is not None:
            raise AssertionError(f"{name}: outputs differ from the interpreter or are not "
                                 "flat-backed")
        counts = dict(chain.link_counts)
        form = "down-glz" if counts["down-glz"] else "down-packed"
        if launches["glz_enc_match"] < 1 or (name == "down_link_max" and form != "down-glz"):
            raise AssertionError(f"{name}: shipped {form}, launches {launches}")
        numbers[name] = {"records_per_s": N / elapsed, "form": form, "link_counts": counts,
                         "d2h_bytes_per_record": counts["d2h_bytes"] / N, "launches": launches}
        log(f"{name}: {N} records in {elapsed:.3f} s = {N / elapsed:.0f} records/s with the down "
            f"link on; shipped {form}; D2H {counts['d2h_bytes'] / N:.4f} B a record; every output "
            f"equal to the interpreter; launches {launches}")
    return numbers


def striped_slice_truth(name: str, corpora):
    """Host truth of a striped slice chain, per batch: the running sums
    (continued across batches) with their records' offsets, or the split's
    elements of the records the filter keeps."""
    rx = re.compile(rb"flu[vV]io")
    outs, acc = [], 0
    for corpus in corpora:
        keep = [i for i, rec in enumerate(corpus) if rx.search(rec)]
        if name == "striped_explode":
            outs.append(([e for i in keep for e in corpus[i].split(b"\n") if e], keep))
            continue
        vals = []
        for i in keep:
            acc = (acc + dsl.parse_int_prefix(corpus[i]) + 2**63) % 2**64 - 2**63
            vals.append(str(acc).encode())
        outs.append((vals, keep))
    return outs, acc


def phase_striped_slice_chain(name: str, corpora):
    """Parts 3 and 4: a striped slice chain over the fat batches through
    ``process_stream``, against the interpreter; `dfa_compose.cu` must
    launch every batch."""
    specs = shared_cases().STRIPED_SLICE[name]
    build_chain(specs, FAT_PARAMS).process_buffer(RecordBuffer.from_values(corpora[0][:8]))
    chain = build_chain(specs, FAT_PARAMS)
    bufs = [RecordBuffer.from_values(c) for c in corpora]
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    outs = list(chain.process_stream(bufs))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    if launches["dfa_compose"] < len(corpora):
        raise AssertionError(f"{name}: dfa_compose not launched every batch: {launches}")
    if chain._striped is None:
        raise AssertionError(f"{name}: the chain did not run striped")
    truth, acc = striped_slice_truth(name, corpora)
    for k, ((vals, keep), out) in enumerate(zip(truth, outs)):
        if name == "striped_aggregate" or k == 0:
            if out.value_list() != vals:
                raise AssertionError(f"{name} batch {k}: outputs differ from the interpreter "
                                     f"({out.count} vs {len(vals)})")
        if name == "striped_aggregate":
            if out.offset_deltas[: out.count].tolist() != keep:
                raise AssertionError(f"{name} batch {k}: offsets differ from the survivors'")
        elif (out.count != len(vals)
              or int(out.lengths[: out.count].sum()) != sum(len(v) for v in vals)):
            raise AssertionError(f"{name} batch {k}: {out.count} rows, not {len(vals)}, or their "
                                 "bytes differ")
    chain._ensure_host_state()
    if name == "striped_aggregate" and chain.carries != [(acc, 0, True)]:
        raise AssertionError(f"{name}: carries {chain.carries}, host truth {acc}")
    if name == "striped_explode" and chain.redispatches < 1:
        raise AssertionError(f"{name}: the first batch did not overflow and run again")
    n_in = len(corpora) * len(corpora[0])
    n_out = sum(o.count for o in outs)
    nbytes = sum(len(r) for c in corpora for r in c)
    counts = dict(chain.link_counts)
    numbers = {"records_per_s": n_in / elapsed, "bytes_per_s": nbytes / elapsed,
               "output_rows_per_s": n_out / elapsed, "output_rows": n_out, "seconds": elapsed,
               "redispatches": chain.redispatches, "cap_ratio": chain._cap_ratio,
               "carries": chain.carries, "link_counts": counts,
               "d2h_bytes_per_record": counts["d2h_bytes"] / n_in, "launches": launches}
    log(f"{name}: {len(corpora)} x {len(corpora[0])} records of ~{nbytes // n_in} B in "
        f"{elapsed:.3f} s = {n_in / elapsed:.1f} records/s, {nbytes / elapsed / 1e9:.3f} GB/s, "
        f"{n_out / elapsed:.0f} output rows/s ({n_out} rows); exact against the interpreter; "
        f"re-dispatches {chain.redispatches}, learned ratio {chain._cap_ratio:.2f}; carries "
        f"{chain.carries}; H2D {counts['h2d_bytes']} B, D2H {counts['d2h_bytes']} B "
        f"({numbers['d2h_bytes_per_record']:.2f} a record); launches {launches}")
    return numbers


def phase_striped_slice(json_corpus, slice_numbers, part_numbers):
    """Phase 12: the narrow byte mode's D2H, its down link, and the striped
    aggregate and explode. Returns ({chain: numbers, launches included},
    the narrow byte mode's D2H table)."""
    cases = shared_cases()
    d2h = narrow_byte_mode(slice_numbers, part_numbers)
    numbers = phase_down_link(json_corpus)
    numbers["striped_aggregate"] = phase_striped_slice_chain(
        "striped_aggregate",
        [cases.gen_fat_numbers(FAT_RECORDS, seed=300 + k) for k in range(STRIPED_SLICE_BATCHES)])
    numbers["striped_explode"] = phase_striped_slice_chain(
        "striped_explode",
        [cases.gen_fat_lines(FAT_RECORDS, seed=400 + k) for k in range(STRIPED_SLICE_BATCHES)])
    return numbers, d2h


# phase 13: the broker's consume path (`bench.run_broker_e2e` below its
# socket): 1,048,576 `gen_json` records stored in 64 batches of 16,384,
# read in slices of whole batches up to 16 MiB
BROKER = dict(records=N, batch_records=16_384, first_timestamp=1_000_000, max_bytes=16 << 20,
              turns=3)
BROKER_CHAINS = {
    "north_star": None,  # the bench's two AdHoc payloads, from their wire invocations
    "flu_regex_filter": [("regex-filter", {"regex": "flu[vV]io"})],
    "3_aggregate": SLICE_CHAINS["3_aggregate"],
}
BROKER_PHASES = ("decompress", "decode", "stage", "dispatch", "finish", "encode")


def broker_chain(name: str):
    """A fresh chain instance on the card: the north star through the
    port's `build_chain` from its wire invocations, the others from the
    registry."""
    from fluvio_tpu_torch.spu import smart_chain

    if BROKER_CHAINS[name] is None:
        return smart_chain.build_chain(shared_cases().north_star_invocations(),
                                       SmartEngine(device="cuda"))
    b = SmartEngine(device="cuda").builder()
    for module, params in BROKER_CHAINS[name]:
        b.add_smart_module(SmartModuleConfig(params=dict(params)), lookup(module))
    return b.initialize()


@functools.lru_cache(maxsize=None)
def broker_values():
    """The stored log's values (phases 13 and 14)."""
    return gen_json(BROKER["records"], seed=2024)


@functools.lru_cache(maxsize=None)
def broker_truth(name: str):
    """Host truth of a broker chain over every stored record of
    `broker_values`, from the port's DSL interpreter: (output offsets i64,
    output lengths i64, the output values joined)."""
    values = broker_values()
    from fluvio_tpu_torch.smartmodule import load_source

    cases = shared_cases()
    offs, outs = [], []
    if name == "3_aggregate":
        acc = 0
        for i, x in enumerate(fork_records(json_n, values)):
            acc = (acc + x + 2**63) % 2**64 - 2**63
            offs.append(i)
            outs.append(str(acc).encode())
    else:
        def program(module, params):
            return dsl.resolve_params(module.dsl_program(module.transform_kind()), params)

        if name == "north_star":
            pred = program(load_source(cases.NORTH_STAR_FILTER_SM), {}).predicate
            value = program(load_source(cases.NORTH_STAR_MAP_SM), {"field": "name"}).value
        else:
            pred = program(lookup("regex-filter"), {"regex": "flu[vV]io"}).predicate
            value = None
        interp = fork_records(lambda rec: (rec if value is None else dsl.eval_expr(
            value, rec, None)) if dsl.eval_expr(pred, rec, None) else None, values)
        for i, out in enumerate(interp):
            if out is not None:
                offs.append(i)
                outs.append(out)
    return (np.array(offs, dtype=np.int64), np.array([len(o) for o in outs], dtype=np.int64),
            np.frombuffer(b"".join(outs), dtype=np.uint8))


def check_broker_pass(name: str, results, starts, truth, ts_of=None) -> int:
    """Hold one pass's output batches to host truth: each decoded with the
    port's codec (CRC checked), based at its slice's first offset, its
    last offset delta spanning the consumed range, the records (offsets,
    timestamps, no keys, values) equal to the truth's in that range; the
    slices cover the log. The timestamps are the stored log's: every
    record at ``BROKER["first_timestamp"]``, or ``ts_of[offset]`` (a
    produced log, a batch stamped as the producer sealed it). Returns the
    records checked."""
    from fluvio_tpu_torch.native import records as native_records
    from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter
    from fluvio_tpu_torch.protocol.record import Batch

    t_off, t_len, t_flat = truth
    t_start = np.concatenate([[0], np.cumsum(t_len)])
    checked = 0
    for k, (res, start) in enumerate(zip(results, starts)):
        if k and start != results[k - 1].next_offset:
            raise AssertionError(f"broker {name}: slice {k} starts at {start}, not "
                                 f"{results[k - 1].next_offset}")
        lo, hi = np.searchsorted(t_off, [start, res.next_offset])
        if hi == lo:
            if res.records.batches:
                raise AssertionError(f"broker {name}: slice {k} has output, the truth none")
            continue
        if len(res.records.batches) != 1:
            raise AssertionError(f"broker {name}: slice {k}: {len(res.records.batches)} batches")
        w = ByteWriter()
        res.records.batches[0].encode(w)
        batch = Batch.decode(ByteReader(w.bytes()), parse_records=False, check_crc=True)
        h = batch.header
        if (batch.base_offset != start or h.last_offset_delta != res.next_offset - 1 - start
                or (ts_of is None and h.first_timestamp != BROKER["first_timestamp"])):
            raise AssertionError(f"broker {name}: slice {k}: base {batch.base_offset}, last "
                                 f"delta {h.last_offset_delta}, first ts {h.first_timestamp} for "
                                 f"[{start}, {res.next_offset})")
        cols = native_records.decode_record_columns(batch.raw_records, align=1)
        want_flat = t_flat[t_start[lo]: t_start[hi]]
        ts_ok = (not cols["ts_delta"].any() if ts_of is None else np.array_equal(
            h.first_timestamp + cols["ts_delta"], ts_of[t_off[lo:hi]]))
        if (cols["count"] != hi - lo or cols["parsed"] != len(batch.raw_records)
                or not np.array_equal(cols["off_delta"] + start, t_off[lo:hi])
                or not np.array_equal(np.diff(cols["val_off"]), t_len[lo:hi])
                or not np.array_equal(cols["val_flat"], want_flat)
                or not ts_ok or cols["key_present"].any()):
            raise AssertionError(f"broker {name}: slice {k} [{start}, {res.next_offset}) differs "
                                 f"from host truth ({cols['count']} vs {hi - lo} records)")
        checked += hi - lo
    if results[-1].next_offset != BROKER["records"] or starts[0] != 0:
        raise AssertionError(f"broker {name}: the slices end at {results[-1].next_offset}")
    if checked != len(t_off):
        raise AssertionError(f"broker {name}: {checked} records checked, truth {len(t_off)}")
    return checked


def phase_broker():
    """Phase 13: the broker's consume path on the card. Each chain serves
    the log through `smart_chain.stream_slices` (slice k+1 staged and
    dispatched before slice k is finished and encoded, for stateless
    chains); a warm pass, then measured passes in turns with the same
    records through one ``process_stream`` (the engine-only way, staging
    included), every pass held to host truth. Returns ({chain: numbers},
    launches of one measured pass of each chain)."""
    from fluvio_tpu_torch.smartengine import SmartModuleChainMetrics
    from fluvio_tpu_torch.spu import smart_chain

    cfg, cases = BROKER, shared_cases()
    n = cfg["records"]
    values = broker_values()
    t0 = time.perf_counter()
    wires, batches = cases.broker_log(values, cfg["batch_records"], cfg["first_timestamp"])
    log_s = time.perf_counter() - t0
    read_slice = cases.slice_reader(wires, batches, cfg["max_bytes"])
    stored_bytes = sum(len(w) for w in wires)
    numbers, launches = {}, {}
    for name in BROKER_CHAINS:
        truth = broker_truth(name)
        chain = broker_chain(name)
        engine_chain = broker_chain(name).gpu_chain

        def consume(chain, metrics):
            starts, t_read = [], []

            def read(offset):
                starts.append(offset)
                t_read.append(time.perf_counter())
                return read_slice(offset)

            results, lat = [], []
            for res in smart_chain.stream_slices(chain, read, 0, n, cfg["max_bytes"], metrics):
                lat.append((time.perf_counter() - t_read[len(results)]) * 1e3)
                results.append(res)
            return results, starts, lat

        def engine_pass():
            buf = RecordBuffer.from_values(values)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = list(engine_chain.process_stream([buf]))
            torch.cuda.synchronize()
            return time.perf_counter() - t0, outs

        stateful = name == "3_aggregate"  # a fresh chain a pass: the sums restart
        metrics = SmartModuleChainMetrics()
        results, starts, _lat = consume(chain, metrics)  # warm
        check_broker_pass(name, results, starts, truth)
        engine_pass()
        consume_s, engine_s, lats, phases, d2h, h2d = [], [], [], {}, [], []
        for turn in range(cfg["turns"]):
            for way in (("consume", "engine") if turn % 2 == 0 else ("engine", "consume")):
                if way == "engine":
                    engine_chain = broker_chain(name).gpu_chain if stateful else engine_chain
                    dt, outs = engine_pass()
                    engine_s.append(dt)
                    if sum(o.count for o in outs) != len(truth[0]):
                        raise AssertionError(f"broker {name}: process_stream gave "
                                             f"{sum(o.count for o in outs)} records")
                    continue
                chain = broker_chain(name) if stateful else chain
                for k in chain.gpu_chain.link_counts:
                    chain.gpu_chain.link_counts[k] = 0
                torch.cuda.synchronize()
                if turn == 0:  # the main path's count: this pass's launches
                    cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                results, starts, lat = consume(chain, metrics)
                torch.cuda.synchronize()
                consume_s.append(time.perf_counter() - t0)
                if turn == 0:
                    launches[name] = dict(cuda_kernels.LAUNCHES)
                check_broker_pass(name, results, starts, truth)
                lats += lat
                for res in results:
                    for ph in BROKER_PHASES:
                        phases.setdefault(ph, []).append(res.phase_ms.get(ph, 0.0))
                h2d.append(chain.gpu_chain.link_counts["h2d_bytes"] / n)
                d2h.append(chain.gpu_chain.link_counts["d2h_bytes"] / n)
        if metrics.fallback_slices or metrics.fastpath_slices != (1 + cfg["turns"]) * len(starts):
            raise AssertionError(f"broker {name}: metrics {metrics.to_dict()}")
        chain = broker_chain(name)
        busy_ms, busy_launches = device_time(
            lambda: consume(chain, SmartModuleChainMetrics()), None, reps=1)
        # the engine-only staging the aligned decode replaces: the padded
        # batch from the values and its 4-aligned flat
        t0 = time.perf_counter()
        buf = RecordBuffer.from_values(values)
        buf.ragged_values()
        engine_stage_ms = (time.perf_counter() - t0) * 1e3
        med_c, med_e = statistics.median(consume_s), statistics.median(engine_s)
        slices = len(starts)
        numbers[name] = {
            "records": n, "stored_batches": len(batches), "stored_bytes": stored_bytes,
            "slices": slices,
            "records_per_s": n / med_c, "engine_records_per_s": n / med_e,
            "vs_engine_only": med_e / med_c,
            "pass_ms": [t * 1e3 for t in consume_s], "engine_pass_ms": [t * 1e3 for t in engine_s],
            "slice_latency_ms": {"p50": float(np.percentile(lats, 50)),
                                 "p99": float(np.percentile(lats, 99)), "all": lats},
            "host_ms_per_slice": {ph: statistics.median(v) for ph, v in phases.items()},
            "host_ms_per_pass": {ph: sum(v) / cfg["turns"] for ph, v in phases.items()},
            "engine_stage_ms": engine_stage_ms,
            "h2d_bytes_per_record": statistics.median(h2d),
            "d2h_bytes_per_record": statistics.median(d2h),
            "outputs": int(len(truth[0])), "fallback_slices": metrics.fallback_slices,
            "fastpath_slices": metrics.fastpath_slices,
            "device_busy_ms": busy_ms, "device_launches": busy_launches,
            "device_busy_share": busy_ms / (med_c * 1e3) if busy_ms else None,
            "launches": launches[name],
        }
        nb = numbers[name]
        log(f"broker {name}: {n} records in {len(batches)} stored batches ({stored_bytes} B), "
            f"{slices} slices a pass of <= {cfg['max_bytes']} B: {nb['records_per_s']:.0f} "
            f"records/s (median pass {med_c * 1e3:.3f} ms; passes "
            f"{[round(t, 3) for t in nb['pass_ms']]}), process_stream over the same records "
            f"{nb['engine_records_per_s']:.0f} records/s (passes "
            f"{[round(t, 3) for t in nb['engine_pass_ms']]}), vs_engine_only "
            f"{nb['vs_engine_only']:.4f}; slice latency p50 {nb['slice_latency_ms']['p50']:.3f} "
            f"p99 {nb['slice_latency_ms']['p99']:.3f} ms; host ms a slice "
            f"{ {k: round(v, 3) for k, v in nb['host_ms_per_slice'].items()} }; engine-only "
            f"staging {engine_stage_ms:.3f} ms a pass; H2D {nb['h2d_bytes_per_record']:.4f} B, "
            f"D2H {nb['d2h_bytes_per_record']:.4f} B a record; device busy {busy_ms} ms a pass "
            f"({busy_launches} kernels and copies); {nb['outputs']} outputs equal to the DSL "
            f"interpreter in every pass; fallback slices 0; launches {launches[name]}")
    log(f"broker log built in {log_s:.3f} s")
    return numbers, launches


# phase 14: the SPU server (`bench.run_broker_e2e` over its socket): phase
# 13's log written through the port's server, consumed by its client
SERVER_TURNS = 3


def server_results(batches):
    """The pushed batches as phase 13's pass results (`check_broker_pass`):
    each batch one slice, from its base offset to past its last offset
    delta. Every slice of these chains has output, so the slices still
    cover the log."""
    from types import SimpleNamespace

    from fluvio_tpu_torch.protocol.record import RecordSet

    results, starts = [], []
    for b in batches:
        records = RecordSet()
        records.add(b)
        results.append(SimpleNamespace(
            records=records, next_offset=b.base_offset + b.header.last_offset_delta + 1))
        starts.append(b.base_offset)
    return results, starts


def phase_server():
    """Phase 14: the port's SPU server on the card. The log of phase 13
    goes through `SpuServer` (the leader's ``write_record_set``) into
    files under a temporary directory; each chain is consumed through
    ``Fluvio.connect`` -> ``partition_consumer`` -> ``stream_batches`` with
    the bench's `ConsumerConfig` over a localhost socket (a warm pass,
    then measured passes in turns with phase 13's below-socket
    `stream_slices` and with ``process_stream`` over the same records),
    every pass held to host truth. Returns ({chain: numbers}, launches of
    one measured socket pass of each chain)."""
    import asyncio
    import tempfile

    from fluvio_tpu_torch.client import Fluvio
    from fluvio_tpu_torch.smartengine import SmartModuleChainMetrics
    from fluvio_tpu_torch.spu import smart_chain

    cfg, cases = BROKER, shared_cases()
    n = cfg["records"]
    values = broker_values()
    wires, batches = cases.broker_log(values, cfg["batch_records"], cfg["first_timestamp"])
    read_slice = cases.slice_reader(wires, batches, cfg["max_bytes"])
    numbers, launches = {}, {}

    async def run(log_dir):
        t0 = time.perf_counter()
        server = await cases.start_spu_server(log_dir, batches)  # on the card
        write_s = time.perf_counter() - t0
        client = await Fluvio.connect(server.public_addr)
        try:
            consumer = await client.partition_consumer("bench", 0)
            for name in BROKER_CHAINS:
                truth = broker_truth(name)
                config = cases.server_consumer_config(cases.server_invocations(name),
                                                      cfg["max_bytes"])
                stateful = name == "3_aggregate"
                below_chain = broker_chain(name)
                engine_chain = broker_chain(name).gpu_chain

                async def socket_pass():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got, arrivals = await cases.consume_once(consumer, config)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    results, starts = server_results(got)
                    check_broker_pass(name, results, starts, truth)
                    return dt, np.diff([t0] + arrivals) * 1e3, len(got)

                def below_pass():
                    chain = broker_chain(name) if stateful else below_chain
                    metrics = SmartModuleChainMetrics()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    starts, results = [], []

                    def read(offset):
                        starts.append(offset)
                        return read_slice(offset)

                    results = list(smart_chain.stream_slices(chain, read, 0, n, cfg["max_bytes"],
                                                             metrics))
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    check_broker_pass(name, results, starts, truth)
                    if metrics.fallback_slices:
                        raise AssertionError(f"server {name}: below-socket declines "
                                             f"{metrics.to_dict()}")
                    return dt

                def engine_pass():
                    chain = broker_chain(name).gpu_chain if stateful else engine_chain
                    buf = RecordBuffer.from_values(values)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs = list(chain.process_stream([buf]))
                    torch.cuda.synchronize()
                    if sum(o.count for o in outs) != len(truth[0]):
                        raise AssertionError(f"server {name}: process_stream gave "
                                             f"{sum(o.count for o in outs)} records")
                    return time.perf_counter() - t0

                t0 = time.perf_counter()
                await socket_pass()  # warm: the chain's first build and shapes
                warm_s = time.perf_counter() - t0
                below_pass()
                engine_pass()
                phases_from = len(server.ctx.metrics.slice_phases)
                socket_s, below_s, engine_s, gaps, slices = [], [], [], [], 0
                ways = ("socket", "below", "engine")
                for turn in range(SERVER_TURNS):
                    for way in ways[turn % 3:] + ways[:turn % 3]:
                        if way == "below":
                            below_s.append(below_pass())
                        elif way == "engine":
                            engine_s.append(engine_pass())
                        else:
                            if turn == 0:  # the main path's count: this pass's launches
                                cuda_kernels.reset_launches()
                            dt, gap, slices = await socket_pass()
                            if turn == 0:
                                launches[name] = dict(cuda_kernels.LAUNCHES)
                            socket_s.append(dt)
                            gaps += gap.tolist()
                phases = {}
                for ph in list(server.ctx.metrics.slice_phases)[phases_from:]:
                    for k, v in ph.items():
                        phases.setdefault(k, []).append(v)
                med_s, med_b, med_e = (statistics.median(x) for x in (socket_s, below_s, engine_s))
                numbers[name] = {
                    "records": n, "stored_batches": len(batches), "slices": slices,
                    "records_per_s": n / med_s, "below_socket_records_per_s": n / med_b,
                    "engine_records_per_s": n / med_e,
                    "vs_engine_only": med_e / med_s, "vs_below_socket": med_b / med_s,
                    "pass_ms": [t * 1e3 for t in socket_s],
                    "below_socket_pass_ms": [t * 1e3 for t in below_s],
                    "engine_pass_ms": [t * 1e3 for t in engine_s],
                    "warm_pass_s": warm_s,
                    # a few slices a pass: too few gaps for a p99, so the max
                    "inter_arrival_ms": {"p50": float(np.percentile(gaps, 50)),
                                         "max": float(max(gaps)), "gaps": len(gaps),
                                         "all": gaps},
                    "server_phase_ms_per_slice": {k: statistics.median(v)
                                                  for k, v in phases.items()},
                    "outputs": int(len(truth[0])),
                    "launches": launches[name],
                }
                nb = numbers[name]
                log(f"server {name}: {n} records in {len(batches)} stored batches over the "
                    f"socket, {slices} slices a pass of <= {cfg['max_bytes']} B: "
                    f"{nb['records_per_s']:.0f} records/s (passes "
                    f"{[round(t, 3) for t in nb['pass_ms']]} ms; warm pass {warm_s:.3f} s), "
                    f"below the socket {nb['below_socket_records_per_s']:.0f} records/s (passes "
                    f"{[round(t, 3) for t in nb['below_socket_pass_ms']]}), process_stream "
                    f"{nb['engine_records_per_s']:.0f} records/s (passes "
                    f"{[round(t, 3) for t in nb['engine_pass_ms']]}); vs_engine_only "
                    f"{nb['vs_engine_only']:.4f}, vs_below_socket {nb['vs_below_socket']:.4f}; "
                    f"batch inter-arrival p50 {nb['inter_arrival_ms']['p50']:.3f} ms, max "
                    f"{nb['inter_arrival_ms']['max']:.3f} ms of {len(gaps)} gaps; server ms a slice "
                    f"{ {k: round(v, 3) for k, v in nb['server_phase_ms_per_slice'].items()} }; "
                    f"{nb['outputs']} outputs equal to the DSL interpreter in every pass; "
                    f"launches {launches[name]}")
            m = server.ctx.metrics.smartmodule.to_dict()
            if m["fallback_slices"] or not m["fastpath_slices"]:
                raise AssertionError(f"server: chain metrics {m}")
            log(f"server: log of {n} records written through the leader in {write_s:.3f} s; "
                f"chain metrics {m}; outbound {server.ctx.metrics.outbound.to_dict()}")
        finally:
            await client.close()
            await server.stop()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-spu-") as log_dir:
        asyncio.run(run(log_dir))
    return numbers, launches


# phase 15: the cluster (the JAX package's `boot_cluster`, `tests/test_sc.py`):
# a port SC and one port SPU on the card, topics created through the admin
# API, phase 13's records produced through the SC-routed producer
# the 1 MiB-batch produce takes the first quarter of the records: cut from
# all of them when phase 20 came, to hold the smoke's time
CLUSTER = dict(records=N, turns=3, big_batch=1 << 20, big_records=N // 4, multi_partitions=2,
               key_space=4096)


def read_log(consumer, max_bytes: int):
    """A partition's whole log, read back plain through the client: the
    records' offsets, timestamps, key flags, lengths and values joined
    (the port's native decode of every pushed batch)."""
    from fluvio_tpu_torch.native import records as native_records
    from fluvio_tpu_torch.protocol.codec import ByteReader, ByteWriter
    from fluvio_tpu_torch.protocol.record import Batch

    async def run():
        cases = shared_cases()
        got, _ = await cases.consume_once(consumer, cases.server_consumer_config([], max_bytes))
        offs, ts, keys, lens, flats = [], [], [], [], []
        for b in got:
            w = ByteWriter()
            b.encode(w)
            batch = Batch.decode(ByteReader(w.bytes()), parse_records=False, check_crc=True)
            cols = native_records.decode_record_columns(batch.raw_records, align=1)
            offs.append(batch.base_offset + cols["off_delta"])
            ts.append(batch.header.first_timestamp + cols["ts_delta"])
            keys.append(cols["key_present"])
            lens.append(cols["val_len"])
            flats.append(cols["val_flat"])
        cat = lambda xs, t: np.concatenate(xs) if xs else np.zeros(0, t)  # noqa: E731
        return {"offsets": cat(offs, np.int64), "ts": cat(ts, np.int64),
                "keys": cat(keys, np.uint8), "lengths": cat(lens, np.int64),
                "flat": cat(flats, np.uint8)}

    return run()


def check_log(label: str, log, values) -> None:
    """The log read back holds exactly ``values``, at offsets 0.. in order."""
    want_len = np.array([len(v) for v in values], dtype=np.int64)
    if (not np.array_equal(log["offsets"], np.arange(len(values)))
            or not np.array_equal(log["lengths"], want_len)
            or not np.array_equal(log["flat"], np.frombuffer(b"".join(values), dtype=np.uint8))):
        raise AssertionError(f"cluster {label}: the stored log ({len(log['offsets'])} records) "
                             f"differs from the {len(values)} values produced")


@functools.lru_cache(maxsize=None)
def cluster_numbers():
    """Host truth's ``n`` of every `broker_values` record (the DSL's
    JsonGet and ParseInt, as `3_aggregate`'s chain reads it)."""
    return np.array(fork_records(json_n, broker_values()), dtype=np.int64)


def phase_cluster():
    """Phase 15: the cluster path on the card. A port `ScServer` and one
    port `SpuServer` (its SmartEngine on the card), registered through
    ``admin.register_custom_spu``; topics created through the admin API;
    phase 13's 1,048,576 records produced through
    ``Fluvio.connect(sc).topic_producer`` (``send_all``, ``flush``). Arms:
    (a) produce into ``bench`` with the default `ProducerConfig` and the
    first ``CLUSTER["big_records"]`` into ``bench-1m`` with 1 MiB batches;
    (b) the north star's two modules pushed by name, ``bench`` consumed by
    name through SC routing in turns with phase 14's direct-SPU consume
    (AdHoc invocations); (c)
    the records produced into ``bench-flu`` through a produce-side
    ``flu[vV]io`` filter by name (the SPU's ``handle_produce`` on the card);
    (d) ``multi`` (2 partitions) produced keyed and consumed merged through
    `3_aggregate`'s chain by name. Every arm held to host truth. Returns
    (numbers, launches of the main path's runs: (b)'s first SC pass, (c)'s
    produce and (d)'s consume)."""
    import asyncio
    import re as re_mod
    import tempfile
    import zlib

    from fluvio_tpu_torch.client import Fluvio, PartitionSelectionStrategy, ProducerConfig
    from fluvio_tpu_torch.client import Offset
    from fluvio_tpu_torch.client import producer as producer_mod
    from fluvio_tpu_torch.metadata.topic import TopicSpec

    t_phase = time.perf_counter()
    cfg, cases = CLUSTER, shared_cases()
    n = cfg["records"]
    values = broker_values()
    numbers, launches = {}, {}

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    async def produce(client, topic, items, config, label):
        """One produce arm: (records/s, batches of each produce request)."""
        requests = []
        send = producer_mod.PartitionProducer._send

        async def counted(self, pending):
            requests.append(len(pending))
            return await send(self, pending)

        producer_mod.PartitionProducer._send = counted
        try:
            torch.cuda.synchronize()
            wall0 = time.time()
            t0 = time.perf_counter()
            offsets = await cases.produce_all(client, topic, items, config)
            dt = time.perf_counter() - t0
            wall1 = time.time()
        finally:
            producer_mod.PartitionProducer._send = send
        numbers[label] = {"records": len(items), "records_per_s": len(items) / dt,
                          "seconds": dt, "requests": len(requests),
                          "batches_a_request": requests,
                          "wall_ms": (int(wall0 * 1000), int(wall1 * 1000) + 1)}
        return offsets

    async def run(log_dir):
        t0 = time.perf_counter()
        sc, admin, (spu,) = await cases.boot_torch_cluster(log_dir)  # the SPU on the card
        boot_s = time.perf_counter() - t0
        client = direct = None
        try:
            client = await Fluvio.connect(sc.public_addr)
            direct = await Fluvio.connect(spu.public_addr)
            for topic, parts in (("bench", 1), ("bench-1m", 1), ("bench-flu", 1),
                                 ("multi", cfg["multi_partitions"])):
                await admin.create_topic(topic, TopicSpec.computed(parts))
                await cases.wait_for_replicas(spu, topic, range(parts))
            pushed = {}
            for chain in ("north_star", "flu_regex_filter", "3_aggregate"):
                modules, pushed[chain] = cases.namespace_invocations(chain)
                for name, source in modules:
                    await admin.create_smartmodule(name, source)
                    await cases.wait_for_module(spu, name)

            # (a) produce, the default ProducerConfig and 1 MiB batches
            items = [(None, v) for v in values]
            big = ProducerConfig(batch_size=cfg["big_batch"])
            for topic, config, label, count in (
                    ("bench", None, "produce_default", n),
                    ("bench-1m", big, "produce_1mib", cfg["big_records"])):
                offsets = await produce(client, topic, items[:count], config, label)
                if offsets != [(0, i) for i in range(count)]:
                    raise AssertionError(f"cluster {label}: offsets are not 0..{count - 1} in "
                                         f"order")
                log_ = await read_log(await direct.partition_consumer(topic, 0),
                                      BROKER["max_bytes"])
                check_log(label, log_, values[:count])
                if label == "produce_default":
                    # (b) takes its expected timestamps from this log: each
                    # must be the producer's clock during the produce,
                    # never earlier than the record before it
                    lo, hi = numbers[label]["wall_ms"]
                    ts = log_["ts"]
                    if not (len(ts) and lo <= ts.min() and ts.max() <= hi
                            and (np.diff(ts) >= 0).all()):
                        raise AssertionError(f"cluster {label}: stored timestamps "
                                             f"[{ts.min()}, {ts.max()}] are not the producer's "
                                             f"clock [{lo}, {hi}] in order")
                    stored = log_
            lrs = await sc.ctx.partitions.wait_action(
                "bench-0", lambda o: o is not None and o.status.leader.leo == n, timeout=30)
            numbers["lrs_bench"] = {"spu": lrs.status.leader.spu, "hw": lrs.status.leader.hw,
                                    "leo": lrs.status.leader.leo}
            if (lrs.status.leader.hw, lrs.status.leader.leo) != (n, n):
                raise AssertionError(f"cluster: the SC's LRS for bench-0 is {lrs.status.leader}")

            # (b) consume by name through SC routing, in turns with direct
            truth = broker_truth("north_star")
            ways = {
                "sc": (await client.partition_consumer("bench", 0), pushed["north_star"]),
                "direct": (await direct.partition_consumer("bench", 0),
                           cases.server_invocations("north_star")),
            }

            async def consume_pass(way):
                consumer, invocations = ways[way]
                config = cases.server_consumer_config(invocations, BROKER["max_bytes"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, _ = await cases.consume_once(consumer, config)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                results, starts = server_results(got)
                check_broker_pass("cluster north_star", results, starts, truth, ts_of=stored["ts"])
                return dt

            for way in ways:  # warm
                await consume_pass(way)
            passes = {"sc": [], "direct": []}
            for turn in range(cfg["turns"]):
                for way in (("sc", "direct") if turn % 2 == 0 else ("direct", "sc")):
                    if turn == 0 and way == "sc":
                        cuda_kernels.reset_launches()
                    passes[way].append(await consume_pass(way))
                    if turn == 0 and way == "sc":
                        numbers["consume_launches"] = dict(cuda_kernels.LAUNCHES)
                        add_launches(cuda_kernels.LAUNCHES)
            med = {w: statistics.median(v) for w, v in passes.items()}
            numbers["consume_by_name"] = {
                "records": n, "sc_records_per_s": n / med["sc"],
                "direct_records_per_s": n / med["direct"], "sc_vs_direct": med["direct"] / med["sc"],
                "sc_pass_ms": [t * 1e3 for t in passes["sc"]],
                "direct_pass_ms": [t * 1e3 for t in passes["direct"]],
                "outputs": int(len(truth[0]))}

            # (c) produce through a produce-side flu[vV]io filter by name
            flu = re_mod.compile(rb"flu[vV]io")
            kept = [v for v in values if flu.search(v)]
            cuda_kernels.reset_launches()
            await produce(client, "bench-flu", items,
                          ProducerConfig(smartmodules=pushed["flu_regex_filter"]), "produce_flu")
            numbers["produce_flu"]["launches"] = dict(cuda_kernels.LAUNCHES)
            add_launches(cuda_kernels.LAUNCHES)
            check_log("produce_flu", await read_log(await direct.partition_consumer(
                "bench-flu", 0), BROKER["max_bytes"]), kept)
            numbers["produce_flu"]["stored"] = len(kept)

            # (d) two partitions, produced keyed, consumed merged through 3_aggregate
            keyed = [(b"key-%d" % (i % cfg["key_space"]), v) for i, v in enumerate(values)]
            offsets = await produce(client, "multi", keyed, None, "produce_multi")
            part = np.array([zlib.crc32(k) % cfg["multi_partitions"] for k, _ in keyed])
            if [p for p, _ in offsets] != part.tolist():
                raise AssertionError("cluster multi: records routed off their key's partition")
            merged = await client.consumer(PartitionSelectionStrategy.all("multi"))
            config = cases.server_consumer_config(pushed["3_aggregate"], BROKER["max_bytes"])
            got = {}
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            async for r in merged.stream(Offset.beginning(), config):
                got.setdefault(r.partition, []).append((r.offset, r.value))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            numbers["merged_aggregate"] = {"records": n, "records_per_s": n / dt, "seconds": dt,
                                           "launches": dict(cuda_kernels.LAUNCHES)}
            add_launches(cuda_kernels.LAUNCHES)
            nums = cluster_numbers()
            for p in range(cfg["multi_partitions"]):
                sums = np.cumsum(nums[part == p])  # n < 100,000: no wrap at 1 M records
                recs = got.get(p, [])
                if ([o for o, _ in recs] != list(range(len(sums)))
                        or [v for _, v in recs] != [str(x).encode() for x in sums.tolist()]):
                    raise AssertionError(f"cluster multi-{p}: {len(recs)} outputs differ from "
                                         f"the {len(sums)} running sums of host truth")
            numbers["merged_aggregate"]["by_partition"] = {p: len(v) for p, v in got.items()}
            numbers["boot_s"] = boot_s
            numbers["metrics"] = {"smartmodule": spu.ctx.metrics.smartmodule.to_dict(),
                                  "inbound": spu.ctx.metrics.inbound.to_dict()}
        finally:
            for c in (client, direct):
                if c is not None:
                    await c.close()
            await cases.shutdown_torch_cluster(sc, admin, [spu])

    with tempfile.TemporaryDirectory(prefix="chip-smoke-cluster-") as log_dir:
        asyncio.run(run(log_dir))
    log(f"cluster: SC and SPU booted in {numbers['boot_s']:.3f} s; the SC's LRS for bench-0 "
        f"after (a): {numbers['lrs_bench']}")
    for label in ("produce_default", "produce_1mib", "produce_flu", "produce_multi"):
        nb = numbers[label]
        log(f"cluster {label}: {nb['records']} records in {nb['seconds']:.3f} s, "
            f"{nb['records_per_s']:.0f} records/s; {nb['requests']} produce requests of "
            f"{nb['batches_a_request']} batches" + (
                f"; {nb['stored']} stored, launches {nb['launches']}" if "stored" in nb else ""))
    nb = numbers["consume_by_name"]
    log(f"cluster consume by name: through the SC {nb['sc_records_per_s']:.0f} records/s (passes "
        f"{[round(t, 3) for t in nb['sc_pass_ms']]} ms), direct to the SPU "
        f"{nb['direct_records_per_s']:.0f} records/s (passes "
        f"{[round(t, 3) for t in nb['direct_pass_ms']]} ms), sc_vs_direct "
        f"{nb['sc_vs_direct']:.4f}; {nb['outputs']} outputs equal to the DSL interpreter in every "
        f"pass; launches {numbers['consume_launches']}")
    nb = numbers["merged_aggregate"]
    log(f"cluster merged 3_aggregate over multi: {nb['records']} records in {nb['seconds']:.3f} s, "
        f"{nb['records_per_s']:.0f} records/s, by partition {nb['by_partition']}, every "
        f"partition's running sums equal to host truth; launches {nb['launches']}")
    log(f"cluster SPU metrics: {numbers['metrics']}")
    for k in ("json_span", "extract", "dfa_scan"):
        if not launches.get(k):
            raise AssertionError(f"cluster: kernel {k} never launched in phase 15")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"cluster: phase 15 took {numbers['phase_s']:.1f} s, host truth included")
    return numbers, launches


# phase 16: replication (the JAX package's replicated `boot_cluster`,
# `tests/test_replication.py:186-200`): a port SC and three port SPUs on
# the card, `repl` at replication factor 3, phase 13's records produced
# READ_COMMITTED, the leader's SPU stopped, the chains consumed from the
# promoted follower, the stopped SPU restarted as a follower
REPLICATION = dict(spus=3, timeout_ms=60_000, turns=3, wait_s=60.0)


def phase_replication():
    """Phase 16: replication on the card. A port `ScServer` and three port
    `SpuServer`s (ids 5000-5002, every SmartEngine on the card), ``repl``
    created with ``TopicSpec.computed(1, 3)``. (a) phase 13's 1,048,576
    records produced through the SC-routed producer with
    ``ProducerConfig(isolation=READ_COMMITTED, timeout_ms=60_000)``: every
    produce request answered with the leader's HW over its records, well
    before the timeout (the quorum of 3, not the timeout, ended its wait);
    the leader's HW = LEO = n, each follower's LEO = HW = n and its stored
    log the leader's bytes; the SC's LRS lists both followers at n, lsr 3.
    A cold and a warm north-star pass by name from this leader. (b) the leader's
    `SpuServer` stopped; the SC elects a follower and its SPU promotes the
    replica. (c) a fresh ``Fluvio.connect(sc)`` consumes by name from the
    new leader: the north star in turns with the direct-SPU consume
    (AdHoc), then ``flu[vV]io`` and ``3_aggregate``; every pass held to the
    DSL interpreter with 0 fallback slices. (d) the stopped SPU started
    again on its log directory with its id: a follower of the new leader,
    its LEO the leader's, listed in the SC's LRS. Returns (numbers,
    launches of (c)'s first pass of each chain)."""
    import asyncio
    import tempfile

    from fluvio_tpu_torch.client import Fluvio, ProducerConfig
    from fluvio_tpu_torch.client import producer as producer_mod
    from fluvio_tpu_torch.metadata.topic import TopicSpec
    from fluvio_tpu_torch.schema.spu import Isolation

    t_phase = time.perf_counter()
    cfg, cases = REPLICATION, shared_cases()
    values = broker_values()  # phase 13's records: n = BROKER["records"]
    n = len(values)
    truths = {name: broker_truth(name) for name in BROKER_CHAINS}
    numbers, launches = {}, {}

    async def until(predicate, what: str):
        deadline = time.perf_counter() + cfg["wait_s"]
        while not predicate():
            if time.perf_counter() > deadline:
                raise AssertionError(f"replication: {what} within {cfg['wait_s']} s")
            await asyncio.sleep(0.005)

    async def online(sc, not_leader=None):
        obj = await sc.ctx.partitions.wait_action(
            "repl-0", lambda o: o is not None and o.status.resolution.value == "online"
            and o.spec.leader != not_leader, timeout=cfg["wait_s"])
        if obj is None or obj.status.resolution.value != "online" or obj.spec.leader == not_leader:
            raise AssertionError(f"replication: repl-0 not online under a new leader ({obj})")
        return obj.spec.leader

    async def lrs(sc, replicas):
        want = sorted(replicas)

        def done(o):
            return (o is not None and o.status.leader.leo == n and o.status.lsr == 3
                    and sorted((r.spu, r.leo, r.hw) for r in o.status.replicas) == want)

        obj = await sc.ctx.partitions.wait_action("repl-0", done, timeout=cfg["wait_s"])
        if not done(obj):
            raise AssertionError(f"replication: the SC's LRS for repl-0 is {obj and obj.status}")
        st = obj.status
        return {"leader": [st.leader.spu, st.leader.hw, st.leader.leo], "lsr": st.lsr,
                "replicas": want}

    async def consume_pass(consumer, name, invocations, stored_ts):
        config = cases.server_consumer_config(invocations, BROKER["max_bytes"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, arrivals = await cases.consume_once(consumer, config)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results, starts = server_results(got)
        check_broker_pass(f"replication {name}", results, starts, truths[name], ts_of=stored_ts)
        return dt, arrivals

    async def run(log_dir):
        t0 = time.perf_counter()
        sc, admin, spus = await cases.boot_torch_cluster(log_dir, cfg["spus"])  # on the card
        numbers["boot_s"] = time.perf_counter() - t0
        live, clients = list(spus), []
        try:
            await admin.create_topic("repl", TopicSpec.computed(1, cfg["spus"]))
            first_id = await online(sc)
            first = next(s for s in spus if s.config.id == first_id)
            followers = [s for s in spus if s is not first]
            await until(lambda: first.ctx.leader_for("repl", 0) is not None and all(
                s.ctx.follower_for("repl", 0) is not None for s in followers), "replicas placed")
            leader = first.ctx.leader_for("repl", 0)
            if leader.in_sync_replica != cfg["spus"]:
                raise AssertionError(f"replication: quorum {leader.in_sync_replica}")
            pushed = {}
            for chain in BROKER_CHAINS:
                modules, pushed[chain] = cases.namespace_invocations(chain)
                for name, source in modules:
                    await admin.create_smartmodule(name, source)
                    for s in spus:
                        await cases.wait_for_module(s, name)
            client = await Fluvio.connect(sc.public_addr)
            clients.append(client)

            # (a) produce READ_COMMITTED at rf 3
            acks = []
            send = producer_mod.PartitionProducer._send

            async def acked(self, pending):
                t_req = time.perf_counter()
                await send(self, pending)
                acks.append({"batches": len(pending), "s": time.perf_counter() - t_req,
                             "hw": leader.hw(), "leo": leader.leo()})

            producer_mod.PartitionProducer._send = acked
            try:
                config = ProducerConfig(isolation=Isolation.READ_COMMITTED,
                                        timeout_ms=cfg["timeout_ms"])
                t0 = time.perf_counter()
                offsets = await cases.produce_all(client, "repl", [(None, v) for v in values],
                                                  config)
                produce_s = time.perf_counter() - t0
            finally:
                producer_mod.PartitionProducer._send = send
            lag = {s.config.id: leader.leo() - s.ctx.follower_for("repl", 0).leo()
                   for s in followers}
            if offsets != [(0, i) for i in range(n)]:
                raise AssertionError("replication: produce offsets are not 0..n-1 in order")
            for a in acks:
                if a["hw"] != a["leo"] or a["s"] >= cfg["timeout_ms"] / 1e3:
                    raise AssertionError(f"replication: a produce request was answered without "
                                         f"the quorum: {a}")
            if (leader.hw(), leader.leo()) != (n, n) or any(lag.values()):
                raise AssertionError(f"replication: after the produce the leader is at "
                                     f"{leader.hw()}/{leader.leo()}, the followers lag {lag}")
            await until(lambda: all(s.ctx.follower_for("repl", 0).hw() == n for s in followers),
                        "the followers' HW at n")
            t0 = time.perf_counter()
            stored_bytes = cases.replica_log(leader.storage)
            for s in followers:
                if cases.replica_log(s.ctx.follower_for("repl", 0).storage) != stored_bytes:
                    raise AssertionError(f"replication: SPU {s.config.id}'s log differs from the "
                                         "leader's bytes")
            compare_s = time.perf_counter() - t0
            numbers["lrs_after_produce"] = await lrs(sc, [(s.config.id, n, n) for s in followers])
            numbers["produce"] = {
                "records": n, "records_per_s": n / produce_s, "seconds": produce_s,
                "requests": len(acks), "batches_a_request": [a["batches"] for a in acks],
                "request_s": [a["s"] for a in acks], "follower_lag_at_end": lag,
                "log_bytes": len(stored_bytes), "compare_s": compare_s}
            stored = await read_log(await client.partition_consumer("repl", 0),
                                    BROKER["max_bytes"])
            check_log("replication repl", stored, values)
            consumer = await client.partition_consumer("repl", 0)
            before = [(await consume_pass(consumer, "north_star", pushed["north_star"],
                                          stored["ts"]))[0] for _ in range(2)]  # cold, warm
            numbers["north_star_before_failover"] = {
                "records_per_s": n / before[1], "pass_ms": [t * 1e3 for t in before]}

            # (b) failover
            t_stop = time.perf_counter()
            await first.stop()
            live.remove(first)
            new_id = await online(sc, not_leader=first.config.id)
            new = next(s for s in followers if s.config.id == new_id)
            await until(lambda: new.ctx.leader_for("repl", 0) is not None, "the promotion")
            elect_s = time.perf_counter() - t_stop
            promoted = new.ctx.leader_for("repl", 0)
            if (promoted.leo(), promoted.hw(), promoted.in_sync_replica) != (n, n, cfg["spus"]):
                raise AssertionError(f"replication: promoted at {promoted.leo()}/{promoted.hw()}, "
                                     f"quorum {promoted.in_sync_replica}")

            # (c) consume from the new leader through a fresh client, and direct
            fresh = await Fluvio.connect(sc.public_addr)
            clients.append(fresh)
            direct = await Fluvio.connect(new.public_addr)
            clients.append(direct)
            ways = {"sc": (await fresh.partition_consumer("repl", 0), pushed["north_star"]),
                    "direct": (await direct.partition_consumer("repl", 0),
                               cases.server_invocations("north_star"))}
            passes = {"sc": [], "direct": []}
            cuda_kernels.reset_launches()
            first_dt, arrivals = await consume_pass(ways["sc"][0], "north_star", ways["sc"][1],
                                                    stored["ts"])
            for k, v in cuda_kernels.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v
            failover_s = arrivals[0] - t_stop
            await consume_pass(ways["direct"][0], "north_star", ways["direct"][1],
                               stored["ts"])  # warm the direct way's chain (AdHoc)
            for turn in range(cfg["turns"]):
                for way in (("direct", "sc") if turn % 2 == 0 else ("sc", "direct")):
                    consumer, invocations = ways[way]
                    passes[way].append((await consume_pass(consumer, "north_star", invocations,
                                                           stored["ts"]))[0])
            med = {w: statistics.median(v) for w, v in passes.items()}
            numbers["north_star_after_failover"] = {
                "sc_records_per_s": n / med["sc"], "direct_records_per_s": n / med["direct"],
                "sc_pass_ms": [t * 1e3 for t in passes["sc"]],
                "direct_pass_ms": [t * 1e3 for t in passes["direct"]],
                "first_pass_ms": first_dt * 1e3, "outputs": int(len(truths["north_star"][0]))}
            for name in ("flu_regex_filter", "3_aggregate"):
                cuda_kernels.reset_launches()
                dt, _ = await consume_pass(ways["sc"][0], name, pushed[name], stored["ts"])
                for k, v in cuda_kernels.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
                numbers[name] = {"records_per_s": n / dt, "pass_ms": dt * 1e3,
                                 "outputs": int(len(truths[name][0]))}
            m = new.ctx.metrics.smartmodule.to_dict()
            if m["fallback_slices"] or not m["fastpath_slices"]:
                raise AssertionError(f"replication: the new leader's chain metrics {m}")
            numbers["failover"] = {"stopped_leader": first.config.id, "new_leader": new_id,
                                   "elect_s": elect_s, "to_first_batch_s": failover_s}
            numbers["chain_metrics"] = m

            # (d) the stopped SPU rejoins as a follower of the new leader
            t0 = time.perf_counter()
            back = await cases.restart_torch_spu(sc, first)
            live.append(back)
            await until(lambda: back.ctx.follower_for("repl", 0) is not None
                        and back.ctx.follower_for("repl", 0).leader == new_id
                        and back.ctx.follower_for("repl", 0).leo() == promoted.leo(),
                        "the rejoin")
            rejoin_follow_s = time.perf_counter() - t0
            numbers["lrs_after_rejoin"] = await lrs(sc, [(s.config.id, n, n) for s in spus
                                                         if s.config.id != new_id])
            numbers["rejoin"] = {"spu": back.config.id, "follows": new_id,
                                 "to_follower_at_leo_s": rejoin_follow_s,
                                 "to_lrs_s": time.perf_counter() - t0}
        finally:
            for c in clients:
                await c.close()
            await cases.shutdown_torch_cluster(sc, admin, live)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-replication-") as log_dir:
        asyncio.run(run(log_dir))
    p, f = numbers["produce"], numbers["failover"]
    log(f"replication: SC and 3 SPUs booted in {numbers['boot_s']:.3f} s; (a) {n} records "
        f"produced READ_COMMITTED at rf 3 in {p['seconds']:.3f} s, {p['records_per_s']:.0f} "
        f"records/s; {p['requests']} requests of {p['batches_a_request']} batches, answered in "
        f"{[round(s, 3) for s in p['request_s']]} s with the HW over their records; the "
        f"followers' lag behind the leader's LEO when the produce ended {p['follower_lag_at_end']}"
        f"; both followers' logs equal the leader's {p['log_bytes']} B; LRS "
        f"{numbers['lrs_after_produce']}; north star by name from this leader "
        f"{numbers['north_star_before_failover']['records_per_s']:.0f} records/s (cold, warm "
        f"pass {[round(t, 3) for t in numbers['north_star_before_failover']['pass_ms']]} ms)")
    nb = numbers["north_star_after_failover"]
    log(f"replication: (b) SPU {f['stopped_leader']} stopped, SPU {f['new_leader']} elected and "
        f"promoted in {f['elect_s']:.3f} s, the first consumed batch {f['to_first_batch_s']:.3f} "
        f"s after the stop (that pass, the new leader's first: {nb['first_pass_ms']:.3f} ms); "
        f"(c) north star from the new leader through the SC, in turns with direct, "
        f"{nb['sc_records_per_s']:.0f} records/s (passes "
        f"{[round(t, 3) for t in nb['sc_pass_ms']]} ms), direct "
        f"{nb['direct_records_per_s']:.0f} records/s (passes "
        f"{[round(t, 3) for t in nb['direct_pass_ms']]} ms); flu[vV]io "
        f"{numbers['flu_regex_filter']['records_per_s']:.0f}, 3_aggregate "
        f"{numbers['3_aggregate']['records_per_s']:.0f} records/s; every pass equal to the DSL "
        f"interpreter, chain metrics {numbers['chain_metrics']}; launches {launches}")
    r = numbers["rejoin"]
    log(f"replication: (d) SPU {r['spu']} restarted on its log, a follower of {r['follows']} at "
        f"the leader's LEO in {r['to_follower_at_leo_s']:.3f} s, in the SC's LRS in "
        f"{r['to_lrs_s']:.3f} s: {numbers['lrs_after_rejoin']}")
    for k in ("json_span", "extract", "dfa_scan"):
        if not launches.get(k):
            raise AssertionError(f"replication: kernel {k} never launched in phase 16")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"replication: phase 16 took {numbers['phase_s']:.1f} s, host truth included")
    return numbers, launches


# phase 17: the durable, secure cluster (the JAX package's `boot_cluster`,
# `tests/test_sc.py:282`, with `metadata_dir`, TLS and an RBAC policy):
# compressed topics produced over TLS survive an SC restart and are
# consumed through card chains
SECURE = dict(codecs=("lz4", "snappy"), turns=3, wait_s=30.0)


def stored_batches(raw: bytes):
    """The batches of a replica's stored bytes (`replica_log`), each as its
    own bytes: base offset i64, batch length i32, then that many bytes."""
    out, pos = [], 0
    while pos < len(raw):
        end = pos + 12 + int.from_bytes(raw[pos + 8:pos + 12], "big", signed=True)
        out.append(raw[pos:end])
        pos = end
    return out


def _python_decode_batch(wire: bytes):
    """One stored batch decoded with the pure-Python codecs (`lz4_py`,
    `snappy_py`; CRC checked): (codec, base offset, first timestamp, the
    record columns)."""
    from fluvio_tpu_torch.native import records as native_records
    from fluvio_tpu_torch.protocol import lz4_py, snappy_py
    from fluvio_tpu_torch.protocol.codec import ByteReader
    from fluvio_tpu_torch.protocol.compression import Compression
    from fluvio_tpu_torch.protocol.record import Batch

    batch = Batch.decode(ByteReader(wire), parse_records=False, check_crc=True)
    codec = batch.header.compression()
    plain = {Compression.LZ4: lz4_py, Compression.SNAPPY: snappy_py}[codec]
    cols = native_records.decode_record_columns(plain.decompress(batch.raw_records), align=1)
    return codec.name.lower(), batch.base_offset, batch.header.first_timestamp, cols


def check_compressed_log(topic: str, codec: str, wires, values):
    """Every stored batch of ``topic`` carries ``codec``; the log decoded
    with the pure-Python codec (forked workers) holds exactly ``values`` at
    offsets 0.. in order, no keys. Returns the stored timestamps a record."""
    parts = fork_map(lambda ws: [_python_decode_batch(w) for w in ws],
                     [wires[k:k + 64] for k in range(0, len(wires), 64)])
    decoded = [d for part in parts for d in part]
    codecs = {c for c, *_ in decoded}
    if codecs != {codec}:
        raise AssertionError(f"secure {topic}: stored batches carry {codecs}, not {codec}")
    log_ = {"offsets": np.concatenate([b + c["off_delta"] for _, b, _, c in decoded]),
            "lengths": np.concatenate([c["val_len"] for *_, c in decoded]),
            "flat": np.concatenate([c["val_flat"] for *_, c in decoded])}
    if any(c["key_present"].any() for *_, c in decoded):
        raise AssertionError(f"secure {topic}: a stored record has a key")
    check_log(f"secure {topic}", log_, values)
    return np.concatenate([t + c["ts_delta"] for _, _, t, c in decoded])


def phase_secure_cluster(cluster_numbers_=None):
    """Phase 17: the durable, secure cluster on the card. A port
    `ScServer` with TLS on its public endpoint (verified mode, the
    committed test certificates), ``metadata_dir`` in a temporary
    directory and ``auth_policy_path`` a policy under which the ``admins``
    certificate may do all and the ``viewers`` one may only read; one port
    `SpuServer` on the card with TLS on its public endpoint. Every client
    connects through ``Fluvio.connect()`` with no address, from a profile
    file the port's `ConfigFile` wrote. (a) ``bench-lz4`` and
    ``bench-snappy`` (``compression_type`` lz4 / snappy) take phase 13's
    1,048,576 records through the default `ProducerConfig`; every stored
    batch carries its codec, and each log decoded with the pure-Python
    codec equals the values; ``bench`` (no compression) takes phase 13's
    stored log through the leader. (b) the viewer's ``create_topic`` is
    refused (PERMISSION_DENIED, the JAX SC's code) and a plaintext client
    is refused by both TLS endpoints. (c) the SC stopped and started again
    on its metadata directory and addresses: the SPU registers again and
    shows online; topics, partitions with their leaders and the pushed
    SmartModules equal those before. (d) a fresh profile client consumes
    by name: the north star over ``bench-lz4``, ``bench-snappy`` and
    ``bench`` in turns, then ``flu[vV]io`` and ``3_aggregate`` over each
    compressed topic; every pass held to the DSL interpreter, 0 fallback
    slices. Returns (numbers, launches of (d))."""
    import asyncio
    import tempfile

    from fluvio_tpu_torch.client import AdminError, Fluvio
    from fluvio_tpu_torch.metadata.topic import TopicSpec
    from fluvio_tpu_torch.protocol.error import ErrorCode
    from fluvio_tpu_torch.protocol.record import RecordSet

    t_phase = time.perf_counter()
    cfg, cases = SECURE, shared_cases()
    values = broker_values()
    n = len(values)
    truths = {name: broker_truth(name) for name in BROKER_CHAINS}
    _wires, plain_batches = cases.broker_log(values, BROKER["batch_records"],
                                             BROKER["first_timestamp"])
    numbers, launches, raw_logs = {}, {}, {}

    def add_launches(label, counts):
        numbers.setdefault("launches", {})[label] = dict(counts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    async def consume_pass(consumer, topic, name, invocations, ts_of, spu):
        config = cases.server_consumer_config(invocations, BROKER["max_bytes"])
        phases_from = len(spu.ctx.metrics.slice_phases)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = await cases.consume_once(consumer, config)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results, starts = server_results(got)
        check_broker_pass(f"secure {topic} {name}", results, starts, truths[name], ts_of=ts_of)
        return dt, list(spu.ctx.metrics.slice_phases)[phases_from:]

    async def refused(coro) -> str:
        try:
            client = await asyncio.wait_for(coro, 10)
        except (ConnectionError, OSError, EOFError, asyncio.TimeoutError,
                asyncio.IncompleteReadError) as e:
            return type(e).__name__
        await client.close()
        raise AssertionError("secure: a plaintext client reached a TLS endpoint")

    async def run(work):
        t0 = time.perf_counter()
        sc, spu, profiles = await cases.boot_secure_torch_cluster(work)  # the SPU on the card
        numbers["boot_s"] = time.perf_counter() - t0
        try:
            client = await Fluvio.connect(config_path=profiles["admin"])
            try:
                admin = await client.admin()
                for topic, codec in [(f"bench-{c}", c) for c in cfg["codecs"]] + [("bench", None)]:
                    spec = TopicSpec.computed(1)
                    if codec:
                        spec.compression_type = codec
                    await admin.create_topic(topic, spec)
                    await cases.wait_for_replicas(spu, topic, [0])
                pushed = {}
                for chain in BROKER_CHAINS:
                    modules, pushed[chain] = cases.namespace_invocations(chain)
                    for name, source in modules:
                        await admin.create_smartmodule(name, source)
                        await cases.wait_for_module(spu, name)
                await admin.close()

                # (a) produce into the compressed topics; phase 13's log into bench
                for codec in cfg["codecs"]:
                    topic = f"bench-{codec}"
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    offsets = await cases.produce_all(client, topic, [(None, v) for v in values])
                    dt = time.perf_counter() - t0
                    if offsets != [(0, i) for i in range(n)]:
                        raise AssertionError(f"secure {topic}: offsets are not 0..{n - 1}")
                    leader = spu.ctx.leader_for(topic, 0)
                    raw_logs[topic] = cases.replica_log(leader.storage)
                    numbers[f"produce_{codec}"] = {"records": n, "seconds": dt,
                                                   "records_per_s": n / dt,
                                                   "stored_bytes": len(raw_logs[topic])}
                leader = spu.ctx.leader_for("bench", 0)
                for batch in plain_batches:
                    records = RecordSet()
                    records.add(batch)
                    await leader.write_record_set(records)
            finally:
                await client.close()
            stored_ts = {topic: check_compressed_log(topic, topic.split("-")[1],
                                                     stored_batches(raw), values)
                         for topic, raw in raw_logs.items()}
            stored_ts["bench"] = None  # phase 13's log: every record at its first timestamp

            # (b) the viewer may not create; plaintext clients are refused
            viewer = await Fluvio.connect(config_path=profiles["viewer"])
            try:
                vadmin = await viewer.admin()
                try:
                    await vadmin.create_topic("bench-viewer", TopicSpec.computed(1))
                    raise AssertionError("secure: the viewer's create_topic was accepted")
                except AdminError as e:
                    status = e.status
                finally:
                    await vadmin.close()
            finally:
                await viewer.close()
            if (status.error_code != ErrorCode.PERMISSION_DENIED
                    or "bench-viewer" in {o.key for o in sc.ctx.topics.store.values()}):
                raise AssertionError(f"secure: the viewer's create answered {status}")
            numbers["viewer_create"] = {"error_code": int(status.error_code),
                                        "error_name": status.error_code.name,
                                        "message": str(status.error_message)}
            numbers["plaintext"] = {"sc": await refused(Fluvio.connect(sc.public_addr)),
                                    "spu": await refused(Fluvio.connect(spu.public_addr))}

            # (c) the SC restarts on its metadata directory and addresses
            before = cases.cluster_snapshot(sc)
            t0 = time.perf_counter()
            sc = await cases.restart_secure_sc(sc, [spu.config.id], timeout=cfg["wait_s"])
            online_s = time.perf_counter() - t0
            deadline = time.perf_counter() + cfg["wait_s"]
            while cases.cluster_snapshot(sc) != before:
                if time.perf_counter() > deadline:
                    raise AssertionError(f"secure: after the restart the SC holds "
                                         f"{cases.cluster_snapshot(sc)}, before {before}")
                await asyncio.sleep(0.005)
            numbers["restart"] = {
                "to_spu_online_s": online_s, "to_metadata_equal_s": time.perf_counter() - t0,
                "topics": sorted(before["topics"]), "smartmodules": sorted(before["smartmodules"]),
                "leaders": {k: v[0]["leader"] for k, v in before["partitions"].items()}}

            # (d) a fresh profile client consumes every topic by name
            fresh = await Fluvio.connect(config_path=profiles["admin"])
            try:
                topics = [f"bench-{c}" for c in cfg["codecs"]] + ["bench"]
                consumers = {t: await fresh.partition_consumer(t, 0) for t in topics}
                passes, phases = {t: [] for t in topics}, {t: [] for t in topics}
                for t in topics:  # warm: each topic's first pass
                    await consume_pass(consumers[t], t, "north_star", pushed["north_star"],
                                       stored_ts[t], spu)
                for turn in range(cfg["turns"]):
                    for t in topics[turn % 3:] + topics[:turn % 3]:
                        if turn == 0:
                            cuda_kernels.reset_launches()
                        dt, ph = await consume_pass(consumers[t], t, "north_star",
                                                    pushed["north_star"], stored_ts[t], spu)
                        if turn == 0:
                            add_launches(f"north_star {t}", cuda_kernels.LAUNCHES)
                        passes[t].append(dt)
                        phases[t] += ph
                for t in topics:
                    numbers[f"north_star {t}"] = {
                        "records_per_s": n / statistics.median(passes[t]),
                        "pass_ms": [x * 1e3 for x in passes[t]],
                        "server_phase_ms_per_slice": {
                            k: statistics.median([p.get(k, 0.0) for p in phases[t]])
                            for k in ("read", "decompress", "decode", "stage", "dispatch",
                                      "finish", "encode", "push", "ack_wait")}}
                for name in ("flu_regex_filter", "3_aggregate"):
                    for t in topics[:-1]:
                        cuda_kernels.reset_launches()
                        dt, _ = await consume_pass(consumers[t], t, name, pushed[name],
                                                   stored_ts[t], spu)
                        add_launches(f"{name} {t}", cuda_kernels.LAUNCHES)
                        numbers[f"{name} {t}"] = {"records_per_s": n / dt, "pass_ms": dt * 1e3,
                                                  "outputs": int(len(truths[name][0]))}
            finally:
                await fresh.close()
            m = spu.ctx.metrics.smartmodule.to_dict()
            if m["fallback_slices"] or not m["fastpath_slices"]:
                raise AssertionError(f"secure: the SPU's chain metrics {m}")
            numbers["chain_metrics"] = m
        finally:
            await spu.stop()
            await sc.stop()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-secure-") as work:
        asyncio.run(run(Path(work)))
    log(f"secure: SC and SPU booted with TLS in {numbers['boot_s']:.3f} s; (a) "
        + "; ".join(f"{c}: {numbers[f'produce_{c}']['records_per_s']:.0f} records/s produced "
                    f"({numbers[f'produce_{c}']['seconds']:.3f} s, "
                    f"{numbers[f'produce_{c}']['stored_bytes']} B stored)"
                    for c in cfg["codecs"])
        + ", every stored batch in its codec, each log through the pure-Python codec equal "
          "to the values")
    log(f"secure: (b) the viewer's create_topic refused with {numbers['viewer_create']}; "
        f"plaintext clients refused by the SC ({numbers['plaintext']['sc']}) and the SPU "
        f"({numbers['plaintext']['spu']})")
    r = numbers["restart"]
    log(f"secure: (c) the SC restarted on its metadata directory, the SPU online again in "
        f"{r['to_spu_online_s']:.3f} s after the stop, the metadata equal in "
        f"{r['to_metadata_equal_s']:.3f} s: topics {r['topics']}, leaders {r['leaders']}, "
        f"SmartModules {r['smartmodules']}")
    for t in [f"bench-{c}" for c in cfg["codecs"]] + ["bench"]:
        nb = numbers[f"north_star {t}"]
        log(f"secure: (d) north star by name over {t}: {nb['records_per_s']:.0f} records/s "
            f"(passes {[round(x, 3) for x in nb['pass_ms']]} ms), server ms a slice "
            f"{ {k: round(v, 3) for k, v in nb['server_phase_ms_per_slice'].items()} }")
    for name in ("flu_regex_filter", "3_aggregate"):
        log(f"secure: (d) {name}: " + ", ".join(
            f"{t} {numbers[f'{name} {t}']['records_per_s']:.0f} records/s"
            for t in [f"bench-{c}" for c in cfg["codecs"]]))
    log(f"secure: every pass equal to the DSL interpreter, chain metrics "
        f"{numbers['chain_metrics']}; launches by arm {numbers['launches']}")
    if cluster_numbers_ is not None:
        log(f"secure beside the cluster: north star through the SC over bench-lz4 "
            f"{numbers['north_star bench-lz4']['records_per_s']:.0f}, bench-snappy "
            f"{numbers['north_star bench-snappy']['records_per_s']:.0f}, bench "
            f"{numbers['north_star bench']['records_per_s']:.0f} records/s; phase 15's (b) "
            f"{cluster_numbers_['consume_by_name']['sc_records_per_s']:.0f}")
    for k in ("json_span", "extract", "dfa_scan"):
        if not launches.get(k):
            raise AssertionError(f"secure: kernel {k} never launched in phase 17")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"secure: phase 17 took {numbers['phase_s']:.1f} s, host truth included")
    return numbers, launches


# phase 18: the pipeline telemetry (`fluvio_tpu_torch.telemetry`) and the
# SPU's monitoring socket while card chains serve a consumer
TELEMETRY_PHASE = dict(windowed_batches=8, overhead_batches=4, overhead_turns=3,
                       overhead_rounds=5, gate=0.02, gate_s=200e-6, slo_window_s=1.0,
                       seam_batches=20_000)


def telemetry_phase_config(profile_dir: str = ""):
    """Phase 18's `TelemetryConfig`: an SLO no batch can meet (``e2e_p99``
    under 1 µs) in windows of ``slo_window_s``, a breach capture of 200 ms
    into ``profile_dir`` ("" = none), one capture an hour."""
    from fluvio_tpu_torch.telemetry import TelemetryConfig

    return TelemetryConfig(slo="e2e_p99:target_ms=0.001",
                           slo_window_s=TELEMETRY_PHASE["slo_window_s"],
                           slo_profile_dir=profile_dir, slo_profile_ms=200.0,
                           slo_profile_cooldown_s=3600.0)


def telemetry_overhead_child() -> dict:
    """Run `telemetry_overhead` in a fresh interpreter (this script with
    ``--telemetry-overhead``) and return its document. The gate compares
    two arms of one process; the whole smoke's process carries the server
    threads and host state of phases 1–17, in which passes drift (PR 18:
    on 3–8 % slower in one whole smoke, 5 % faster in another), so the
    gate runs where only the headline chain runs, as the JAX gate's test
    process does."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--telemetry-overhead"],
                         capture_output=True, text=True, timeout=600, check=False)
    if out.returncode != 0:
        raise AssertionError(f"telemetry: the overhead run exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["telemetry_overhead"]


def telemetry_overhead(cfg):
    """The JAX package's gate (`tests/test_telemetry_overhead.py:79-103`)
    on the card: the headline chain's ``process_stream`` over
    ``overhead_batches`` x 1,048,576 records, telemetry on and off in turns
    (off first) after a warm pass of each, best of ``overhead_turns`` each.
    A round passes when capture costs at most ``gate`` of the off arm's
    time a batch or ``gate_s``; as in the JAX gate's loop, up to
    ``overhead_rounds`` rounds are measured, stopping at the first that
    passes. Returns (seconds a batch off, on, whether the round passed,
    every round's timed passes by arm)."""
    from dataclasses import replace

    from fluvio_tpu_torch import telemetry

    p = TELEMETRY_PHASE
    chain = build_chain(HEADLINE)
    buf = RecordBuffer.from_values(gen_json(N, seed=100))
    want = None

    def one_pass(enabled):
        nonlocal want
        telemetry.configure(replace(cfg, enabled=enabled))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = sum(o.count for o in chain.process_stream([buf] * p["overhead_batches"]))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / p["overhead_batches"]
        want = count if want is None else want
        if count != want:
            raise AssertionError(f"telemetry overhead: {count} outputs, then {want}")
        return dt

    rounds = []
    try:
        for enabled in (False, True):  # the warm pass of each
            one_pass(enabled)
        for _ in range(p["overhead_rounds"]):
            times = {False: [], True: []}
            for _turn in range(p["overhead_turns"]):
                for enabled in (False, True):
                    times[enabled].append(one_pass(enabled))
            rounds.append(times)
            off_s, on_s = min(times[False]), min(times[True])
            overhead = max(on_s - off_s, 0.0)
            ok = overhead <= off_s * p["gate"] or overhead < p["gate_s"]
            if ok:
                break
    finally:
        telemetry.configure(cfg)
    return off_s, on_s, ok, rounds


def telemetry_seam_cost() -> float:
    """Seconds a batch of capture's own calls, alone: the registry calls a
    fused batch makes on its way through the executor (the span, its phase
    laps, the dispatch and device-ready marks, the ledger's booking and
    release, the handle gauge, the link form, the span's end), made
    ``seam_batches`` times on this host with capture on."""
    from fluvio_tpu_torch.telemetry import TELEMETRY

    n = TELEMETRY_PHASE["seam_batches"]
    t0 = time.perf_counter()
    for k in range(n):
        span = TELEMETRY.begin_batch(chain="seam-cost")
        for phase in ("stage", "h2d", "stage", "h2d", "dispatch"):
            span.lap(phase, time.perf_counter())
        span.mark_dispatched()
        TELEMETRY.mem_acquire("staged_batch", ("seam-cost", k), 1 << 20)
        TELEMETRY.gauge_add("live_batch_handles", 1)
        span.mark_device_ready()
        span.lap("d2h", time.perf_counter())
        TELEMETRY.mem_release(("seam-cost", k))
        TELEMETRY.mem_release(("seam-cost-glz", k))
        TELEMETRY.gauge_add("live_batch_handles", -1)
        TELEMETRY.add_link_variant("raw")
        span.add("fetch", 1e-3)
        TELEMETRY.end_batch(span, records=N)
    return (time.perf_counter() - t0) / n


def phase_telemetry():
    """Phase 18: the port's telemetry while card chains serve a consumer.
    A port `SpuServer` on the card with its monitoring socket and a
    `TelemetryConfig` whose SLO no batch can meet (``e2e_p99`` under 1 µs,
    windows of 1 s, a breach capture into a temporary directory) serves
    phase 13's log (1,048,576 `gen_json` records, 64 stored batches) to the
    port's client with the bench's `ConsumerConfig`: the north star, then
    ``3_aggregate``, each held to host truth; the ``memory`` mode is read
    over the socket while the north star's batches are in flight, and once
    more with one dispatched batch held unfinished. Then
    ``5_windowed``'s first batches and one ``9_partitioned`` pass in the same
    process. Checks: every mode answers; every fused span has a
    ``device`` phase; the served records are the consumer's; lag 0 at the
    end; ``backend_bytes`` (the card's allocator) at least the ledger's;
    the ledger drained; one SLO capture holding CUDA kernel events; one
    build event a native library loaded; the window and carry banks'
    owners equal their bytes; the overhead gate. Returns (numbers,
    launches of the served passes)."""
    import asyncio
    import tempfile

    from fluvio_tpu_torch import telemetry
    from fluvio_tpu_torch.client import Fluvio
    from fluvio_tpu_torch.native import records as native_records
    from fluvio_tpu_torch.protocol import native_codecs
    from fluvio_tpu_torch.spu import monitoring
    from fluvio_tpu_torch.telemetry import TELEMETRY
    from fluvio_tpu_torch.telemetry import lag as lag_mod
    from fluvio_tpu_torch.telemetry import memory as memory_mod
    from fluvio_tpu_torch.telemetry import slo as slo_mod

    t_phase = time.perf_counter()
    p, bcfg, cases = TELEMETRY_PHASE, BROKER, shared_cases()
    values = broker_values()
    wires, batches = cases.broker_log(values, bcfg["batch_records"], bcfg["first_timestamp"])
    truths = {name: broker_truth(name) for name in ("north_star", "3_aggregate")}
    numbers, launches = {}, {}

    with tempfile.TemporaryDirectory(prefix="chip-smoke-telemetry-") as work:
        work = Path(work)
        cfg = telemetry_phase_config(str(work / "profiles"))
        # the build events of the libraries loaded so far, before the reset
        # that gives this phase its own counts
        builds_before = TELEMETRY.compile_totals()
        for reset in (TELEMETRY.reset, lag_mod.reset_engine, memory_mod.reset_engine,
                      slo_mod.reset_engine):
            reset()
        sock = str(work / "spu.sock")

        async def run():
            server = await cases.start_spu_server(work / "log", batches, topic="bench",
                                                  monitoring_path=sock, telemetry=cfg)
            client = await Fluvio.connect(server.public_addr)
            try:
                consumer = await client.partition_consumer("bench", 0)
                await monitoring.read_health(sock)  # the time series' first sample
                mid = []
                for name in truths:
                    config = cases.server_consumer_config(cases.server_invocations(name),
                                                          bcfg["max_bytes"])
                    cuda_kernels.reset_launches()
                    task = asyncio.ensure_future(cases.consume_once(consumer, config))
                    while not task.done():  # the ledger read while batches are in flight
                        doc = await monitoring.read_memory(sock)
                        # the reconcile's own ledger read (the document's
                        # total is read a moment later, as the JAX one's)
                        if doc["reconcile"]["ledger_bytes"]:
                            mid.append(doc)
                        await asyncio.sleep(0.01)
                    got, _arrivals = task.result()
                    torch.cuda.synchronize()
                    launches[name] = dict(cuda_kernels.LAUNCHES)
                    results, starts = server_results(got)
                    check_broker_pass(name, results, starts, truths[name])
                    numbers[f"{name}_outputs"] = sum(r.records.total_records() for r in results)
                # one dispatched batch held unfinished while the socket reads the ledger
                ex = broker_chain("north_star").gpu_chain
                held = RecordBuffer.from_values(values[: bcfg["batch_records"]])
                handle = ex.dispatch_buffer(held)
                in_flight = await monitoring.read_memory(sock)
                ex.finish_buffer(held, handle)
                await asyncio.sleep(p["slo_window_s"] * 1.2)  # past a window boundary
                docs = {}
                for mode in monitoring.MODES:
                    raw = await monitoring._read_mode(sock, mode)
                    if not raw:
                        raise AssertionError(f"telemetry: mode {mode} answered nothing")
                    docs[mode] = raw.decode() if mode == "prom" else json.loads(raw)
                legacy = json.loads(await monitoring._read_mode(sock, "no-such-mode"))
                return docs, mid, in_flight, legacy
            finally:
                await client.close()
                await server.stop()

        docs, mid, in_flight, legacy = asyncio.run(run())
        eng = slo_mod.engine()
        eng.join_profile_capture(timeout=60)
        captures = list(eng.profile_captures)
        refused = list(eng.profile_refused)
        if len(captures) != 1 or refused:
            raise AssertionError(f"telemetry: SLO captures {captures}, refused {refused}")
        trace_file = Path(captures[0]) / slo_mod.PROFILE_TRACE
        trace_doc = json.loads(trace_file.read_text())
        events = trace_doc["traceEvents"] if isinstance(trace_doc, dict) else trace_doc
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        if not kernel_events:
            raise AssertionError(f"telemetry: the SLO capture {trace_file} holds no CUDA kernel "
                                 "events")
        numbers["slo_capture"] = {"file": trace_file.name, "bytes": trace_file.stat().st_size,
                                  "kernel_events": len(kernel_events),
                                  "breaches": dict(TELEMETRY.slo_breaches)}

    # every mode answered; the documents' checks
    snap = docs["json"]["telemetry"]
    if set(legacy) != set(docs["json"]):
        raise AssertionError("telemetry: an unknown mode line did not answer the json document")
    fused = [s for s in docs["spans"] if s["path"] == "fused"]
    if not fused or any(s["phases_ms"].get("device", 0) <= 0 for s in fused):
        raise AssertionError(f"telemetry: a fused span without a device phase: {fused[:2]}")
    served = snap["lag"]["served_records"]
    want_served = {"filter+map@bench/0": numbers["north_star_outputs"],
                   "aggregate@bench/0": numbers["3_aggregate_outputs"]}
    if served != want_served:
        raise AssertionError(f"telemetry: served {served}, the consumer's {want_served}")
    parts = docs["lag"]["partitions"]
    if set(parts) != set(want_served) or any(v["lag"] != 0 for v in parts.values()):
        raise AssertionError(f"telemetry: lag at the end {parts}")
    recon = in_flight["reconcile"]
    if (in_flight["total_bytes"] <= 0 or "backend_bytes" not in recon
            or recon["backend_bytes"] < recon["ledger_bytes"]):
        raise AssertionError(f"telemetry: the ledger read with a batch in flight: {recon}")
    mid_ok = [d for d in mid if d["reconcile"].get("backend_bytes", -1)
              >= d["reconcile"]["ledger_bytes"]]
    if len(mid_ok) != len(mid):
        raise AssertionError(f"telemetry: a mid-pass ledger read below its ledger: {mid}")
    memory_mod.engine().assert_drained()
    if docs["memory"]["reconcile"].get("backend_bytes") is None:
        raise AssertionError(f"telemetry: memory mode {docs['memory']['reconcile']}")
    numbers["memory"] = {
        "in_flight": recon, "mid_pass_reads": len(mid),
        "mid_pass_max_ledger_bytes": max((d["reconcile"]["ledger_bytes"] for d in mid),
                                         default=0),
        "mid_pass_unaccounted_bytes": [d["reconcile"]["unaccounted_bytes"] for d in mid][:8],
        "peak_bytes": docs["memory"]["peak_bytes"], "end": docs["memory"]["reconcile"]}
    numbers["modes_bytes"] = {m: len(d if isinstance(d, str) else json.dumps(d))
                              for m, d in docs.items()}
    numbers["spans"] = {"fused": len(fused), "total": snap["spans_total"],
                        "flows": snap["flows_total"]}
    numbers["phases_ms_per_span"] = {
        ph: statistics.median(s["phases_ms"].get(ph, 0.0) for s in fused)
        for ph in ("stage", "h2d", "dispatch", "device", "d2h", "fetch")}
    numbers["health_verdict"] = docs["health"]["verdict"]
    if docs["health"]["verdict"] != "breach":
        raise AssertionError(f"telemetry: health {docs['health']['verdict']} under an SLO no "
                             "batch meets")

    # 5_windowed's first batches and one 9_partitioned pass, same process
    wcfg = WINDOWED["5_windowed"]
    win_values = shared_cases().gen_ints(p["windowed_batches"] * wcfg["batch"])
    wrt = WindowedRuntime(WindowSpec(**wcfg["spec"]))
    for k in range(p["windowed_batches"]):
        lo = k * wcfg["batch"]
        vals = win_values[lo: lo + wcfg["batch"]]
        wrt.process_buffer(window_buffer(vals, (np.arange(len(vals)) + lo) * WINDOW_SPACING_MS))
    owners = memory_mod.engine().owner_bytes()
    if owners["window_bank"] != wrt.bank.state_bytes() or owners["emit_buffer"]:
        raise AssertionError(f"telemetry: window ledger {owners}, bank "
                             f"{wrt.bank.state_bytes()}")
    win_spans = [s for s in TELEMETRY.spans_json() if s["path"] == "windowed"]
    closed, deltas, _db, _fb = TELEMETRY.window_counts()
    if len(win_spans) != p["windowed_batches"] or closed <= 0:
        raise AssertionError(f"telemetry: windowed spans {len(win_spans)}, closed {closed}")
    pcfg = PARTITIONED
    parts_n = pcfg["partitions"]
    pvalues = cases.gen_json(pcfg["records"])
    keys = [partition_key("bench", q) for q in range(parts_n)]
    runtime = PartitionRuntime(build_chain(pcfg["specs"]),
                               plan_placement(parse_placement_rules(".*=spread"), keys,
                                              pcfg["groups"]))
    leaders = [cases._Leader() for _ in keys]
    pbufs = [RecordBuffer.from_values(pvalues[q::parts_n]) for q in range(parts_n)]
    for key, leader, buf in zip(keys, leaders, pbufs):
        runtime.offsets.attach_leader(key, leader)
        leader.end = buf.count
    for t, q, buf, _out in runtime.process_interleaved([("bench", q, b) for q, b in
                                                         enumerate(pbufs)]):
        runtime.offsets.advance(f"{t}/{q}", buf.count)
    carry = memory_mod.engine().owner_bytes()["carry_bank"]
    if carry != 17 * parts_n:
        raise AssertionError(f"telemetry: carry_bank {carry} B, the carries' {17 * parts_n}")
    lags = PartitionRebalancer(lambda: runtime.plan, lambda *a: True)._lag_by_plan_key()
    if lags != {k: 0.0 for k in keys}:
        raise AssertionError(f"telemetry: the rebalancer's default lag reader read {lags}")
    memory_mod.engine().assert_drained()
    numbers["windowed"] = {"spans": len(win_spans), "closed": closed, "deltas": deltas,
                           "window_bank_bytes": owners["window_bank"]}
    numbers["partitioned"] = {"carry_bank_bytes": carry, "lags": lags}

    # one build event a native library this process loaded
    loaded = {"nvcc": len(SIGNATURES) if KERNELS._entries else 0,
              "g++": sum(m._lib is not None for m in (native_records, native_codecs, glz))}
    after = TELEMETRY.compile_totals()
    by_kind = {k: builds_before["by_kind"].get(k, 0) + after["by_kind"].get(k, 0)
               for k in ("nvcc", "g++")}
    outcomes = sum(builds_before[k] + after[k] for k in ("persistent_hits", "persistent_misses"))
    if by_kind != loaded or outcomes != sum(loaded.values()):
        raise AssertionError(f"telemetry: build events {by_kind} ({outcomes} outcomes), "
                             f"libraries loaded {loaded}")
    numbers["builds"] = {"by_kind": by_kind, "cached": builds_before["persistent_hits"]
                         + after["persistent_hits"]}

    # capture's own calls timed alone, in this process's state, then the
    # overhead gate in rounds as the JAX package's, in a fresh process
    import threading

    numbers["threads"] = sorted(t.name for t in threading.enumerate())
    seam_s = telemetry_seam_cost()
    gate = telemetry_overhead_child()
    off_s, on_s, rounds = gate["off_s"], gate["on_s"], gate["rounds"]
    for k, times in enumerate(rounds):
        log(f"telemetry: overhead round {k + 1}, ms a batch a pass: off "
            f"{[round(t * 1e3, 3) for t in times['off']]}, on "
            f"{[round(t * 1e3, 3) for t in times['on']]}")
    overhead = max(on_s - off_s, 0.0)
    batch = N
    numbers["overhead"] = {"off_ms_per_batch": off_s * 1e3, "on_ms_per_batch": on_s * 1e3,
                           "off_records_per_s": batch / off_s, "on_records_per_s": batch / on_s,
                           "overhead_us_per_batch": overhead * 1e6,
                           "overhead_share": overhead / off_s, "rounds": len(rounds),
                           "passes_ms": [{arm: [t * 1e3 for t in times[arm]]
                                          for arm in ("off", "on")} for times in rounds],
                           "seam_us_per_batch": seam_s * 1e6}
    if seam_s >= p["gate_s"]:
        raise AssertionError(f"telemetry: capture's calls alone take {seam_s * 1e6:.1f} us a "
                             f"batch, above the gate's {p['gate_s'] * 1e6:.0f} us")
    if not gate["ok"]:
        raise AssertionError(f"telemetry: overhead {overhead * 1e6:.0f} us a batch on a "
                             f"{off_s * 1e3:.2f} ms batch exceeds the gate in each of "
                             f"{len(rounds)} rounds")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"telemetry: every mode answered ({numbers['modes_bytes']}); {len(fused)} fused spans, "
        f"each with a device phase (median ms a span "
        f"{ {k: round(v, 3) for k, v in numbers['phases_ms_per_span'].items()} }); served "
        f"{served} equal to the consumer's; lag 0; memory with a batch in flight: ledger "
        f"{recon['ledger_bytes']} B, the card's allocator {recon['backend_bytes']} B, "
        f"unaccounted {recon['unaccounted_bytes']} B; {len(mid)} mid-pass reads, the largest "
        f"ledger {numbers['memory']['mid_pass_max_ledger_bytes']} B; drained; SLO breach capture "
        f"{numbers['slo_capture']}; builds {numbers['builds']}; windowed "
        f"{numbers['windowed']}; partitioned {numbers['partitioned']}")
    o = numbers["overhead"]
    log(f"telemetry: overhead of capture on the headline chain's process_stream "
        f"({p['overhead_batches']} x {N} records, best of {p['overhead_turns']} in turns): off "
        f"{o['off_records_per_s']:.0f} records/s ({o['off_ms_per_batch']:.3f} ms a batch), on "
        f"{o['on_records_per_s']:.0f} ({o['on_ms_per_batch']:.3f} ms), "
        f"{o['overhead_us_per_batch']:.1f} us a batch ({o['overhead_share'] * 100:.3f} %), "
        f"{o['rounds']} round(s); capture's calls alone {o['seam_us_per_batch']:.1f} us a "
        f"batch; phase 18 took {numbers['phase_s']:.1f} s")
    return numbers, {k: sum(v[k] for v in launches.values()) for k in cuda_kernels.LAUNCHES}


# phase 19: admission (`fluvio_tpu_torch.admission`) behind the port's SPU
# server and its pipeline, on phase 13's log
ADMISSION_PHASE = dict(tenants=4, token_tokens=1.0, token_refill=1.0, breach_window_s=0.25,
                       breach_windows=4, breach_refresh_s=0.05, pipeline_rows=65_536)
# the phase's SLO rules: the defaults but the two that judge a replayed
# backlog, which would shed the consumers for reasons (a), (b) and (d) do
# not test: consumer_lag (a consumer starting 1,048,576 records behind
# breaches its 65,536-record target by design) and record_age_p99 (records
# appended at the phase's start); (c) arms record_age_p99 alone, at 1 ms
ADMISSION_SLO = "consumer_lag:off=1;record_age_p99:off=1"


def first_slice(server, since: int) -> dict:
    """The host phases (ms) of the first slice ``server`` pushed after its
    first ``since``, and their sum without the ack wait."""
    phases = dict(list(server.ctx.metrics.slice_phases)[since])
    return {"ms": sum(v for k, v in phases.items() if k != "ack_wait"), "phases": phases}


def phase_admission():
    """Phase 19: admission on the card. Phase 13's log (1,048,576 `gen_json`
    records in 64 stored batches of 16,384, stamped with the wall clock so
    the default record-age rule holds) behind the port's `SpuServer`:

    (a) the serve gate's warm-up: the north star, then ``3_aggregate``,
        served by a server with ``AdmissionConfig(enabled=True)`` (only the
        2-record warm of a fresh stateless chain), then by a fresh server
        with ``AdmissionConfig(enabled=True, warmup=True)``: each consumer
        arrives while its fresh chain warms, is held ``cold-chain``, then
        served; no warm-up error and no build event but the warms'; each
        chain's first slice (server ms, and the client's ms to its first
        batch) warmed against not warmed, the allocator emptied first;
    (b) token shed, on the second server: four tenants (topics
        ``t0.bench`` .. ``t3.bench``, the same log), four consumers at once
        of the north star and ``flu[vV]io`` under a controller of 1 token
        refilled 1 a second: ``no-tokens`` sheds, held flows with their
        hold, every tenant held, ``held_slices`` back at 0;
    (c) breach shed: a ``record_age_p99`` target of 1 ms in 4 windows of
        0.25 s; a consumer served with the gate disarmed breaches it, then
        the next consumer of the same chain and partition is shed
        ``breach-shed`` until the windows age out, and served;
    (d) the pipeline: `AdmissionPipeline` (batcher row target 65,536)
        takes the four tenants' 16,384-record slices of the north star
        (the 64 stored batches), coalesces them into the buckets a
        warm-up warmed (no ``cold-bucket``), and each tenant's outputs,
        split back, equal host truth.

    Every consumer's records are held to host truth (contiguous offsets,
    no duplicates). Returns (numbers, launches of (a)-(d))."""
    import asyncio
    import random
    import tempfile
    from collections import Counter

    from fluvio_tpu_torch import admission, telemetry
    from fluvio_tpu_torch.admission import AdmissionConfig
    from fluvio_tpu_torch.admission import warmup as adm_warmup
    from fluvio_tpu_torch.client import Fluvio
    from fluvio_tpu_torch.native import records as native_records
    from fluvio_tpu_torch.telemetry import TELEMETRY, TelemetryConfig
    from fluvio_tpu_torch.telemetry import slo as slo_mod

    t_phase = time.perf_counter()
    p, bcfg, cases = ADMISSION_PHASE, BROKER, shared_cases()
    values = broker_values()
    n = len(values)
    truths = {name: broker_truth(name) for name in ("north_star", "flu_regex_filter",
                                                     "3_aggregate")}
    now_ms = int(time.time() * 1000)
    wires, batches = cases.broker_log(values, bcfg["batch_records"], now_ms)
    ts_of = np.full(n, now_ms, dtype=np.int64)
    numbers, launches = {}, {}
    telemetry.configure(TelemetryConfig(slo=ADMISSION_SLO))
    TELEMETRY.reset()
    adm_warmup.reset_warm_registry()

    def counts(reason: str) -> int:
        return TELEMETRY.admission.get(reason, 0)

    async def consume(addr, topic: str, name: str, max_bytes: int = bcfg["max_bytes"]):
        """One pass held to host truth: (s, s to the first batch, batches)."""
        client = await Fluvio.connect(addr)
        try:
            consumer = await client.partition_consumer(topic, 0)
            config = cases.server_consumer_config(cases.server_invocations(name), max_bytes)
            t0 = time.perf_counter()
            got, arrivals = await cases.consume_once(consumer, config)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            await client.close()
        results, starts = server_results(got)
        check_broker_pass(f"admission {name} on {topic}", results, starts, truths[name], ts_of)
        return dt, arrivals[0] - t0, len(got)

    async def serve_first(server, arm: str, first: dict):
        for name in ("north_star", "3_aggregate"):
            cold0, since = counts("cold-chain"), len(server.ctx.metrics.slice_phases)
            dt, ttfb, slices = await consume(server.public_addr, "bench", name)
            first[f"{arm}/{name}"] = dict(first_slice(server, since), first_batch_ms=ttfb * 1e3,
                                          pass_s=dt, slices=slices,
                                          cold_chain=counts("cold-chain") - cold0)

    async def run(work: Path):
        # (a) not warmed, then warmed
        first = {}
        torch.cuda.empty_cache()
        server = await cases.start_spu_server(work / "a", batches,
                                              admission=AdmissionConfig(enabled=True))
        try:
            cuda_kernels.reset_launches()
            await serve_first(server, "not_warmed", first)
            launches["a_not_warmed"] = dict(cuda_kernels.LAUNCHES)
        finally:
            await server.stop()
        if first["not_warmed/north_star"]["cold_chain"] or first[
                "not_warmed/3_aggregate"]["cold_chain"]:
            raise AssertionError(f"admission (a): cold-chain sheds without the warm-up {first}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        server = await cases.start_spu_server(
            work / "b", batches, admission=AdmissionConfig(enabled=True, warmup=True))
        write_s = time.perf_counter() - t0
        try:
            reports0 = len(adm_warmup.recent_reports())
            builds0 = TELEMETRY.compile_totals()["compiles"]
            cuda_kernels.reset_launches()
            await serve_first(server, "warmed", first)
            launches["a_warmed"] = dict(cuda_kernels.LAUNCHES)
            reports = adm_warmup.recent_reports()[reports0:]
            builds = TELEMETRY.compile_totals()["compiles"] - builds0
            if [r.chain for r in reports] != ["filter+map", "aggregate"] or any(
                    r.errors for r in reports):
                raise AssertionError(f"admission (a): warm reports "
                                     f"{[r.to_dict() for r in reports]}")
            if builds != sum(r.compiles for r in reports):
                raise AssertionError(f"admission (a): {builds} build events while serving, "
                                     f"{sum(r.compiles for r in reports)} of them the warms'")
            for name in ("north_star", "3_aggregate"):
                if first[f"warmed/{name}"]["cold_chain"] < 1:
                    raise AssertionError(f"admission (a): {name}'s consumer was not held "
                                         "cold-chain during its warm")
            numbers["a_warms"] = [r.to_dict() for r in reports]
            numbers["a_first_slice"] = first
            numbers["write_s"] = write_s

            # (b) four tenants under a tight token bucket
            t0 = time.perf_counter()
            plan = []
            for k in range(p["tenants"]):
                await cases.write_topic(server, f"t{k}.bench", batches)
                plan.append((f"t{k}.bench", ("north_star", "flu_regex_filter")[k % 2]))
            numbers["b_write_s"] = time.perf_counter() - t0
            admission.configure(AdmissionConfig(enabled=True))
            admission.set_gate(admission.AdmissionController(tokens=p["token_tokens"],
                                                             refill=p["token_refill"]))
            TELEMETRY.reset()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            passes = await asyncio.gather(*(consume(server.public_addr, topic, name)
                                            for topic, name in plan))
            wall = time.perf_counter() - t0
            launches["b_tokens"] = dict(cuda_kernels.LAUNCHES)
            held = [f for f in TELEMETRY.flows_json() if f.get("phases_ms", {}).get("hold")]
            tenants_held = TELEMETRY.tenant_families()[2]
            if (counts("no-tokens") < 1 or not held or TELEMETRY.gauge_value("held_slices")
                    or set(tenants_held) != {f"t{k}" for k in range(p["tenants"])}):
                raise AssertionError(f"admission (b): no-tokens {counts('no-tokens')}, "
                                     f"{len(held)} held flows, held_slices "
                                     f"{TELEMETRY.gauge_value('held_slices')}, tenants held "
                                     f"{tenants_held}, shed {TELEMETRY.tenant_families()[1]}, "
                                     f"slices {[x[2] for x in passes]}")
            numbers["b_tokens"] = {
                "wall_s": wall, "records_per_s": p["tenants"] * n / wall,
                "passes_s": [x[0] for x in passes], "slices": [x[2] for x in passes],
                "admission": dict(TELEMETRY.admission), "tenants_held": tenants_held,
                "tenants_shed": TELEMETRY.tenant_families()[1], "held_flows": len(held),
                "hold_ms": sorted(f["phases_ms"]["hold"] for f in held)}

            # (c) a record-age target of 1 ms: a consumer the gate lets
            # through breaches it, the next one is shed until it ages out
            telemetry.configure(TelemetryConfig(
                slo="consumer_lag:off=1;record_age_p99:target_ms=1",
                slo_window_s=p["breach_window_s"], slo_windows=p["breach_windows"]))
            admission.configure(AdmissionConfig())
            TELEMETRY.reset()
            slo_mod.engine().evaluate()  # the windows' first sample
            await consume(server.public_addr, "bench", "north_star")
            await asyncio.sleep(p["breach_window_s"] * 1.2)  # past a window boundary
            admission.set_gate(admission.AdmissionController(refresh_s=p["breach_refresh_s"],
                                                             rng=random.Random(19)))
            cuda_kernels.reset_launches()
            dt, ttfb, slices = await consume(server.public_addr, "bench", "north_star")
            launches["c_breach"] = dict(cuda_kernels.LAUNCHES)
            held = [f for f in TELEMETRY.flows_json() if f.get("phases_ms", {}).get("hold")]
            if counts("breach-shed") < 1 or TELEMETRY.gauge_value("held_slices") or not held:
                raise AssertionError(f"admission (c): {dict(TELEMETRY.admission)}, held_slices "
                                     f"{TELEMETRY.gauge_value('held_slices')}")
            numbers["c_breach"] = {
                "pass_s": dt, "first_batch_ms": ttfb * 1e3, "slices": slices,
                "admission": dict(TELEMETRY.admission),
                "slo_breaches": dict(TELEMETRY.slo_breaches),
                "hold_ms": sorted(f["phases_ms"]["hold"] for f in held)}
        finally:
            admission.configure(AdmissionConfig())
            telemetry.configure(TelemetryConfig())
            await server.stop()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-admission-") as work:
        asyncio.run(run(Path(work)))

    # (d) the pipeline: the four tenants' slices coalesced into warmed buckets
    ex = broker_chain("north_star").gpu_chain
    slices, owner = [], {}
    for k, b in enumerate(batches):
        cols = native_records.decode_record_columns(b.raw_records, align=4)
        buf = RecordBuffer.from_flat(cols, base_offset=b.base_offset)
        slices.append((f"t{k % p['tenants']}", buf))
        owner[id(buf)] = (f"t{k % p['tenants']}", b.base_offset)
    widths = sorted({buf.width for _, buf in slices})
    admission.configure(AdmissionConfig(enabled=True, batch_rows=p["pipeline_rows"]))
    TELEMETRY.reset()
    report = admission.warm_executor(ex, widths=widths, rows=p["pipeline_rows"])
    if report.errors or sorted(report.buckets) != widths:
        raise AssertionError(f"admission (d): warm {report.to_dict()}")
    outputs = {f"t{k}": [] for k in range(p["tenants"])}
    flush_log = []

    def dispatch(flush):
        out = ex.process_buffer(flush.buffer)
        for buf, part in zip(flush.items, admission.split_output(out, flush.bases)):
            tenant, base = owner[id(buf)]
            outputs[tenant] += [(base + d, v) for v, d in part]
        flush_log.append((flush.cause, flush.buffer.count, flush.width_bucket))

    pipe = admission.AdmissionPipeline(dispatch)
    pipe.register_chain("filter+map")
    pipe.note_warm("filter+map", report.buckets)
    cuda_kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resubmitted = 0
    for tenant, buf in slices:
        while not pipe.submit("filter+map", buf, tenant=tenant):
            resubmitted += 1  # a shed slice is held and submitted again
            time.sleep(0.005)
        pipe.pump()
    pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["d_pipeline"] = dict(cuda_kernels.LAUNCHES)
    admission.configure(AdmissionConfig())
    t_off, t_len, t_flat = truths["north_star"]
    t_start = np.concatenate([[0], np.cumsum(t_len)])
    for k in range(p["tenants"]):
        mine = np.zeros(n, dtype=bool)
        for j in range(k, len(batches), p["tenants"]):
            mine[batches[j].base_offset: batches[j].computed_last_offset()] = True
        want = [(int(t_off[i]), t_flat[t_start[i]: t_start[i + 1]].tobytes())
                for i in np.nonzero(mine[t_off])[0]]
        if outputs[f"t{k}"] != want:
            raise AssertionError(f"admission (d): tenant t{k}: {len(outputs[f't{k}'])} outputs, "
                                 f"host truth {len(want)}")
    rows = [r for _, r, _ in flush_log]
    if counts("cold-bucket") or sum(rows) != n:
        raise AssertionError(f"admission (d): flushes {flush_log}, admission "
                             f"{dict(TELEMETRY.admission)}")
    numbers["d_pipeline"] = {
        "records_per_s": n / wall, "wall_s": wall, "flushes": len(flush_log),
        "causes": dict(Counter(c for c, _, _ in flush_log)), "rows": rows,
        "buckets": sorted({w for _, _, w in flush_log}), "warm": report.to_dict(),
        "resubmitted": resubmitted, "admission": dict(TELEMETRY.admission),
        "outputs": sum(len(v) for v in outputs.values())}
    numbers["phase_s"] = time.perf_counter() - t_phase
    log("admission (a): warm-up wall s "
        f"{[round(w['wall_s'], 4) for w in numbers['a_warms']]} (buckets "
        f"{[w['buckets'] for w in numbers['a_warms']]}, skipped "
        f"{[w['skipped'] for w in numbers['a_warms']]}, builds "
        f"{[w['compiles'] for w in numbers['a_warms']]}, launches "
        f"{[w['launches'] for w in numbers['a_warms']]}, allocator growth B "
        f"{[w['reserved_bytes'] for w in numbers['a_warms']]}); first slice server ms / "
        "client ms to the first batch: " + "; ".join(
            f"{k} {v['ms']:.3f} / {v['first_batch_ms']:.3f} (cold-chain {v['cold_chain']})"
            for k, v in numbers["a_first_slice"].items()))
    b = numbers["b_tokens"]
    log(f"admission (b): {p['tenants']} tenants x {n} records in {b['wall_s']:.3f} s "
        f"({b['records_per_s']:.0f} records/s), admission {b['admission']}, tenants held "
        f"{b['tenants_held']}, {b['held_flows']} held flows (hold ms "
        f"{[round(x, 1) for x in b['hold_ms']]}), held_slices 0")
    c = numbers["c_breach"]
    log(f"admission (c): breach-shed, then served in {c['pass_s']:.3f} s (first batch after "
        f"{c['first_batch_ms']:.1f} ms), admission {c['admission']}, hold ms "
        f"{[round(x, 1) for x in c['hold_ms']]}, SLO breaches {c['slo_breaches']}")
    d = numbers["d_pipeline"]
    log(f"admission (d): {n} records of {p['tenants']} tenants in {d['flushes']} flushes "
        f"{d['causes']} (rows {sorted(set(d['rows']))}, buckets {d['buckets']}) at "
        f"{d['records_per_s']:.0f} records/s, resubmitted {d['resubmitted']}, no cold-bucket, "
        f"each tenant's outputs equal host truth; phase 19 took {numbers['phase_s']:.1f} s")
    return numbers, {k: sum(v[k] for v in launches.values()) for k in cuda_kernels.LAUNCHES}


# phase 20: user Python SmartModules beside the card's segments
HOOKS_PHASE = dict(records=N, plants=(0, 786_431, None), batch_records=16_384,
                   max_bytes=16 << 20, dedup_records=1 << 18, dedup_more=1 << 16,
                   dedup_ids=1 << 15, dedup_count=10_000, lookback_last=1000)
_ELEMENT_PATTERN = re.compile(rb"a1[0-9]")


def array_elements(rec: bytes):
    """The elements of a `gen_arrays` record as ``array-map-json`` emits
    them (strings unquoted), read with no engine: the records hold no
    comma inside an element."""
    return [e[1:-1] if e[:1] == b'"' else e for e in rec[1:-1].split(b",")]


def element_matches(rec: bytes) -> int:
    """How many of a record's elements ``regex-filter("a1[0-9]")`` keeps."""
    return sum(1 for e in array_elements(rec) if _ELEMENT_PATTERN.search(e))


def exploded_truth(records):
    """(lengths i64, flat u8) of every element of ``records``, in order."""
    parts = fork_records(lambda rec: b"\0".join(array_elements(rec)), records)
    elements = [e for part in parts for e in part.split(b"\0")]
    return (np.fromiter(map(len, elements), dtype=np.int64, count=len(elements)),
            np.frombuffer(b"".join(elements), dtype=np.uint8))


def counts_truth(first: int, m: int):
    """(lengths i64, flat u8) of the running counts first+1 .. first+m."""
    outs = [str(c).encode() for c in range(first + 1, first + m + 1)]
    return (np.fromiter(map(len, outs), dtype=np.int64, count=m),
            np.frombuffer(b"".join(outs), dtype=np.uint8))


def check_columns(label: str, lengths, flat, truth) -> None:
    """Output columns (lengths, flat bytes) against a truth of the same
    form, exactly."""
    t_len, t_flat = truth
    if not (np.array_equal(np.asarray(lengths, dtype=np.int64), t_len)
            and np.array_equal(np.asarray(flat, dtype=np.uint8), t_flat)):
        raise AssertionError(f"hooks {label}: {len(lengths)} outputs differ from host truth "
                             f"({len(t_len)})")


def check_error(label: str, err, offset: int) -> None:
    want = ("input record is not a JSON array", offset, "array_map", None,
            shared_cases().FIRST_ERROR_RECORD)
    got = None if err is None else (err.hint, err.offset, err.kind.value, err.record_key,
                                    err.record_value)
    if got != want:
        raise AssertionError(f"hooks {label}: error {got}, truth {want}")


def phase_hooks():
    """Phase 20: user Python SmartModules beside the card's segments, each
    arm exact against a host truth computed without the port's engine:

    (a) first error: `FIRST_ERROR_CHAIN` (``array-map-json`` ->
        ``regex-filter("a1[0-9]")`` over the elements -> ``aggregate-count``)
        through ``process_buffer`` over 1,048,576 `gen_arrays` records with
        ``{"no":1}`` planted at row 0, at row 786,431 or nowhere, then a
        clean batch of 1,048,576 (the count's carry after an error batch);
        an error batch's output is the explode's elements before the record,
        re-dispatched on the card;
    (b) the same chain over the port's `SpuServer` socket: the planted log
        (row 786,431) in 64 stored batches, a raw stream acked slice by
        slice; every response's records, then the error response's records,
        error and ``next_filter_offset``;
    (c) a dedup topic: an SC and an SPU, a topic deduplicating through
        ``dedup-filter`` (count 10,000); 262,144 `gen_json` records keyed
        from 32,768 ids produced through the SC-routed producer; the SPU
        restarted (its leader re-seeded by a look-back of 10,000 records
        from its log), 65,536 more produced; the stored log against the
        filter's rule run over every produced record, then consumed
        through the north star;
    (d) a look-back stream: a DSL ``flu[vV]io`` filter exporting a
        ``look_back`` hook, ``lookback_last`` 1,000, over phase 13's log
        behind the server of (b): the hook sees the log's last 1,000
        values, and the stream is phase 13's truth;
    (e) a mixed chain, `MIXED_CHAIN` (``regex-filter("fluvio")`` on the card
        -> a Python map hook on the host -> ``json-map("name")`` on the card)
        through ``chain.process`` over 1,048,576 `gen_json` records.

    Returns (numbers, launches of (a)-(e))."""
    import asyncio
    import tempfile
    from collections import OrderedDict

    from fluvio_tpu_torch.client import Fluvio, Offset
    from fluvio_tpu_torch.metadata.topic import Bounds, Deduplication, Filter, TopicSpec
    from fluvio_tpu_torch.metadata.topic import Transform
    from fluvio_tpu_torch.protocol.error import ErrorCode
    from fluvio_tpu_torch.protocol.record import Record
    from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocation
    from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocationKind
    from fluvio_tpu_torch.schema.smartmodule import SmartModuleInvocationWasm
    from fluvio_tpu_torch.schema.spu import OffsetUpdate, StreamFetchRequest
    from fluvio_tpu_torch.schema.spu import UpdateOffsetsRequest
    from fluvio_tpu_torch.smartmodule.types import (
        SmartModuleInput,
        SmartModuleKind,
        SmartModuleTransformRuntimeError,
    )
    from fluvio_tpu_torch.spu import public_service
    from fluvio_tpu_torch.telemetry import TELEMETRY

    t_phase = time.perf_counter()
    p, cases = HOOKS_PHASE, shared_cases()
    n = p["records"]
    numbers, launches = {}, {}

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def measured(fn):
        """``fn()`` with the launch counts set to 0 just before it and read
        just after (the main path's runs)."""
        torch.cuda.synchronize()
        cuda_kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        add_launches(cuda_kernels.LAUNCHES)
        return out, dt

    # (a) first error through process_buffer
    clean = gen_arrays(n, seed=2020)
    follow = gen_arrays(n, seed=2021)
    m_clean, m_follow = fork_records(element_matches, clean), fork_records(element_matches,
                                                                            follow)
    arms = []
    for plant in p["plants"]:
        values = list(clean)
        if plant is not None:
            values[plant] = cases.FIRST_ERROR_RECORD
        gpu = cases.hook_chain(cases.FIRST_ERROR_CHAIN, "cuda").gpu_chain
        carry, arm = 0, {"plant": plant, "batches": []}
        for k, batch in enumerate((values, follow)):
            buf = RecordBuffer.from_values(batch, base_offset=k * n)
            redo0 = gpu.error_redispatch_seconds
            out, dt = measured(lambda: gpu.process_buffer(buf))
            cols = out.to_columns()
            label = f"(a) plant {plant} batch {k}"
            if k == 0 and plant is not None:
                check_error(label, out.error, plant)
                check_columns(label, np.diff(cols["val_off"]), cols["val_flat"],
                              exploded_truth(values[:plant]))
            else:
                if out.error is not None:
                    raise AssertionError(f"hooks {label}: error {out.error}")
                m = sum(m_clean if k == 0 else m_follow)
                check_columns(label, np.diff(cols["val_off"]), cols["val_flat"],
                              counts_truth(carry, m))
                carry += m
            arm["batches"].append({"records_per_s": n / dt, "ms": dt * 1e3,
                                   "outputs": int(out.count),
                                   "redispatch_ms": (gpu.error_redispatch_seconds - redo0) * 1e3})
        gpu._ensure_host_state()
        if gpu.carries[0][0] != carry:
            raise AssertionError(f"hooks (a) plant {plant}: carry {gpu.carries}, truth {carry}")
        arms.append(arm)
    numbers["a_first_error"] = arms

    # (b) + (d): the SPU server; (c): a cluster
    planted = list(clean)
    planted[p["plants"][1]] = cases.FIRST_ERROR_RECORD
    bcfg = BROKER
    _w, json_batches = cases.broker_log(broker_values(), bcfg["batch_records"],
                                        bcfg["first_timestamp"])
    _w, array_batches = cases.broker_log(planted, p["batch_records"], bcfg["first_timestamp"])
    m_planted = fork_records(element_matches, planted)

    async def first_error_stream(server):
        client = await Fluvio.connect(server.public_addr)
        try:
            consumer = await client.partition_consumer("arrays", 0)
            stream = await consumer._socket.create_stream(StreamFetchRequest(
                topic="arrays", max_bytes=p["max_bytes"],
                smartmodules=cases.first_error_invocations()))
            parts = []
            try:
                async for response in stream:
                    part = response.partition
                    parts.append(part)
                    if part.error_code != ErrorCode.NONE:
                        break
                    await consumer._socket.send_async(UpdateOffsetsRequest(offsets=[
                        OffsetUpdate(offset=part.next_filter_offset,
                                     session_id=response.stream_id)]))
            finally:
                await stream.close()
            return parts
        finally:
            await client.close()

    seen = []
    real_look_back = public_service.chain_look_back

    async def watched_look_back(chain, leader):
        await real_look_back(chain, leader)
        for inst in chain.instances:
            hook = inst.module.hook(SmartModuleKind.LOOK_BACK)
            if hook is not None:
                seen.append(list(hook.__globals__["SEEN"]))

    async def look_back_stream(server):
        inv = [SmartModuleInvocation(wasm=SmartModuleInvocationWasm.adhoc(
            cases.LOOK_BACK_SEEN_SM), kind=SmartModuleInvocationKind.FILTER,
            lookback_last=p["lookback_last"])]
        client = await Fluvio.connect(server.public_addr)
        try:
            consumer = await client.partition_consumer("bench", 0)
            config = cases.server_consumer_config(inv, bcfg["max_bytes"])
            got, _arrivals = await cases.consume_once(consumer, config)
            return got
        finally:
            await client.close()

    async def run_server(log_dir):
        t0 = time.perf_counter()
        server = await cases.start_spu_server(log_dir, json_batches)  # on the card
        await cases.write_topic(server, "arrays", array_batches)
        log_s = time.perf_counter() - t0
        public_service.chain_look_back = watched_look_back
        try:
            torch.cuda.synchronize()
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            parts = await first_error_stream(server)
            torch.cuda.synchronize()
            b_s = time.perf_counter() - t0
            add_launches(cuda_kernels.LAUNCHES)
            cuda_kernels.reset_launches()
            t0 = time.perf_counter()
            got = await look_back_stream(server)
            torch.cuda.synchronize()
            d_s = time.perf_counter() - t0
            add_launches(cuda_kernels.LAUNCHES)
        finally:
            public_service.chain_look_back = real_look_back
            await server.stop()
        return log_s, parts, b_s, got, d_s

    with tempfile.TemporaryDirectory(prefix="hooks-server-") as d:
        log_s, parts, b_s, got, d_s = asyncio.run(run_server(d))
    # (b): counts for every stored batch before the failing one, then that
    # batch's elements before the record; the next offset at its end
    fail = p["plants"][1]
    fail_start = fail - fail % p["batch_records"]
    fail_end = fail_start + p["batch_records"]
    last = parts[-1]
    want_message = str(SmartModuleTransformRuntimeError(
        hint="input record is not a JSON array", offset=fail, kind=SmartModuleKind.ARRAY_MAP,
        record_value=cases.FIRST_ERROR_RECORD))
    if (last.error_code != ErrorCode.SMARTMODULE_RUNTIME_ERROR
            or last.error_message != want_message or last.next_filter_offset != fail_end):
        raise AssertionError(f"hooks (b): {last.error_code} {last.error_message!r}, next "
                             f"{last.next_filter_offset}")
    values_out = [r.value for part in parts for b in part.records.batches
                  for r in b.memory_records()]
    m_before = sum(m_planted[:fail_start])
    c_len, c_flat = counts_truth(0, m_before)
    e_len, e_flat = exploded_truth(planted[fail_start:fail])
    check_columns("(b)", [len(v) for v in values_out],
                  np.frombuffer(b"".join(values_out), dtype=np.uint8),
                  (np.concatenate([c_len, e_len]), np.concatenate([c_flat, e_flat])))
    numbers["b_server"] = {"records_per_s": fail_end / b_s, "seconds": b_s,
                           "responses": len(parts), "log_s": log_s,
                           "error_records": sum(len(b.memory_records())
                                                for b in last.records.batches),
                           "next_filter_offset": last.next_filter_offset}
    # (d): the hook saw the log's last 1,000 values; the stream is the truth
    values13 = broker_values()
    if seen != [values13[-p["lookback_last"]:]]:
        raise AssertionError(f"hooks (d): the look-back hook saw {[len(s) for s in seen]} "
                             f"records, not the log's last {p['lookback_last']}")
    results, starts = server_results(got)
    check_broker_pass("flu_regex_filter", results, starts, broker_truth("flu_regex_filter"))
    numbers["d_look_back"] = {"records_per_s": n / d_s, "seconds": d_s,
                              "look_back_records": len(seen[0])}

    # (c) the dedup topic
    rng = np.random.default_rng(2022)
    dvals = gen_json(p["dedup_records"] + p["dedup_more"], seed=2022)
    dkeys = [b"id%d" % k for k in rng.integers(0, p["dedup_ids"], size=len(dvals))]
    items = list(zip(dkeys, dvals))
    kept, window = [], OrderedDict()
    for key, value in items:  # the filter's rule: count-bounded, no age
        if key in window:
            continue
        window[key] = True
        while len(window) > p["dedup_count"]:
            window.popitem(last=False)
        kept.append((key, value))

    async def dedup_run(log_dir):
        sc, admin, (spu,) = await cases.boot_torch_cluster(log_dir)  # the SPU on the card
        spus = [spu]
        try:
            spec = TopicSpec.computed(1)
            spec.deduplication = Deduplication(
                bounds=Bounds(count=p["dedup_count"]),
                filter=Filter(transform=Transform(uses="dedup-filter")))
            await admin.create_topic("dedup", spec)
            await cases.wait_for_replicas(spu, "dedup", [0])
            out = {}
            for label, part in (("first", items[:p["dedup_records"]]),
                                ("after_restart", items[p["dedup_records"]:])):
                if label == "after_restart":
                    t0 = time.perf_counter()
                    await spu.stop()
                    spus = []
                    spu = await cases.restart_torch_spu(sc, spu)
                    spus = [spu]
                    await cases.wait_for_replicas(spu, "dedup", [0])
                    out["restart_s"] = time.perf_counter() - t0
                client = await Fluvio.connect(sc.public_addr)
                try:
                    interp0 = TELEMETRY.interp_seconds
                    t0 = time.perf_counter()
                    await cases.produce_all(client, "dedup", part)
                    dt = time.perf_counter() - t0
                    out[label] = {"records": len(part), "records_per_s": len(part) / dt,
                                  "seconds": dt,
                                  "hook_ms": (TELEMETRY.interp_seconds - interp0) * 1e3}
                finally:
                    await client.close()
            leader = spu.ctx.leader_for("dedup", 0)
            stored = [(r.key, r.value) for b in leader.storage.read_records(
                0, 1 << 30, "read_committed") for r in b.memory_records()]
            client = await Fluvio.connect(sc.public_addr)
            try:
                consumer = await client.partition_consumer("dedup", 0)
                config = cases.server_consumer_config(cases.north_star_invocations(),
                                                      bcfg["max_bytes"])
                torch.cuda.synchronize()
                cuda_kernels.reset_launches()
                t0 = time.perf_counter()
                got, _ = await cases.consume_once(consumer, config)
                torch.cuda.synchronize()
                out["north_star_s"] = time.perf_counter() - t0
                add_launches(cuda_kernels.LAUNCHES)
            finally:
                await client.close()
            return out, stored, got
        finally:
            await cases.shutdown_torch_cluster(sc, admin, spus)

    with tempfile.TemporaryDirectory(prefix="hooks-dedup-") as d:
        dedup, stored, ns_batches = asyncio.run(dedup_run(d))
    if stored != kept:
        raise AssertionError(f"hooks (c): {len(stored)} records stored, the filter's rule "
                             f"keeps {len(kept)}")
    ns_out = [r.value for b in ns_batches for r in b.memory_records()]
    ns_truth = [dsl.ascii_upper(dsl.json_get_bytes(v, "name")) for _, v in kept
                if b"fluvio" in v]
    if ns_out != ns_truth:
        raise AssertionError(f"hooks (c): the north star gave {len(ns_out)} records, truth "
                             f"{len(ns_truth)}")
    dedup.update(stored=len(stored), north_star_records=len(ns_out),
                 north_star_records_per_s=len(stored) / dedup["north_star_s"])
    numbers["c_dedup"] = dedup

    # (e) the mixed chain through chain.process
    docs = gen_json(n, seed=2023)
    mixed = cases.hook_chain(cases.MIXED_CHAIN, "cuda")
    mixed.process(SmartModuleInput.from_records([Record(value=v) for v in docs[:4096]]))
    inp = SmartModuleInput.from_records([Record(value=v, offset_delta=i)
                                         for i, v in enumerate(docs)])
    interp0 = TELEMETRY.interp_seconds
    out, e_s = measured(lambda: mixed.process(inp))
    hook_ms = (TELEMETRY.interp_seconds - interp0) * 1e3
    want = [b"HOOK/" + dsl.ascii_upper(dsl.json_get_bytes(v, "name")) for v in docs
            if b"fluvio" in v]
    if out.error is not None or [r.value for r in out.successes] != want:
        raise AssertionError(f"hooks (e): {len(out.successes)} outputs, truth {len(want)}")
    numbers["e_mixed"] = {"records_per_s": n / e_s, "seconds": e_s, "outputs": len(want),
                          "hook_segment_ms": hook_ms, "segments": len(mixed.segments)}
    numbers["phase_s"] = time.perf_counter() - t_phase
    for arm in numbers["a_first_error"]:
        log(f"hooks (a) plant {arm['plant']}: " + "; ".join(
            f"batch {k} {b['records_per_s']:.0f} records/s ({b['ms']:.1f} ms, {b['outputs']} "
            f"outputs, re-dispatch {b['redispatch_ms']:.2f} ms)"
            for k, b in enumerate(arm["batches"])))
    b = numbers["b_server"]
    log(f"hooks (b): the planted log over the socket to the error in {b['seconds']:.3f} s "
        f"({b['records_per_s']:.0f} records/s, {b['responses']} responses, the error's "
        f"{b['error_records']} records, next offset {b['next_filter_offset']}; log written "
        f"in {b['log_s']:.1f} s)")
    c = numbers["c_dedup"]
    log(f"hooks (c): dedup produce {c['first']['records_per_s']:.0f} records/s (hook "
        f"{c['first']['hook_ms']:.1f} ms), restart {c['restart_s']:.2f} s, then "
        f"{c['after_restart']['records_per_s']:.0f} records/s (hook "
        f"{c['after_restart']['hook_ms']:.1f} ms); {c['stored']} stored; north star "
        f"{c['north_star_records_per_s']:.0f} records/s")
    dd = numbers["d_look_back"]
    log(f"hooks (d): look-back of {dd['look_back_records']} records, the stream at "
        f"{dd['records_per_s']:.0f} records/s ({dd['seconds']:.3f} s)")
    e = numbers["e_mixed"]
    log(f"hooks (e): mixed chain {e['records_per_s']:.0f} records/s ({e['seconds']:.3f} s, "
        f"the hook segment {e['hook_segment_ms']:.1f} ms, {e['outputs']} outputs); phase 20 "
        f"took {numbers['phase_s']:.1f} s; launches {launches}")
    return numbers, launches

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json-only", action="store_true",
                        help="build the kernels and run only phase 2's JSON span checks and "
                             "times (no chains, no ok line)")
    parser.add_argument("--encode-extract-only", action="store_true",
                        help="build the kernels and run only the extract and encode window "
                             "match rows at the main path's shapes (no chains, no ok line)")
    parser.add_argument("--dfa-scan-only", action="store_true",
                        help="build the kernels and run only the DFA scan's checks and its "
                             "shapes (a)-(c) (no chains, no ok line)")
    parser.add_argument("--windowed-only", action="store_true",
                        help="run only the windowed-state phase (phase 10: the three delta "
                             "arms and 5_windowed's classic arm; no kernel build, no ok line)")
    parser.add_argument("--partitioned-only", action="store_true",
                        help="build the kernels and run only 9_partitioned through the partition "
                             "runtime (phase 11; no ok line)")
    parser.add_argument("--slice-only", action="store_true",
                        help="build the kernels and run only the aggregate and array_map "
                             "chains (phase 9) and their torch ops' times (no ok line)")
    parser.add_argument("--broker-only", action="store_true",
                        help="build the kernels and run only the broker's consume path "
                             "(phase 13; no ok line)")
    parser.add_argument("--server-only", action="store_true",
                        help="build the kernels and run only the SPU server over its socket "
                             "(phase 14; no ok line)")
    parser.add_argument("--cluster-only", action="store_true",
                        help="build the kernels and run only the cluster path: an SC and an "
                             "SPU, the producer, consumes by name (phase 15; no ok line)")
    parser.add_argument("--replication-only", action="store_true",
                        help="build the kernels and run only replication: an SC and three SPUs, "
                             "rf 3, a failover and a rejoin (phase 16; no ok line)")
    parser.add_argument("--secure-cluster-only", action="store_true",
                        help="build the kernels and run only the durable, secure cluster: TLS, "
                             "RBAC, lz4 and snappy topics, an SC restart (phase 17; no ok line)")
    parser.add_argument("--telemetry-only", action="store_true",
                        help="build the kernels and run only the telemetry and the monitoring "
                             "socket while card chains serve a consumer (phase 18; no ok line)")
    parser.add_argument("--telemetry-overhead", action="store_true",
                        help="build the kernels and run only phase 18's overhead gate, printing "
                             "its document (phase 18 runs it so, in a fresh process)")
    parser.add_argument("--admission-only", action="store_true",
                        help="build the kernels and run only admission: the serve gate's "
                             "warm-up, token and breach sheds over the socket, the pipeline's "
                             "batcher (phase 19; no ok line)")
    parser.add_argument("--hooks-only", action="store_true",
                        help="build the kernels and run only user Python SmartModules: the "
                             "first error on the card, over the socket, a dedup topic, a "
                             "look-back stream, a mixed chain (phase 20; no ok line)")
    parser.add_argument("--striped-slice-only", action="store_true",
                        help="build the kernels and run only phase 12 (with phase 9's aggregate "
                             "chains and phase 11, whose D2H it reads; no ok line)")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    if args.windowed_only:
        numbers, ops, _launches = phase_windowed()
        print(smi)
        print(json.dumps({"windowed": numbers, "windowed_torch_ops": ops}))
        return 0

    logs = KERNELS.build()
    log(f"kernels built in {KERNELS.build_seconds:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "Function properties" in line
                    or "error" in line.lower()):
                print(f"[nvcc {src}] {line.strip()}", file=sys.stderr)

    if args.telemetry_overhead:
        off_s, on_s, ok, rounds = telemetry_overhead(telemetry_phase_config())
        print(json.dumps({"telemetry_overhead": {
            "off_s": off_s, "on_s": on_s, "ok": ok,
            "rounds": [{"off": t[False], "on": t[True]} for t in rounds]}}))
        return 0
    corpus = RecordBuffer.from_values(gen_json(N, seed=2024))
    if args.encode_extract_only:
        v = torch.from_numpy(corpus.values).to(dev)
        ln = torch.from_numpy(corpus.lengths).to(dev)
        rows = [extract_row(v, *cuda_kernels.json_get_span(v, ln, "name")),
                enc_match_row(headline_desc_stream(corpus, dev))]
        for r in rows:
            log(f"kernel {r['name']}: {r['ms']:.4f} ms a call, device {r['device_ms']} ms")
        print(smi)
        print(json.dumps({"encode_extract_rows": rows}))
        return 0
    if args.dfa_scan_only:
        dfa_scan_adversarial(dev, *stage(adversarial(corpus.width), corpus.width, dev))
        row = dfa_scan_row(dev, corpus)
        print(smi)
        print(json.dumps({"dfa_scan_rows": [row]}))
        return 0
    if args.partitioned_only:
        _launches, numbers = phase_partitioned()
        print(smi)
        print(json.dumps({"partitioned": numbers}))
        return 0
    if args.slice_only:
        numbers, ops = phase_slice([gen_json(N, seed=100 + k) for k in range(SLICE_BATCHES)])
        print(smi)
        print(json.dumps({"slice_chains": numbers, "slice_torch_ops": ops}))
        return 0
    if args.broker_only:
        numbers, _launches = phase_broker()
        print(smi)
        print(json.dumps({"broker": numbers}))
        return 0
    if args.server_only:
        numbers, _launches = phase_server()
        print(smi)
        print(json.dumps({"server": numbers}))
        return 0
    if args.cluster_only:
        numbers, _launches = phase_cluster()
        print(smi)
        print(json.dumps({"cluster": numbers}))
        return 0
    if args.replication_only:
        numbers, _launches = phase_replication()
        print(smi)
        print(json.dumps({"replication": numbers}))
        return 0
    if args.secure_cluster_only:
        numbers, _launches = phase_secure_cluster()
        print(smi)
        print(json.dumps({"secure_cluster": numbers}))
        return 0
    if args.telemetry_only:
        numbers, _launches = phase_telemetry()
        print(smi)
        print(json.dumps({"telemetry": numbers}))
        return 0
    if args.admission_only:
        numbers, launches = phase_admission()
        print(smi)
        print(json.dumps({"admission": numbers, "launches": launches}))
        return 0
    if args.hooks_only:
        numbers, launches = phase_hooks()
        print(smi)
        print(json.dumps({"hooks": numbers, "launches": launches}))
        return 0
    if args.striped_slice_only:
        json_corpora = [gen_json(N, seed=100 + k) for k in range(SLICE_BATCHES)]
        slice_numbers, _ops = phase_slice(json_corpora, ("3_aggregate", "filter_aggregate"))
        _launches, part_numbers = phase_partitioned()
        numbers, d2h = phase_striped_slice(json_corpora[0], slice_numbers, part_numbers)
        print(smi)
        print(json.dumps({"striped_slice": numbers, "byte_mode_d2h": d2h}))
        return 0
    narrow, striped = phase_json_span(dev, corpus)
    if args.json_only:
        print(smi)
        print(json.dumps({"json_span_rows": [narrow, striped]}))
        return 0
    laps = {"1-2a build, corpus, json span": time.perf_counter() - t_start}

    def lap(label: str) -> None:
        laps[label] = time.perf_counter() - t_start - sum(laps.values())

    phase_long_keys(dev)
    rows = [narrow] + phase_kernels(dev, corpus)
    rows += [striped] + phase_striped_kernels(dev)
    rows += phase_glz_kernels(dev, corpus)
    lap("2b-7 long keys, kernels, striped and glz kernels")
    corpora = fork_map(lambda k: gen_json(N, seed=100 + k), list(range(HEADLINE_BATCHES)))
    head_launches, head_rate, head_chain = phase_headline(corpora)
    jr_launches, jr_rate = phase_json_regex()
    rf_launches, rf_rate = phase_regex_chain()
    st_launches, st_rates = phase_striped_chains()
    glz_launches, glz_rates = phase_glz_chains(corpora, head_rate,
                                               head_chain.link_counts["h2d_bytes"])
    lap("3-8 chains")
    slice_numbers, torch_ops = phase_slice(corpora[:SLICE_BATCHES])
    lap("9 slice chains")
    win_numbers, win_ops, win_launches = phase_windowed()
    lap("10 windowed")
    part_launches, part_numbers = phase_partitioned()
    lap("11 partitioned")
    ss_numbers, byte_d2h = phase_striped_slice(corpora[0], slice_numbers, part_numbers)
    lap("12 striped slice")
    broker_numbers, _ = phase_broker()
    lap("13 broker")
    server_numbers, _ = phase_server()
    lap("14 server")
    cluster_numbers_, cluster_launches = phase_cluster()
    lap("15 cluster")
    repl_numbers, repl_launches = phase_replication()
    lap("16 replication")
    secure_numbers, secure_launches = phase_secure_cluster(cluster_numbers_)
    lap("17 secure cluster")
    telemetry_numbers, telemetry_launches = phase_telemetry()
    lap("18 telemetry")
    admission_numbers, admission_launches = phase_admission()
    lap("19 admission")
    hooks_numbers, hooks_launches = phase_hooks()
    lap("20 hooks")
    log(f"replication beside the cluster: north star by name through the SC from the promoted "
        f"leader {repl_numbers['north_star_after_failover']['sc_records_per_s']:.0f} records/s, "
        f"phase 15's (b) {cluster_numbers_['consume_by_name']['sc_records_per_s']:.0f}; produce "
        f"READ_COMMITTED at rf 3 {repl_numbers['produce']['records_per_s']:.0f} records/s, "
        f"phase 15's default produce at rf 1 "
        f"{cluster_numbers_['produce_default']['records_per_s']:.0f}")
    log("smoke phases (s): " + json.dumps({k: round(v, 1) for k, v in laps.items()}))
    by_chain = {**slice_numbers, **ss_numbers,
                **{f"broker_{k}": v for k, v in broker_numbers.items()},
                **{f"server_{k}": v for k, v in server_numbers.items()},
                "cluster": {"launches": cluster_launches},
                "replication": {"launches": repl_launches},
                "secure_cluster": {"launches": secure_launches},
                "telemetry": {"launches": telemetry_launches},
                "admission": {"launches": admission_launches},
                "hooks": {"launches": hooks_launches}}
    for r in rows:
        r["launches_by_chain"] = {k: v["launches"][r["name"]] for k, v in by_chain.items()}
    chain_launches = [v["launches"] for v in by_chain.values()]
    paths = (head_launches, jr_launches, rf_launches, st_launches, glz_launches, *chain_launches,
             win_launches, part_launches)
    for r in rows:
        r["launches"] = sum(p[r["name"]] for p in paths)
        if r.get("main_path", True) and r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} never launched on the main path")
        if not r.get("main_path", True) and r["launches"]:
            raise AssertionError(f"kernel {r['name']} launched on the main path, which it left")
    log(json.dumps({"headline_records_per_s": head_rate,
                    "json_regex_filter_records_per_s": jr_rate,
                    "flu_regex_json_map_records_per_s": rf_rate,
                    "striped": st_rates,
                    "glz": glz_rates,
                    "slice_chains": slice_numbers,
                    "windowed": win_numbers,
                    "partitioned": part_numbers,
                    "striped_slice": ss_numbers,
                    "byte_mode_d2h": byte_d2h,
                    "broker": {k: {m: x for m, x in v.items() if m != "launches"}
                               for k, v in broker_numbers.items()},
                    "server": {k: {m: x for m, x in v.items() if m != "launches"}
                               for k, v in server_numbers.items()},
                    "cluster": cluster_numbers_,
                    "replication": repl_numbers,
                    "secure_cluster": secure_numbers,
                    "telemetry": telemetry_numbers,
                    "admission": admission_numbers,
                    "hooks": hooks_numbers,
                    "build_seconds": KERNELS.build_seconds}))
    log(json.dumps({"slice_torch_ops": torch_ops, "windowed_torch_ops": win_ops,
                    "device": smi}))
    log(f"smoke: {time.perf_counter() - t_start:.1f} s from the start to the result lines")
    print(smi)
    key_order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in key_order},
                                   **{k: v for k, v in r.items() if k not in key_order}}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
