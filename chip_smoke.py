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
   and this phase.

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
from fluvio_tpu_torch.smartengine.gpu.native import CSRC, KERNELS
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
    return b.initialize()


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
    want = [
        dsl.eval_expr(progs[1].value, rec, None)
        for rec in corpora[0]
        if dsl.eval_expr(progs[0].predicate, rec, None)
    ]
    got = outs[0].value_list()
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        raise AssertionError(f"headline batch differs from the interpreter at survivor {first} "
                             f"({len(got)} vs {len(want)} survivors)")
    want_off = [i for i, rec in enumerate(corpora[0]) if dsl.eval_expr(progs[0].predicate, rec, None)]
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
# the slice's torch code on the card (XLA code, not Pallas, in the JAX
# package): the functions of `kernels` the two stages call
SLICE_TORCH_OPS = ("parse_int", "int_to_ascii", "count_words", "segmented_scan",
                   "propagate_last_valid", "last_true_value", "json_array_bounds",
                   "split_bounds", "fanout_scatter")


def slice_truth(name: str, corpora):
    """Host truth of a slice chain over its batches, from the DSL
    interpreter: per batch (output values, source offsets). The running
    sums continue across batches and wrap as int64."""
    outs = []
    if name == "4_array_map":
        for corpus in corpora:
            vals, offs = [], []
            for i, rec in enumerate(corpus):
                elems = dsl.json_array_elements(rec)
                vals += elems
                offs += [i] * len(elems)
            outs.append((vals, offs))
        return outs
    acc = 0
    for corpus in corpora:
        vals, offs = [], []
        for i, rec in enumerate(corpus):
            if name == "filter_aggregate" and b"fluvio" not in rec:
                continue
            acc += dsl.parse_int_prefix(dsl.json_get_bytes(rec, "n"))
            acc = (acc + 2**63) % 2**64 - 2**63
            vals.append(str(acc).encode())
            offs.append(i)
        outs.append((vals, offs))
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
    for k, ((vals, offs), out) in enumerate(zip(truth, outs)):
        if out.count != len(vals) or out.value_list() != vals:
            got = out.value_list()
            first = next((i for i, (a, b) in enumerate(zip(got, vals)) if a != b),
                         min(len(got), len(vals)))
            raise AssertionError(f"{name} batch {k}: differs from the interpreter at output "
                                 f"{first} ({out.count} vs {len(vals)} outputs)")
        want_off = np.zeros(len(offs), np.int32) if name == "4_array_map" else np.array(offs)
        if not np.array_equal(out.offset_deltas[: out.count], want_off):
            raise AssertionError(f"{name} batch {k}: offsets differ from the interpreter's")
        if (out.key_lengths[: out.count] != -1).any():
            raise AssertionError(f"{name} batch {k}: keys on keyless records")
        if out.values is not None:
            raise AssertionError(f"{name} batch {k}: the output is not flat-backed")
    truth_s = time.perf_counter() - t_truth
    chain._ensure_host_state()
    if name != "4_array_map" and chain.carries != [(int(truth[-1][0][-1]), 0, True)]:
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
    array_corpora = ([gen_arrays(N, seed=200 + k) for k in range(SLICE_BATCHES)]
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
    for rec in corpus:
        x = dsl.parse_int_prefix(dsl.json_get_bytes(rec, "n"))
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
    parser.add_argument("--striped-slice-only", action="store_true",
                        help="build the kernels and run only phase 12 (with phase 9's aggregate "
                             "chains and phase 11, whose D2H it reads; no ok line)")
    args = parser.parse_args(argv)
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
    phase_long_keys(dev)
    rows = [narrow] + phase_kernels(dev, corpus)
    rows += [striped] + phase_striped_kernels(dev)
    rows += phase_glz_kernels(dev, corpus)
    corpora = [gen_json(N, seed=100 + k) for k in range(HEADLINE_BATCHES)]
    head_launches, head_rate, head_chain = phase_headline(corpora)
    jr_launches, jr_rate = phase_json_regex()
    rf_launches, rf_rate = phase_regex_chain()
    st_launches, st_rates = phase_striped_chains()
    glz_launches, glz_rates = phase_glz_chains(corpora, head_rate,
                                               head_chain.link_counts["h2d_bytes"])
    slice_numbers, torch_ops = phase_slice(corpora[:SLICE_BATCHES])
    win_numbers, win_ops, win_launches = phase_windowed()
    part_launches, part_numbers = phase_partitioned()
    ss_numbers, byte_d2h = phase_striped_slice(corpora[0], slice_numbers, part_numbers)
    by_chain = {**slice_numbers, **ss_numbers}
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
                    "build_seconds": KERNELS.build_seconds}))
    log(json.dumps({"slice_torch_ops": torch_ops, "windowed_torch_ops": win_ops,
                    "device": smi}))
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
