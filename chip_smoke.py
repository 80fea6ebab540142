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
   are integers or bytes); kernel, plain and library times. The two JSON
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
   kernel), the device time (torch.profiler) and per call in a run of
   back-to-back calls. ``--json-only`` builds the kernels and runs only
   these checks and times;
3. headline chain: ``regex-filter(regex="fluvio")`` -> ``json-map(field=
   "name")`` over 4 batches of 1,048,576 records through
   ``SmartEngine(device="cuda")`` and ``process_stream``; one whole batch
   checked record by record against the DSL interpreter on the host;
4. json-regex-filter chain: ``key="name", regex="^(fluvio|kafka|pulsar)-
   [0-3]$"`` over 1,048,576 records; survivors checked against ``re`` over
   ``json_get_bytes`` on the host; all three kernels must have launched;
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
   version on the headline chain's descriptor stream and on seven corpora
   at chunks of 4, 16, 256 and 512 KiB, with every encoded stream decoded
   back on the host; all exact;
8. glz chains: the headline chain with ``LinkParams(compress=True,
   result_compress=True)`` over the same 4 batches as phase 3 (batch 0
   checked against the interpreter; records/s beside phase 3's, link
   bytes, down-link forms and the host compress time; the fused decode
   launched and the resolve not), and the
   ``regex-filter("flu[vV]io")`` -> ``json-map`` striped chain with the
   link on over 4 x 1,024 fat records, whose constant descriptors must
   come back as tokens.

Standard output ends with three lines: the card's name and power limit as
``nvidia-smi`` reports them, one JSON object describing every kernel, and
the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.ops.regex_dfa import compile_regex
from fluvio_tpu_torch.smartengine import LinkParams, SmartEngine, SmartModuleConfig
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels, stripes
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from fluvio_tpu_torch.smartengine.gpu.executor import _bucket_rows, desc_stream, pad_glz_tokens
from fluvio_tpu_torch.smartengine.gpu.native import KERNELS
from fluvio_tpu_torch.smartmodule import dsl

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
    rng = np.random.default_rng(seed)
    names = ["fluvio", "kafka", "pulsar", "fluvio-tpu", "redpanda", "flink"]
    picks = rng.integers(0, len(names), size=n)
    nums = rng.integers(0, 100000, size=n)
    return [
        f'{{"name":"{names[picks[i]]}-{i & 1023}","n":{nums[i]}}}'.encode()
        for i in range(n)
    ]


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
    dfa = compile_regex(JSON_REGEX)
    if dfa.n_states != 22:
        raise AssertionError(f"bench regex compiled to {dfa.n_states} states, expected 22")

    # adversarial set first: corner cases exactly equal (the span kernel's
    # own adversarial checks are in phase_json_span)
    av, al = stage(adversarial(width), width, dev)
    st_a, vl_a = cuda_kernels.json_get_span(av, al, "name")
    require_equal("extract adversarial", cuda_kernels.extract_span(av, st_a, vl_a),
                  kernels.extract_span(av, st_a, vl_a))
    big = "(a|b)*a(a|b){6}c|x" + "d" * 125  # 257 states: the two-byte table
    for pattern, packed in ((JSON_REGEX, True), (JSON_REGEX, False), ("flu[vV]io", True),
                            (big, True), (big, False)):
        d = compile_regex(pattern, packed=packed)
        require_equal(f"dfa_scan adversarial {pattern[:24]} packed={packed}",
                      cuda_kernels.dfa_match(av, al, d), kernels.dfa_match(av, al, d))
    torch.cuda.synchronize()
    log("kernels: adversarial set equal (extract, dfa_scan incl. 257-state and unpacked 132 KB "
        "tables)")

    rows = []
    # the JSON span of the name field (both chains' first kernel; its row
    # is phase_json_span's)
    st, vl = cuda_kernels.json_get_span(v, ln, "name")

    # 2. extract of the name field (json-regex-filter's byte-mode JsonGet)
    ex = cuda_kernels.extract_span(v, st, vl)
    err = require_equal("extract", ex, kernels.extract_span(v, st, vl))
    ms = time_ms(lambda: cuda_kernels.extract_span(v, st, vl))
    plain_ms = time_ms(lambda: kernels.extract_span(v, st, vl), reps=5)
    j = torch.arange(width, device=dev, dtype=torch.int64)[None, :]
    idx = (st.to(torch.int64)[:, None] + j).clamp(0, width - 1)
    keep = j < vl.to(torch.int64)[:, None]
    library_ms = time_ms(lambda: torch.where(keep, torch.gather(v, 1, idx), 0))
    bytes_moved = float(vl.to(torch.int64).sum().item()) + 8 * N + N * width
    b_ms, b_by = bound(bytes_moved, float(N * width))
    rows.append(dict(name="extract", route="cuda",
                     source="fluvio_tpu_torch/smartengine/gpu/csrc/extract.cu",
                     replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:261",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=library_ms))

    # 3. DFA verdict over the extracted names (the 22-state bench regex)
    got = cuda_kernels.dfa_match(ex, vl, dfa)
    err = require_equal("dfa_scan", got, kernels.dfa_match(ex, vl, dfa))
    ms = time_ms(lambda: cuda_kernels.dfa_match(ex, vl, dfa))
    plain_ms = time_ms(lambda: kernels.dfa_match(ex, vl, dfa), reps=3)
    live = float(vl.to(torch.int64).sum().item())
    b_ms, b_by = bound(live + 4 * N + N, live + N)
    rows.append(dict(name="dfa_scan", route="cuda",
                     source="fluvio_tpu_torch/smartengine/gpu/csrc/dfa_scan.cu",
                     replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:651",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))
    torch.cuda.synchronize()
    for r in rows:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library {r['library_ms']}) "
            f"at N={N} W={width}, exact")
    return rows


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
    bound_ms, bound_by). The bound counts the class matrix read once, the
    table and the output, and one lookup per state per non-identity
    column."""
    table_t = stripes._dfa_device(dfa, cls.device)[1]
    got = cuda_kernels.dfa_compose_columns(cls, table_t)
    err = require_equal(f"dfa_compose {name}", got, kernels.dfa_compose_columns(cls, table_t))
    ms = time_ms(lambda: cuda_kernels.dfa_compose_columns(cls, table_t))
    plain_ms = time_ms(lambda: kernels.dfa_compose_columns(cls, table_t), reps=reps_plain,
                       warm=False)
    live = float((cls >= 0).sum().item())
    bytes_moved = cls.numel() * 4.0 + table_t.numel() * 4.0 + got.numel() * 4.0
    b_ms, b_by = bound(bytes_moved, live * dfa.n_states)
    log(f"kernel dfa_compose {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
        f"by {b_by}) at rows={cls.shape[0]} T={cls.shape[1]} S={dfa.n_states} "
        f"C={dfa.n_classes}, {live:.0f} non-identity columns, exact")
    return err, ms, plain_ms, b_ms, b_by


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


def device_ms(fn, reps: int = 20):
    """Mean device time of the JSON span kernel of one ``fn()`` call, from
    torch.profiler's kernel records (the wrapper's host time excluded);
    None where the profiler records no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device events at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum((getattr(ev, "self_device_time_total", None)
                        or getattr(ev, "self_cuda_time_total", 0))
                       for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA and "json_span" in ev.key)
        if total_us > 0:
            return total_us / 1e3 / reps
    log("device_ms: three profiles recorded no json_span kernel")
    return None


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
    call = lambda: cuda_kernels.json_get_span(v, ln, "name")  # noqa: E731
    ms, dev_ms, r_ms = time_ms(call), device_ms(call), run_ms(call)
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
                         "device_ms": device_ms(call), "run_ms": run_ms(call),
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
    check = {"ms": time_ms(call), "device_ms": device_ms(call), "run_ms": run_ms(call)}
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
                           "device_ms": device_ms(call), "run_ms": run_ms(call),
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
    err, ms, plain_ms, b_ms, b_by = compose_row("record-level flu[vV]io", cls_rec, dfa_rec)
    del cls_rec
    log(f"stripe_classes (torch class pass before dfa_compose) at the fat shape: record-level "
        f"{rec_cls_ms:.4f} ms, in-span {span_cls_ms:.4f} ms")
    compose_adversarial(dev)
    rows.append(dict(name="dfa_compose", route="cuda",
                     source="fluvio_tpu_torch/smartengine/gpu/csrc/dfa_compose.cu",
                     replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:850",
                     max_abs_err=max(err, span_row[0]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, stripe_classes_ms=rec_cls_ms,
                     in_span={"ms": span_row[1], "plain_ms": span_row[2],
                              "bound_ms": span_row[3], "bound_by": span_row[4],
                              "stripe_classes_ms": span_cls_ms}))
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
    ms = time_ms(lambda: cuda_kernels.glz_decode(*tok, n, chunk, comp.depth))
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
                      library_ms=None, out_bytes=n, token_bytes=token_bytes, depth=comp.depth,
                      sequences=len(comp.lit_lens), launches_per_call=3 + comp.depth,
                      old_path_ms=old_ms, byte_plan_ms=plan_ms)
    rows.append(decode_row)
    log(f"kernel glz_decode: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
        f"{b_by}, library: none (no single PyTorch call); old path byte plan + resolve "
        f"{old_ms:.3f} ms, of it the plan {plan_ms:.3f} ms) on the headline flat of {n} B from "
        f"{token_bytes} B of tokens read (ratio {comp.nbytes / n:.3f}, depth {comp.depth}, "
        f"{len(comp.lit_lens)} sequences, {3 + comp.depth} launches a call, host compress "
        f"{compress_s * 1e3:.1f} ms), exact")

    # the resolve kernel (the Pallas contract, off the main path) on the same plan
    base, midx = glz.byte_plan_device(*tok, n)
    got = cuda_kernels.glz_resolve(base, midx, chunk)
    r_err = require_equal("glz_resolve headline", got, kernels.glz_resolve(base, midx, chunk))
    if not np.array_equal(got.cpu().numpy(), flat):
        raise AssertionError("glz_resolve headline: the decoded flat differs from the raw flat")
    r_ms = time_ms(lambda: cuda_kernels.glz_resolve(base, midx, chunk))
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
                     bound_by=r_b_by, library_ms=None, out_bytes=n, main_path=False))
    log(f"kernel glz_resolve: {r_ms:.4f} ms (plain {r_plain_ms:.3f} ms, bound {r_b_ms:.4f} ms "
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
    stream = headline_desc_stream(corpus, dev)
    g_count = stream.numel() // glz.ENC_GROUP
    cg = glz.GLZ_CHUNK // glz.ENC_GROUP
    if g_count <= cg:  # encode_result's single-window clamp
        cg = max(128, ((g_count + 127) // 128) * 128)
    w0, w1, const_m = match_inputs(stream, cg)
    err = check_match("headline", stream, cg)
    ms = time_ms(lambda: cuda_kernels.glz_encode_match(w0, w1, const_m, cg))
    plain_ms = time_ms(lambda: kernels.glz_encode_match(w0, w1, const_m, cg), reps=3)
    b_ms, b_by = bound(13.0 * g_count, match_ops(w0, w1, const_m, cg))
    live = int((~const_m).sum().item())
    rows.append(dict(name="glz_enc_match", route="cuda",
                     source="fluvio_tpu_torch/smartengine/gpu/csrc/glz_encode.cu",
                     replaces="fluvio_tpu/smartengine/tpu/pallas_kernels.py:541",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, groups=g_count, chunk_groups=cg,
                     launches_per_call=1 + kernels.glz_square_rounds(cg)))
    log(f"kernel glz_enc_match: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by "
        f"{b_by}, library: none (no single PyTorch call)) on the headline descriptor stream of "
        f"{stream.numel()} B = {g_count} groups ({live} outside constant runs), {cg} groups a "
        f"chunk, {1 + kernels.glz_square_rounds(cg)} launches a call, exact")

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json-only", action="store_true",
                        help="build the kernels and run only phase 2's JSON span checks and "
                             "times (no chains, no ok line)")
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

    logs = KERNELS.build()
    log(f"kernels built in {KERNELS.build_seconds:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "Function properties" in line
                    or "error" in line.lower()):
                print(f"[nvcc {src}] {line.strip()}", file=sys.stderr)

    corpus = RecordBuffer.from_values(gen_json(N, seed=2024))
    narrow, striped = phase_json_span(dev, corpus)
    if args.json_only:
        print(smi)
        print(json.dumps({"json_span_rows": [narrow, striped]}))
        return 0
    rows = [narrow] + phase_kernels(dev, corpus)
    rows += [striped] + phase_striped_kernels(dev)
    rows += phase_glz_kernels(dev, corpus)
    corpora = [gen_json(N, seed=100 + k) for k in range(HEADLINE_BATCHES)]
    head_launches, head_rate, head_chain = phase_headline(corpora)
    jr_launches, jr_rate = phase_json_regex()
    st_launches, st_rates = phase_striped_chains()
    glz_launches, glz_rates = phase_glz_chains(corpora, head_rate,
                                               head_chain.link_counts["h2d_bytes"])
    paths = (head_launches, jr_launches, st_launches, glz_launches)
    for r in rows:
        r["launches"] = sum(p[r["name"]] for p in paths)
        if r.get("main_path", True) and r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} never launched on the main path")
        if not r.get("main_path", True) and r["launches"]:
            raise AssertionError(f"kernel {r['name']} launched on the main path, which it left")
    log(json.dumps({"headline_records_per_s": head_rate,
                    "json_regex_filter_records_per_s": jr_rate,
                    "striped": st_rates,
                    "glz": glz_rates,
                    "build_seconds": KERNELS.build_seconds}))
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
