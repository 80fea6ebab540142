"""Where `9_partitioned`'s pass time goes through the partition runtime, on
one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/partition_breakdown.py [--rounds R] [--passes P]

The corpus is `chip_smoke.py`'s phase 11: 524,288 bench JSON records split
round-robin into 4 partitions of 131,072, staged once, and the chain
``regex-filter("fluvio")`` -> ``aggregate-field(field="n")``. Each way of
driving the same 4 buffers runs one unmeasured pass, then ``P`` passes a
round, the ways in turn and reversed every other round (A B C .. C B A),
each pass ending in ``torch.cuda.synchronize()``:

- ``runtime_d2``, ``runtime_d1``, ``runtime_d0``: ``PartitionRuntime
  .process_interleaved`` at depth 2 (the default), 1 and 0 (serial), over
  2 groups folded onto the card, outputs dropped;
- ``runtime_keep``: depth 2, every output kept until the round ends (as
  ``run_partitioned`` keeps them);
- ``stream``: one executor's ``process_stream`` over the 4 buffers, no
  runtime (its pipeline keeps one batch in flight while it finishes the
  previous one);
- ``serial``: one executor's ``process_buffer`` over each buffer.

Then, per batch and with the card drained between phases, the host time
of dispatch and of finish through the runtime and through the bare
executor (the swap's own cost), and the device busy time of one pass of
``runtime_d2`` and ``stream`` (``torch.profiler``, kernels and copies).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import PARTITIONED, build_chain, device_time, shared_cases  # noqa: E402
from fluvio_tpu_torch.partition import (  # noqa: E402
    PartitionRuntime,
    parse_placement_rules,
    partition_key,
    plan_placement,
)
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer  # noqa: E402


def runtime_over(specs, keys):
    plan = plan_placement(parse_placement_rules(".*=spread"), keys, PARTITIONED["groups"])
    return PartitionRuntime(build_chain(specs), plan)


def ways(bufs):
    """{name: one pass as a callable} over fresh chains."""
    specs = PARTITIONED["specs"]
    keys = [partition_key("bench", p) for p in range(len(bufs))]
    stream = [("bench", p, b) for p, b in enumerate(bufs)]
    kept = []

    def interleaved(rt, depth, keep=False):
        def one():
            for *_, out in rt.process_interleaved(list(stream), depth=depth):
                if keep:
                    kept.append(out)
        return one

    plain_stream, plain_serial = build_chain(specs), build_chain(specs)
    return {
        "runtime_d2": interleaved(runtime_over(specs, keys), 2),
        "runtime_d1": interleaved(runtime_over(specs, keys), 1),
        "runtime_d0": interleaved(runtime_over(specs, keys), 0),
        "runtime_keep": interleaved(runtime_over(specs, keys), 2, keep=True),
        "stream": lambda: [None for _ in plain_stream.process_stream(bufs)],
        "serial": lambda: [plain_serial.process_buffer(b) for b in bufs],
    }, kept


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_split(bufs):
    """Median host ms of dispatch and of finish a batch, card drained
    between them, through the runtime and through the bare executor."""
    specs = PARTITIONED["specs"]
    rt = runtime_over(specs, [partition_key("bench", p) for p in range(len(bufs))])
    bare = build_chain(specs)
    out = {}
    for name, dispatch, finish in (
        ("runtime", lambda p, b: rt.dispatch("bench", p, b),
         lambda p, b, h: rt.finish("bench", p, b, h)),
        ("executor", lambda p, b: bare.dispatch_buffer(b),
         lambda p, b, h: bare.finish_buffer(b, h)),
    ):
        d_ms, f_ms = [], []
        for k in range(5):
            for p, b in enumerate(bufs):
                handle = []
                d = timed(lambda: handle.append(dispatch(p, b)))
                f = timed(lambda: finish(p, b, handle[0]))
                if k:  # the first round is the warm-up
                    d_ms.append(d * 1e3)
                    f_ms.append(f * 1e3)
        out[name] = {"dispatch_ms": statistics.median(d_ms), "finish_ms": statistics.median(f_ms)}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--passes", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("partition_breakdown: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    values = shared_cases().gen_json(PARTITIONED["records"])
    parts = PARTITIONED["partitions"]
    bufs = [RecordBuffer.from_values(values[p::parts]) for p in range(parts)]
    fns, kept = ways(bufs)
    for fn in fns.values():
        timed(fn)  # flattens each buffer once (cached) and loads the kernels
    order = list(fns)
    passes = {name: [] for name in order}
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            passes[name] += [timed(fns[name]) * 1e3 for _ in range(args.passes)]
        kept.clear()
    n = PARTITIONED["records"]
    result = {name: {"median_pass_ms": statistics.median(ms), "min_pass_ms": min(ms),
                     "records_per_s": n / statistics.median(ms) * 1e3, "pass_ms": ms}
              for name, ms in passes.items()}
    split = phase_split(bufs)
    busy = {name: device_time(fns[name], None, reps=3) for name in ("runtime_d2", "stream")}
    print(json.dumps({"device": smi, "records": n, "partitions": parts, "ways": result,
                      "per_batch": split,
                      "device_busy_ms": {k: v[0] for k, v in busy.items()},
                      "device_launches": {k: v[1] for k, v in busy.items()}}))
    for name, r in result.items():
        print(f"{name}: median {r['median_pass_ms']:.3f} ms a pass, min "
              f"{r['min_pass_ms']:.3f}, {r['records_per_s']:.0f} records/s", file=sys.stderr)
    print(f"per batch: {split}; busy {busy}; {smi}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
