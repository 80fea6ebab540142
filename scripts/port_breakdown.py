"""Where the GPU port's chains spend their time, on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/port_breakdown.py [--link] [--chain NAME ...]

``--chain headline`` (the default) drives ``regex-filter(regex="fluvio")``
-> ``json-map(field="name")`` over batches of 1,048,576 bench JSON records
(the ``chip_smoke.py`` corpus); ``3_aggregate`` (``aggregate-field``, a
running sum of the ``n`` field) and ``filter_aggregate`` drive the same
corpus, ``4_array_map`` (``array-map-json``) 1,048,576 ``gen_arrays``
records a batch (~6 elements each; the warm-up batch teaches the explode
its capacity, so no measured batch overflows); ``7_fat70k``,
``10_regex_json_fat`` and ``fluvio_dfa_json_map_fat`` drive the striped
chains of ``chip_smoke.py`` over batches of 1,024 ``gen_fat_70k`` records
(71,709 B each). Each chain
runs through ``fluvio_tpu_torch`` three ways, and each prints one JSON line:

- ``serial``: per batch, each phase alone, with the card drained between
  phases — host staging of the ragged values, with ``--link`` (the glz
  link on both ways, 256 KiB chunks) the host compressor, dispatch
  (pinned uploads and kernel enqueue, host clock), the card's span for
  the batch (CUDA events from before the first enqueue to the drain, so
  it includes waits for the host's enqueues), and the host rebuild of
  the output (finish, host clock after the copies landed);
- ``pipelined``: records/s of ``process_stream`` (what users get), and
  the CUDA kernels it launched (with ``--link`` the up link decodes
  through ``glz_decode``, one launch a batch);
- ``profile``: device busy time and share of the pipelined run's wall
  time from ``torch.profiler`` (device-side kernel and copy events only,
  top 8 by time).
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

from chip_smoke import (  # noqa: E402
    FAT_PARAMS, FAT_RECORDS, GLZ_LINK, N, SLICE_CHAINS, STRIPED_CHAINS, build_chain, gen_arrays,
    gen_fat_70k, gen_json,
)
from fluvio_tpu_torch.smartengine.gpu import cuda_kernels  # noqa: E402
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer  # noqa: E402

BATCHES = 4
SPECS = [("regex-filter", {"regex": "fluvio"}), ("json-map", {"field": "name"})]
NARROW = {"headline": SPECS, **SLICE_CHAINS}
CHAINS = {**NARROW, **STRIPED_CHAINS}


def fresh(corpora):
    """New buffers each run: the ragged staging cache must not carry over."""
    return [RecordBuffer.from_values(c) for c in corpora]


def serial(chain, corpora):
    phases = {"stage_ms": [], "compress_ms": [], "dispatch_ms": [], "device_ms": [],
              "finish_ms": []}
    for buf in fresh(corpora):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf.ragged_values()
        tc = time.perf_counter()
        if chain.link.compress:
            chain._compressed(buf)  # cached on the buffer: dispatch reuses it
        t1 = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        handle = chain.dispatch_buffer(buf)
        t2 = time.perf_counter()
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        ev1.synchronize()
        t3 = time.perf_counter()
        chain.finish_buffer(buf, handle)
        t4 = time.perf_counter()
        phases["stage_ms"].append((tc - t0) * 1e3)
        phases["compress_ms"].append((t1 - tc) * 1e3)
        phases["dispatch_ms"].append((t2 - t1) * 1e3)
        phases["device_ms"].append(ev0.elapsed_time(ev1))
        phases["finish_ms"].append((t4 - t3) * 1e3)
    return {k: statistics.median(v) for k, v in phases.items()}


def pipelined(chain, corpora):
    bufs = fresh(corpora)
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in chain.process_stream(bufs):
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(cuda_kernels.LAUNCHES)


def profile(chain, corpora):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    bufs = fresh(corpora)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in chain.process_stream(bufs):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops also report their kernels' time: count each once
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "top": [{"op": k[:60], "ms": ms, "calls": c} for k, ms, c in rows[:8]],
    }


def breakdown(name: str, smi: str, link) -> dict:
    if name in NARROW:
        chain = build_chain(NARROW[name], link=link)
        gen = gen_arrays if name == "4_array_map" else gen_json
        corpora = [gen(N, seed=100 + k) for k in range(BATCHES)]
        warm = corpora[0][:4096]
    else:
        chain = build_chain(CHAINS[name], FAT_PARAMS, link)
        corpora = [gen_fat_70k(FAT_RECORDS)] * BATCHES
        warm = corpora[0][:8]
    chain.process_buffer(RecordBuffer.from_values(warm))  # build + warm-up
    n = len(corpora[0])
    out = {"chain": name, "device": smi, "link": chain.link.any, "records_per_batch": n,
           "batches": BATCHES, "bytes_per_batch": sum(len(r) for r in corpora[0])}
    out["serial"] = serial(chain, corpora)
    wall, launches = pipelined(chain, corpora)
    out["pipelined"] = {"wall_s": wall, "records_per_s": BATCHES * n / wall,
                        "bytes_per_s": BATCHES * out["bytes_per_batch"] / wall,
                        "launches": launches}
    out["profile"] = profile(chain, corpora)
    out["link_counts"] = chain.link_counts
    out["redispatches"] = chain.redispatches
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chain", action="append", choices=sorted(CHAINS),
                        help="chain to break down (repeatable; default: headline)")
    parser.add_argument("--link", action="store_true",
                        help="turn the glz link on, both ways")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_breakdown: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for name in args.chain or ["headline"]:
        print(json.dumps(breakdown(name, smi, GLZ_LINK if args.link else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
