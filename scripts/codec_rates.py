"""Host rates of the port's lz4 and snappy codecs: the native library
(`protocol/native_codecs.py` over `native/codecs.cpp`) against the
pure-Python plain versions (`protocol/lz4_py.py`, `protocol/snappy_py.py`).

Run from the repository root (no card needed; the library builds with g++
at first use):

    python3 scripts/codec_rates.py [--records N] [--reps R]

The data is the bench's JSON corpus (`gen_json`, seed 2024). Each codec
compresses and decompresses it whole (one call) and in the producer's
16 KiB batches (one call a batch, as a compressed topic's consume slice
decompresses them); the pure-Python codecs decompress the batches of the
first 32,768 records only. Rates are MB/s of uncompressed bytes, the
median of ``R`` repetitions. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fluvio_tpu_torch.protocol import lz4_py, native_codecs, snappy_py  # noqa: E402

BATCH_BYTES = 16 * 1024  # the default ProducerConfig's batch size
PLAIN_RECORDS = 32_768


def gen_json(n: int, seed: int = 2024):
    """`tests/test_torch_isolation.gen_json`, loaded by path (jax-free)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_isolation_cases", REPO / "tests" / "test_torch_isolation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gen_json(n, seed)


def batches(values, limit: int):
    out, cur, size = [], [], 0
    for v in values:
        cur.append(v)
        size += len(v)
        if size >= limit:
            out.append(b"".join(cur))
            cur, size = [], 0
    if cur:
        out.append(b"".join(cur))
    return out


def rate(fn, items, nbytes: int, reps: int) -> float:
    """MB/s of ``nbytes`` uncompressed bytes: ``fn`` over every item, the
    median of ``reps`` runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for x in items:
            fn(x)
        times.append(time.perf_counter() - t0)
    return nbytes / statistics.median(times) / 1e6


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--records", type=int, default=1 << 20)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    values = gen_json(args.records)
    whole = b"".join(values)
    parts = batches(values, BATCH_BYTES)
    n_plain = len(batches(values[:PLAIN_RECORDS], BATCH_BYTES))
    plain_bytes = sum(len(p) for p in parts[:n_plain])
    codecs = {
        "lz4": (native_codecs.lz4_compress, native_codecs.lz4_decompress, lz4_py),
        "snappy": (native_codecs.snappy_compress, native_codecs.snappy_decompress, snappy_py),
    }
    out = {"records": args.records, "bytes": len(whole), "batches": len(parts)}
    for name, (comp, decomp, plain) in codecs.items():
        c_whole = comp(whole)
        c_parts = [comp(p) for p in parts]
        out[name] = {
            "ratio": len(whole) / sum(len(c) for c in c_parts),
            "compress_whole_mb_s": rate(comp, [whole], len(whole), args.reps),
            "decompress_whole_mb_s": rate(decomp, [c_whole], len(whole), args.reps),
            "compress_batches_mb_s": rate(comp, parts, len(whole), args.reps),
            "decompress_batches_mb_s": rate(decomp, c_parts, len(whole), args.reps),
            "plain_decompress_batches_mb_s": rate(plain.decompress, c_parts[:n_plain],
                                                  plain_bytes, 1),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
