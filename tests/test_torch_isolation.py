"""Isolation of the GPU port from the JAX package, and its device rules.

- No file of ``fluvio_tpu_torch/`` and not ``chip_smoke.py`` imports jax or
  anything of ``fluvio_tpu`` (an AST scan of every import).
- With no device given and no CUDA, `SmartEngine()` raises instead of
  drifting to the CPU.
- On a machine with a card (marker ``cuda``; skipped elsewhere), each CUDA
  kernel equals its plain torch version exactly on the same inputs.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value)


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "fluvio_tpu")


def test_port_imports_no_jax_and_nothing_of_fluvio_tpu():
    files = sorted((REPO / "fluvio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{path.relative_to(REPO)}:{line}: {module}"
        for path in files
        for line, module in _imported_modules(path)
        if _forbidden(module)
    ]
    assert not bad, bad


def test_engine_without_cuda_raises(monkeypatch):
    from fluvio_tpu_torch.smartengine import EngineError, SmartEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError):
        SmartEngine()
    with pytest.raises(EngineError):
        SmartEngine(device="cuda")
    assert SmartEngine(device="cpu").device == "cpu"


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels

    rng = np.random.default_rng(3)
    n, width = 4096, 64
    names = [b"fluvio", b"kafka", b"pulsar", b"flink"]
    docs = [
        b'{"name":"%s-%d","n":%d}' % (names[i % 4], i % 7, i) if i % 5 else
        rng.integers(32, 127, size=int(rng.integers(0, width + 1))).astype(np.uint8).tobytes()
        for i in range(n)
    ]
    values = np.zeros((n, width), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, d in enumerate(docs):
        values[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    v = torch.from_numpy(values).cuda()
    ln = torch.from_numpy(lengths).cuda()
    st_k, vl_k = cuda_kernels.json_get_span(v, ln, "name")
    st_p, vl_p = kernels.json_get_span(v, ln, "name")
    assert torch.equal(st_k, st_p) and torch.equal(vl_k, vl_p)
    assert torch.equal(cuda_kernels.extract_span(v, st_k, vl_k), kernels.extract_span(v, st_k, vl_k))
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False)):
        dfa = compile_regex(pattern, packed=packed)
        assert torch.equal(cuda_kernels.dfa_match(v, ln, dfa), kernels.dfa_match(v, ln, dfa))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_striped_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels, stripes
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    rng = np.random.default_rng(4)
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False),
                            ("(a|b)*a(a|b){6}c|x" + "d" * 125, False)):
        dfa = compile_regex(pattern, packed=packed)
        cls = rng.integers(-1, dfa.n_classes, size=(301, 77)).astype(np.int32)
        cls[:, 10:50] = -1
        c = torch.from_numpy(cls).cuda()
        table_t = torch.from_numpy(np.ascontiguousarray(dfa.table.T, dtype=np.int32)).cuda()
        assert torch.equal(cuda_kernels.dfa_compose_columns(c, table_t),
                           kernels.dfa_compose_columns(c, table_t))
    docs = [b'{"pad":"' + b"p" * int(rng.integers(0, 600)) + b'","name":"fluvio-%d"}' % i
            for i in range(200)] + [b'{"name":' + b"7" * 500, b'{"pad":"' + b"q" * 700 + b'"}']
    buf = RecordBuffer.from_values(docs)
    flat, _ = buf.ragged_values()
    params = stripes.StripeParams(threshold=64, width=64, overlap=16)
    lengths = torch.from_numpy(buf.lengths).cuda()
    plan, sv, kmax = stripes.stage_rows(
        torch.from_numpy(np.ascontiguousarray(flat).view(np.int32)).cuda(), lengths,
        buf.lengths, buf.count, params, stripes.plan_rows(buf.lengths, buf.count, 64, 16) + 8,
    )
    args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], lengths)
    got = cuda_kernels.striped_json_span(*args, "name", kmax, params.step)
    want = kernels.striped_json_span(*args, "name", kmax, params.step)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
