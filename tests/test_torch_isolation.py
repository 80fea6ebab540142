"""Isolation of the GPU port from the JAX package, and its device rules.

- No file of ``fluvio_tpu_torch/`` and not ``chip_smoke.py`` imports jax or
  anything of ``fluvio_tpu`` (an AST scan of every import), and no module
  of the port names a path under ``fluvio_tpu/`` in its code (the port
  builds its own copy of the glz compressor, never the JAX package's).
- With no device given and no CUDA, `SmartEngine()` raises instead of
  drifting to the CPU.
- On a machine with a card (marker ``cuda``; skipped elsewhere), each CUDA
  kernel equals its plain torch version exactly on the same inputs.
"""

from __future__ import annotations

import ast
import re
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


def _code_strings(path: Path):
    """(line, text) of every string literal in a module except docstrings."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            yield node.lineno, node.value


def test_port_names_no_path_under_fluvio_tpu():
    files = sorted((REPO / "fluvio_tpu_torch").rglob("*.py"))
    under = re.compile(r"(^|[/\\])fluvio_tpu([/\\]|$)")
    bad = [
        f"{path.relative_to(REPO)}:{line}: {text!r}"
        for path in files
        for line, text in _code_strings(path)
        if under.search(text)
    ]
    assert not bad, bad
    from fluvio_tpu_torch.smartengine.gpu import glz

    assert glz._SOURCE == REPO / "fluvio_tpu_torch" / "native" / "glz.cpp"


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
    # both designs of the span kernel: a thread a record up to 512-byte rows,
    # a warp a record past them; widths off the 16-byte grid take byte loads
    alphabet = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)
    for span_width in (64, 100, 512, 544, 1000, 1024):
        span_docs = [
            b'{"pad":"%s","name":"kafka-%d","n":%d}' % (b"p" * int(rng.integers(0, span_width - 40)),
                                                        i, i) if i % 3 == 0 else
            b'{"pad":"%s","n":%d}' % (b"q" * int(rng.integers(0, span_width - 20)), i) if i % 3 == 1
            else alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(0, span_width + 1)))]
            .tobytes()
            for i in range(300)
        ] + [(b'{"name":"' + b"y" * span_width)[:span_width], (b'{"name":' + b"7" * span_width)[:span_width]]
        sv_, sl_ = np.zeros((len(span_docs), span_width), np.uint8), np.zeros(len(span_docs), np.int32)
        for i, d in enumerate(span_docs):
            sv_[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
            sl_[i] = len(d)
        sv_t, sl_t = torch.from_numpy(sv_).cuda(), torch.from_numpy(sl_).cuda()
        for key in ("name", "n", ""):
            got = cuda_kernels.json_get_span(sv_t, sl_t, key)
            want = kernels.json_get_span(sv_t, sl_t, key)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (span_width, key)
    # a 45,000-byte key: the needle takes the kernels past 48 KB of shared memory
    from fluvio_tpu_torch.smartmodule import dsl

    long_key = "k" * 45000
    long_docs = [b'{"' + long_key.encode() + b'":"v"}', b'{"a":1}', b'{"' + long_key.encode() + b'x":2}']
    for span_width in (64, 45016):
        lv = np.zeros((len(long_docs), span_width), np.uint8)
        ll = np.array([min(len(d), span_width) for d in long_docs], np.int32)
        for i, d in enumerate(long_docs):
            lv[i, : ll[i]] = np.frombuffer(d[: ll[i]], dtype=np.uint8)
        st_l, vl_l = cuda_kernels.json_get_span(torch.from_numpy(lv).cuda(),
                                                torch.from_numpy(ll).cuda(), long_key)
        got = [bytes(lv[i, a: a + b]) for i, (a, b) in enumerate(zip(st_l.tolist(), vl_l.tolist()))]
        assert got == [dsl.json_get_bytes(bytes(lv[i, : ll[i]]), long_key) for i in range(3)]
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
    # late keys over many stripes, missing keys, garbage
    docs += [b'{"pad":"' + b"p" * int(rng.integers(500, 1500)) + b'","name":"late-%d"}' % i
             for i in range(40)]
    docs += [b'{"pad":"' + b"p" * int(rng.integers(500, 1500)) + b'","n":%d}' % i for i in range(20)]
    alphabet = np.frombuffer(b'{}[]":,\\ \tabndx1', dtype=np.uint8)
    docs += [alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(40, 800)))].tobytes()
             for _ in range(40)]
    buf = RecordBuffer.from_values(docs)
    flat, _ = buf.ragged_values()
    # 64-byte stripes (16-byte loads) and 68-byte ones (byte loads)
    for width, overlap in ((64, 16), (68, 20)):
        params = stripes.StripeParams(threshold=64, width=width, overlap=overlap)
        lengths = torch.from_numpy(buf.lengths).cuda()
        plan, sv, kmax = stripes.stage_rows(
            torch.from_numpy(np.ascontiguousarray(flat).view(np.int32)).cuda(), lengths,
            buf.lengths, buf.count, params,
            stripes.plan_rows(buf.lengths, buf.count, width, overlap) + 8,
        )
        args = (sv, stripes.owned_lengths(plan), plan["first_row"], plan["k"], lengths)
        for key in ("name", "n", ""):
            got = cuda_kernels.striped_json_span(*args, key, kmax, params.step)
            want = kernels.striped_json_span(*args, key, kmax, params.step)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (width, key)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_glz_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
    from fluvio_tpu_torch.smartengine.gpu.executor import pad_glz_tokens

    rng = np.random.default_rng(6)
    docs = b"".join(b'{"name":"fluvio-%d","n":%d}' % (i & 63, rng.integers(0, 9999))
                    for i in range(20000))
    raw = np.frombuffer(docs, np.uint8)
    for chunk in (4096, 16384, 262144):
        comp, reason = glz.compress_link(raw, max_ratio=1.0, chunk=chunk)
        assert comp is not None, reason
        ll, ml, srcs, lits = (torch.from_numpy(a).cuda() for a in pad_glz_tokens(comp))
        base, midx = glz.byte_plan_device(ll, ml, srcs, lits, comp.out_len)
        got = cuda_kernels.glz_resolve(base, midx, chunk)
        assert torch.equal(got, kernels.glz_resolve(base, midx, chunk))
        assert torch.equal(got.cpu(), torch.from_numpy(raw.copy()))
    stream = torch.from_numpy(raw[: len(raw) // 8 * 8].copy()).cuda()
    w0, w1 = glz.enc_group_words(stream)
    for chunk_groups in (128, 512, 32768, 65536):
        const_m, _ = glz.enc_const_runs(w0, w1, chunk_groups)
        assert torch.equal(cuda_kernels.glz_encode_match(w0, w1, const_m, chunk_groups),
                           kernels.glz_encode_match(w0, w1, const_m, chunk_groups))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_redesigned_kernels_on_the_card():
    """The column-split composition at the geometries its segment length
    gives (T < L, T not a multiple of L, several segments a warp, a
    segment over several warps, several segments a row), and the fused
    token-to-byte decode on padded and bare tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, glz, kernels
    from fluvio_tpu_torch.smartengine.gpu.executor import pad_glz_tokens

    rng = np.random.default_rng(44)
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", True),
                            ("(a|b)*a(a|b){2}c", True), ("x" + "d" * 40, True),
                            ("(a|b)*a(a|b){5}c", False),
                            ("(a|b)*a(a|b){6}c|x" + "d" * 125, False)):
        dfa = compile_regex(pattern, packed=packed)
        table_t = torch.from_numpy(np.ascontiguousarray(dfa.table.T, dtype=np.int32)).cuda()
        for rows, t_len in ((301, 77), (40, 20), (17, 1000), (64, 8192)):
            cls = rng.integers(0, dfa.n_classes, size=(rows, t_len)).astype(np.int32)
            cls[::3, t_len // 4: t_len // 2] = -1
            cls[0] = -1
            c = torch.from_numpy(cls).cuda()
            assert torch.equal(cuda_kernels.dfa_compose_columns(c, table_t),
                               kernels.dfa_compose_columns(c, table_t))
    docs = b"".join(b'{"name":"fluvio-%d","n":%d}' % (i & 63, rng.integers(0, 9999))
                    for i in range(20000))
    raw = np.frombuffer(docs, np.uint8)
    for chunk in (4096, 65536, 262144):
        comp, _ = glz.compress_link(raw, max_ratio=1.0, chunk=chunk)
        for arrays in (pad_glz_tokens(comp), comp[:4]):
            ll, ml, srcs, lits = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
            got = cuda_kernels.glz_decode(ll, ml, srcs, lits, comp.out_len, chunk, comp.depth)
            assert torch.equal(got, glz.decode_plain(ll, ml, srcs, lits, comp.out_len, chunk))
            assert torch.equal(got.cpu(), torch.from_numpy(raw.copy()))
    torch.cuda.synchronize()
