"""Isolation of the GPU port from the JAX package, and its device rules.

- No file of ``fluvio_tpu_torch/`` and not ``chip_smoke.py`` imports jax or
  anything of ``fluvio_tpu`` (an AST scan of every import), and no module
  of the port names a path under ``fluvio_tpu/`` in its code (the port
  builds its own copy of the glz compressor, never the JAX package's).
- With no device given and no CUDA, `SmartEngine()` raises instead of
  drifting to the CPU.
- On a machine with a card (marker ``cuda``; skipped elsewhere), each CUDA
  kernel equals its plain torch version exactly on the same inputs, and
  the aggregate and explode chains give the card the CPU's outputs.

The bench corpora and the DFA scan's cases live here, free of jax, so
that the CPU tests, the card tests and ``chip_smoke.py`` share them.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


# The bench corpora, seeded, shared by the port's tests and `chip_smoke.py`
# (jax-free, since the card's machine has no jax).
def gen_json(n: int, seed: int = 2024):
    """`bench.gen_json`: ~half the names contain "fluvio", ``n`` up to 99,999."""
    rng = np.random.default_rng(seed)
    names = ["fluvio", "kafka", "pulsar", "fluvio-tpu", "redpanda", "flink"]
    picks = rng.integers(0, len(names), size=n)
    nums = rng.integers(0, 100000, size=n)
    return [
        f'{{"name":"{names[picks[i]]}-{i & 1023}","n":{nums[i]}}}'.encode()
        for i in range(n)
    ]


def gen_arrays(n: int, seed: int = 7):
    """`bench.gen_arrays`: a JSON array of ~6 elements a record."""
    rng = np.random.default_rng(seed)
    nums = rng.integers(0, 10000, size=(n, 3))
    return [
        f'["a{i & 255}","b{nums[i][0]}",{nums[i][1]},{nums[i][2]},"x","y"]'.encode()
        for i in range(n)
    ]


# The DFA scan's cases, shared by the card test below and the CPU spec of
# the kernel's walk (`tests/test_torch_dfa_redesign.py`); jax-free, since
# the card's machine has no jax.
DFA_SCAN_WIDTHS = (1, 15, 16, 17, 64)
BIG_PATTERN = "(a|b)*a(a|b){6}c|x" + "d" * 125  # 257 states: two-byte state ids
DFA_SCAN_PATTERNS = (("flu[vV]io", True), ("^fluvio$", True),
                     ("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False),
                     (BIG_PATTERN, True), (BIG_PATTERN, False))
_DFA_TOKENS = (b"fluvio", b"fluVio", b"kafka-2", b"pulsar-3", b"fluvio-1", b"aabababc",
               b"abbbbbbc", b"xdd", b"a")


def dfa_scan_lengths(width: int):
    """The edge lengths: padded rows (-1), empty, one byte, around one
    16-byte chunk, one short of the width, the width, past it."""
    return (-1, 0, 1, 15, 16, 17, width - 1, width, width + 5)


def dfa_scan_inputs(rng, width: int, per_length: int = 16):
    """values u8[N, width], lengths i32[N]: ``per_length`` rows at each edge
    length and one row a token of exactly the token's length; bytes from
    the patterns' alphabets with a token planted at 0 or further in, and
    garbage past every length."""
    lens = list(np.repeat(dfa_scan_lengths(width), per_length))
    lens += [len(t) for t in _DFA_TOKENS]
    alphabet = np.frombuffer(b"fluvioVkapsr-0123abcxd", dtype=np.uint8)
    values = alphabet[rng.integers(0, len(alphabet), size=(len(lens), width))]
    exact = len(lens) - len(_DFA_TOKENS)
    for i, length in enumerate(lens):
        live = min(max(int(length), 0), width)
        token = _DFA_TOKENS[i % len(_DFA_TOKENS)] if i < exact else _DFA_TOKENS[i - exact]
        if live and (i % 3 or i >= exact):
            at = int(rng.integers(0, live)) if i % 2 and i < exact else 0
            seg = token[: live - at]
            values[i, at: at + len(seg)] = np.frombuffer(seg, dtype=np.uint8)
    return np.ascontiguousarray(values), np.array(lens, dtype=np.int32)


def non_invariant_tables():
    """Hand-built DFAs whose PAD column changes acceptance (the compiler
    never emits one), as ``CompiledDfa`` keyword arguments:

    - parity: PAD toggles between a rejecting and an accepting state, so
      the verdict hangs on how many PAD columns follow the record; ``a``
      toggles too, ``x`` falls into a dead sink and ``y`` into an
      absorbing accept that PAD sends to the sink;
    - flu[vV]io whose PAD column sends its accepting state to the dead
      state: a match survives only in a record at least as long as the row.
    """
    byte_class = np.zeros(256, dtype=np.int16)
    byte_class[ord("a")], byte_class[ord("x")], byte_class[ord("y")] = 1, 2, 3
    #                   other  a  x  y  EOS PAD
    parity = np.array([[0, 1, 2, 3, 0, 1],   # 0: even, rejects
                       [1, 0, 2, 3, 1, 0],   # 1: odd, accepts
                       [2, 2, 2, 2, 2, 2],   # 2: dead sink
                       [3, 3, 3, 3, 3, 2]],  # 3: absorbing accept, PAD -> sink
                      dtype=np.int16)
    from fluvio_tpu_torch.ops.regex_dfa import compile_regex

    flu = compile_regex("flu[vV]io")
    # PAD gets a column of its own (packed, it shares one with bytes)
    table = np.concatenate([flu.table, flu.table[:, [flu.pad_class]]], axis=1)
    table[flu.accept, -1] = flu.n_states - 1
    return [
        dict(table=parity, byte_class=byte_class, eos_class=4, pad_class=5,
             accept=np.array([False, True, False, True]), start=0, pattern="parity"),
        dict(table=table, byte_class=flu.byte_class.copy(), eos_class=flu.eos_class,
             pad_class=flu.n_classes, accept=flu.accept.copy(), start=flu.start,
             pattern="flu[vV]io, PAD kills the match"),
    ]


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
    # extract: random spans (overruns, negative starts, lengths past the
    # width) at widths on and off the 16-byte grid, aligned rows and not
    for ex_width in (1, 3, 15, 16, 17, 63, 64, 65, 100, 1000):
        ev = rng.integers(0, 256, size=(512, ex_width)).astype(np.uint8)
        est = torch.from_numpy(rng.integers(-ex_width - 2, 2 * ex_width + 2, 512).astype(np.int32))
        evl = torch.from_numpy(rng.integers(-2, 2 * ex_width + 2, 512).astype(np.int32))
        buf = torch.zeros(ev.size + 1, dtype=torch.uint8).cuda()
        buf[1:] = torch.from_numpy(ev.reshape(-1)).cuda()
        for vv in (torch.from_numpy(ev).cuda(), buf[1:].view(ev.shape)):
            assert torch.equal(cuda_kernels.extract_span(vv, est.cuda(), evl.cuda()),
                               kernels.extract_span(vv, est.cuda(), evl.cuda())), ex_width
    for pattern, packed in (("^(fluvio|kafka|pulsar)-[0-3]$", True), ("flu[vV]io", False)):
        dfa = compile_regex(pattern, packed=packed)
        assert torch.equal(cuda_kernels.dfa_match(v, ln, dfa), kernels.dfa_match(v, ln, dfa))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_long_keys_through_the_engine_on_the_card():
    """A 49,151-byte key (its needle past 48 KB) gives b'1' through
    ``SmartEngine(device="cuda")`` on the narrow and the striped span paths;
    a 240,000-byte key (past a block's shared memory) on the striped path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    for klen, paths in ((49151, ("json_span", "json_span_striped")),
                        (240000, ("json_span_striped",))):
        kb = b"a" * klen
        for path in paths:
            pad = b',"pad":"' + b"x" * 70000 + b'"' if path == "json_span_striped" else b""
            docs = [b'{"' + kb + b'":1' + pad + b"}", b'{"a":2' + pad + b"}"]
            b = SmartEngine(device="cuda").builder()
            b.add_smart_module(SmartModuleConfig(params={"field": kb.decode()}),
                               lookup("json-map"))
            chain = b.initialize()
            cuda_kernels.reset_launches()
            out = chain.process_buffer(RecordBuffer.from_values(docs)).value_list()
            assert cuda_kernels.LAUNCHES[path] > 0, (klen, path)
            assert out[0] == b"1", (klen, path)


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
    # a period-2 stream: every chain crosses every tile border of its chunk
    p0 = torch.from_numpy(np.where(np.arange(150000) % 2 == 0, 7, 9).astype(np.int32)).cuda()
    p1 = torch.zeros_like(p0)
    for a, b in ((w0, w1), (p0, p1)):
        for chunk_groups in (128, 512, 2048, 2176, 32768, 65536, 131072):
            const_m, _ = glz.enc_const_runs(a, b, chunk_groups)
            assert torch.equal(cuda_kernels.glz_encode_match(a, b, const_m, chunk_groups),
                               kernels.glz_encode_match(a, b, const_m, chunk_groups))
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


@pytest.mark.cuda
def test_dfa_scan_redesign_on_the_card():
    """The DFA scan kernel against its plain version on the cases of its
    CPU spec: the compiled patterns (8 to 257 states, packed and unpacked)
    and the hand-built tables whose PAD column changes acceptance (the
    kernel's tail walk), at every edge length, at widths 1 to 64, on
    16-byte aligned rows and on rows one byte off; a table the kernel does
    not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.ops.regex_dfa import CompiledDfa, compile_regex
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels, kernels

    dfas = [compile_regex(p, packed=packed) for p, packed in DFA_SCAN_PATTERNS]
    dfas += [CompiledDfa(**t) for t in non_invariant_tables()]
    rng = np.random.default_rng(70)
    for width in DFA_SCAN_WIDTHS:
        values, lengths = dfa_scan_inputs(rng, width)
        v, ln = torch.from_numpy(values).cuda(), torch.from_numpy(lengths).cuda()
        buf = torch.zeros(values.size + 1, dtype=torch.uint8).cuda()
        buf[1:] = v.reshape(-1)
        for dfa in dfas:
            for vv in (v, buf[1:].view(values.shape)):
                assert torch.equal(cuda_kernels.dfa_match(vv, ln, dfa),
                                   kernels.dfa_match(vv, ln, dfa)), (dfa.pattern[:24], width)
    bad = CompiledDfa(**non_invariant_tables()[0])
    bad.table[0, 0] = 9  # a state id past the table
    with pytest.raises(ValueError):
        cuda_kernels.dfa_match(v, ln, bad)
    torch.cuda.synchronize()


def _slice_chain(device: str, *names: str):
    from fluvio_tpu_torch.models import lookup
    from fluvio_tpu_torch.smartengine import SmartEngine, SmartModuleConfig

    b = SmartEngine(device=device).builder()
    for name in names:
        b.add_smart_module(SmartModuleConfig(params={"field": "n"}), lookup(name))
    return b.initialize()


@pytest.mark.cuda
def test_aggregate_and_explode_chains_on_the_card():
    """`3_aggregate`'s chain (the JSON span and extract kernels launched
    every batch) and ``array-map-json -> aggregate-count`` (the first batch
    overflows and runs again) over three batches through
    ``SmartEngine(device="cuda")``: outputs, keys and carries equal the
    same chains on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    from fluvio_tpu_torch.smartengine.gpu import cuda_kernels
    from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer

    cases = (
        (("aggregate-field",), gen_json, (5000, 17, 3000)),
        (("array-map-json", "aggregate-count"), gen_arrays, (4000, 9, 2500)),
        (("array-map-json",), gen_arrays, (4000, 9, 2500)),
    )
    for names, gen, sizes in cases:
        outs = {}
        for device in ("cpu", "cuda"):
            chain = _slice_chain(device, *names)
            cuda_kernels.reset_launches()
            bufs = [RecordBuffer.from_values(gen(n, seed=n)) for n in sizes]
            outs[device] = [(o.value_list(), o.key_list(), o.offset_deltas[: o.count].tolist())
                            for o in chain.process_stream(bufs)]
            chain._ensure_host_state()
            outs[device].append((chain.carries, chain.redispatches))
        assert outs["cuda"] == outs["cpu"], names
        if names == ("aggregate-field",):
            assert cuda_kernels.LAUNCHES["json_span"] == cuda_kernels.LAUNCHES["extract"] == 3
        else:
            assert outs["cuda"][-1][1] >= 1
