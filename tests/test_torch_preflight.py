"""The port's preflight (`fluvio_tpu_torch.analysis`) against runtime truth
and against the JAX package's preflight, on the CPU; and the port's
cluster preflight checks.

- For every config of ``bench.py``'s matrix, the port's predicted path at
  the corpus's width equals the path the port's telemetry observed when
  the chain ran (the per-path record counters, or the `GpuSpill` reason
  on the spill counter for a raise), and where the JAX preflight predicts
  ``fused`` or ``striped`` the port's prediction equals it.
- At small stripes (64-byte threshold and stripes, 16 overlap) the width
  ladder's three outcomes on chains with and without a striped lowering:
  fused, striped, and a raise with ``record-too-wide-unstripeable``.
- ``resolve_gates`` reports the engine's settings; the preflight moves no
  counter.
- `cluster.check`'s engine check reports a missing CUDA (and a failed
  kernel build) without raising.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fluvio_tpu.analysis import preflight_for_specs as ref_preflight_for_specs
from fluvio_tpu.analysis.spec import resolve_gates as ref_resolve_gates
from fluvio_tpu_torch.analysis import analyze_named, preflight_for_specs, resolve_gates
from fluvio_tpu_torch.cluster import ClusterChecker
from fluvio_tpu_torch.cluster import check as cluster_check
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol.record import Record
from fluvio_tpu_torch.smartengine import (
    GpuSpill,
    LinkParams,
    SmartEngine,
    SmartModuleConfig,
    StripeParams,
)
from fluvio_tpu_torch.smartengine.gpu import native
from fluvio_tpu_torch.smartmodule import SmartModuleInput
from fluvio_tpu_torch.telemetry import TELEMETRY
from tests.test_analysis import _BENCH_SMALL_N, _bench
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

SMALL = StripeParams(threshold=64, width=64, overlap=16)


def _chain(specs, engine):
    b = engine.builder()
    for name, params in specs:
        b.add_smart_module(SmartModuleConfig(params=dict(params or {})), lookup(name))
    return b.initialize()


def _observe(chain, values, ts=None) -> tuple:
    """(observed path, spill reasons) of one input through the port."""
    records = [Record(value=v) for v in values]
    for i, r in enumerate(records):
        r.offset_delta = i
        if ts is not None:
            r.timestamp_delta = int(ts[i])
    inp = SmartModuleInput.from_records(records, base_timestamp=1_000_000 if ts is not None else -1)
    paths0, spills0 = TELEMETRY.path_records(), dict(TELEMETRY.spills)
    raised = None
    try:
        chain.process(inp)
    except GpuSpill as e:
        raised = e.reason
    grew = {k: v - paths0.get(k, 0) for k, v in TELEMETRY.path_records().items()
            if v - paths0.get(k, 0) > 0}
    spilled = sorted(k for k, v in TELEMETRY.spills.items() if v - spills0.get(k, 0) > 0)
    if raised is not None:
        assert not grew and spilled == [raised]
        return "raise", spilled
    assert len(grew) == 1 and not spilled, (grew, spilled)
    return next(iter(grew)), spilled


@pytest.mark.parametrize("name", list(_bench().CONFIGS))
def test_bench_matrix_predicted_path_matches_observed_and_the_reference(name):
    cfg = _bench().CONFIGS[name]
    n = _BENCH_SMALL_N.get(name, 48)
    values = cfg["corpus"](n)
    ts = cfg["ts"](n) if "ts" in cfg else None
    width = max(len(v) for v in values)
    pred = preflight_for_specs(cfg["specs"], width, engine=SmartEngine(device="cpu"))
    observed, spilled = _observe(_chain(cfg["specs"], SmartEngine(device="cpu")), values, ts)
    assert pred["path"] == observed, (name, pred, observed)
    assert pred.get("spill_reasons", []) == spilled
    ref = ref_preflight_for_specs(cfg["specs"], width)
    if ref["path"] in ("fused", "striped"):
        assert pred["path"] == ref["path"], (name, pred, ref)
    assert pred["link_variant"] == ref["link_variant"] == "raw"


LADDER = {
    "headline": [("regex-filter", {"regex": "fluvio"}), ("json-map", {"field": "name"})],
    "flu_regex": [("regex-filter", {"regex": "flu[vV]io"})],
    "striped_aggregate": [("regex-filter", {"regex": "flu[vV]io"}), ("aggregate-sum", {})],
    "striped_explode": [("regex-filter", {"regex": "flu[vV]io"}), ("array-map-lines", {})],
    "aggregate_field": [("aggregate-field", {"field": "n", "combine": "add"})],
    "word_count": [("word-count", {})],
    "json_explode": [("array-map-json", None)],
}


def _ladder_values(name: str, width: int):
    rng = np.random.default_rng(width)
    if name in ("aggregate_field", "json_explode"):
        body = b'{"n":%d,"pad":"' if name == "aggregate_field" else b'[%d,"'
        tail = b'"}' if name == "aggregate_field" else b'"]'
        out = []
        for k in range(12):
            head = body % int(rng.integers(0, 99))
            out.append(head + b"x" * max(width - len(head) - len(tail), 0) + tail)
        return out
    words = [b"fluvio", b"fluVio", b"kafka", b"12", b"7"]
    out = []
    for k in range(12):
        rec = b""
        while len(rec) < width:
            rec += words[int(rng.integers(0, len(words)))] + (b"\n" if k % 2 else b" ")
        out.append(rec[:width])
    return out


@pytest.mark.parametrize("width", [40, 300])
@pytest.mark.parametrize("name", sorted(LADDER))
def test_width_ladder_at_small_stripes_matches_observed(name, width):
    engine = SmartEngine(device="cpu", stripes=SMALL)
    report = analyze_named(LADDER[name], widths=(width,), engine=engine)
    pred = report.predictions[0]
    observed, spilled = _observe(_chain(LADDER[name], engine), _ladder_values(name, width))
    assert pred.path == observed, (name, width, pred.to_dict(), observed)
    assert list(pred.spill_reasons) == spilled
    if width == 40:
        assert pred.path == "fused"
    if pred.path == "raise":
        assert [h.code for h in report.errors()] == ["spill:record-too-wide-unstripeable"]


def test_hard_ceiling_and_unlowerable_predictions():
    pred = preflight_for_specs([("regex-filter", {"regex": "fluvio"})], (1 << 20) + 1)
    assert pred["path"] == "raise" and pred["spill_reasons"] == ["record-too-wide"]
    from fluvio_tpu_torch.analysis import analyze_entries
    from fluvio_tpu_torch.models.dedup_filter import SOURCE
    from fluvio_tpu_torch.smartmodule import load_source

    dedup = load_source(SOURCE, name="dedup-filter")  # a Python hook, no DSL program
    report = analyze_entries([(dedup, SmartModuleConfig(params={"count": "8"}))], widths=(10,))
    assert report.chain_sig == "unlowerable" and report.predictions[0].path == "raise"
    assert [h.code for h in report.errors()] == ["unlowerable"]
    json_explode = analyze_named([("array-map-json", None)])
    assert [h.code for h in json_explode.hazards if h.level == "info"] == [
        "data-dependent-spill"]
    # past the stripe threshold the explode runs striped
    assert json_explode.to_dict()["predictions"][1]["path"] == "striped"


NEWLY_STRIPED = {
    "array-map-json": [("array-map-json", None)],
    "filter-array-map-json": [("regex-filter", {"regex": "flu[vV]io"}), ("array-map-json", None)],
    "word-count": [("word-count", None)],
    "aggregate-field": [("aggregate-field", {"field": "n"})],
    "json-map-aggregate-sum": [("json-map", {"field": "name"}), ("aggregate-sum", None)],
    "json-map-word-count": [("json-map", {"field": "name"}), ("word-count", None)],
}


@pytest.mark.parametrize("name", sorted(NEWLY_STRIPED))
def test_newly_striped_chains_predict_striped_where_the_reference_spills(name):
    """Past the stripe threshold the port's preflight predicts ``striped``
    for the chains its striped path took over; the JAX preflight predicts
    its interpreter spill for the same chains (a pinned difference: the
    JAX package has no striped lowering for them)."""
    specs = NEWLY_STRIPED[name]
    width = (1 << 16) + 1
    pred = preflight_for_specs(specs, width, engine=SmartEngine(device="cpu"))
    assert pred["path"] == "striped" and not pred.get("spill_reasons")
    ref = ref_preflight_for_specs(specs, width)
    assert ref["path"] == "interpreter"
    assert ref["spill_reasons"] == ["record-too-wide-unstripeable"]


def test_key_rewrite_predicts_the_striped_path():
    """A key rewrite lowers striped since its computed map: past the
    threshold the port's preflight predicts ``striped``, with no spill."""
    from fluvio_tpu_torch.analysis import analyze_entries
    from tests.test_torch_chain import _module_pair
    from tests.test_torch_striped_slice import KEY_REWRITE

    (kind, build), params = KEY_REWRITE
    module = _module_pair(kind, build)[1]
    report = analyze_entries([(module, SmartModuleConfig(params=params))],
                             widths=((1 << 16) + 1,))
    assert report.predictions[0].path == "striped"
    assert not report.predictions[0].spill_reasons and not report.errors()


def _rekey(d, value):
    return d.FilterMapProgram(predicate=d.RegexMatch(arg=d.Value(), pattern="flu[vV]io"),
                              value=value, key=d.JsonGet(arg=d.Value(), key="name"))


WIDE_PATHS = {
    # the four regexes past the JAX package's TPU gate, over the record
    "log-scan": ("regex-filter",
                 {"regex": "(ERROR|WARN|FATAL|CRIT).*(timeout|refused|reset|denied|unreachable)"},
                 b"ERROR connection refused", "striped"),
    "access-log": ("regex-filter",
                   {"regex": '(GET|POST|PUT|DELETE) /api/v[0-9]+/(users|orders|items)/[0-9]+ '
                             'HTTP/1\\.[01]" (4|5)[0-9][0-9]'},
                   b'PUT /api/v3/items/7 HTTP/1.0" 500', "striped"),
    "dated-fluvio": ("regex-filter", {"regex": "flu[vV]io.{0,16}[0-9]{4}-[0-9]{2}-[0-9]{2}"},
                     b"fluvio 2026-10-18", "striped"),
    "ab-six": ("regex-filter", {"regex": "(a|b)*a(a|b){6}"}, b"abababa", "striped"),
    # a re-key by a field: striped; a value holding the whole record: a raise
    "rekey": (("filter_map", lambda d: _rekey(d, d.Concat(args=[
        d.Const(data=b"<"), d.JsonGet(arg=d.Value(), key="name"), d.Const(data=b">")]))),
        {}, b'{"name":"fluvio"}', "striped"),
    "whole-record-value": (("filter_map", lambda d: _rekey(d, d.Concat(args=[
        d.Value(), d.Const(data=b"!")]))), {}, b'{"name":"fluvio"}', "raise"),
}


@pytest.mark.parametrize("name", sorted(WIDE_PATHS))
def test_wide_batch_predictions_follow_the_striped_lowering(name):
    """At small stripes, past the threshold: the preflight's path equals
    the path the chain takes, and the warm-up stages the wide bucket
    exactly where that path is ``striped`` (it skips it with the raise's
    reason where not)."""
    from fluvio_tpu_torch import admission
    from fluvio_tpu_torch.analysis import analyze_entries
    from tests.test_torch_chain import _module_pair

    spec, params, hit, want = WIDE_PATHS[name]
    module = lookup(spec) if isinstance(spec, str) else _module_pair(*spec)[1]
    engine = SmartEngine(device="cpu", stripes=SMALL)
    entries = [(module, SmartModuleConfig(params=dict(params)))]
    pred = analyze_entries(entries, widths=(300,), engine=engine).predictions[0]
    chain = engine.builder().add_smart_module(entries[0][1], module).initialize()
    pad = b"_" * (300 - len(hit))
    values = [pad + hit, hit + pad, pad, b"short"]
    observed, spilled = _observe(chain, values)
    assert pred.path == observed == want, (pred.to_dict(), observed)
    assert list(pred.spill_reasons) == spilled
    report = admission.warm_executor(chain.gpu_chain, widths=(40, 300), rows=8)
    assert report.errors == []
    if want == "striped":
        assert report.skipped == [] and len(report.buckets) == 2
    else:
        assert report.skipped == ["width 300: record-too-wide-unstripeable"]


CUT_RUNS = {
    "lines_lines": [("array-map-lines", None), ("array-map-lines", None)],
    "json_lines": [("array-map-json", None), ("array-map-lines", None)],
    "windowed_after_explode": [("array-map-lines", None), ("windowed-sum", {"window_ms": "100"})],
}


@pytest.mark.parametrize("name", sorted(CUT_RUNS))
def test_cut_run_reports_its_card_segments(name):
    """A DSL run that does not lower as one chain is predicted as the card
    segments `initialize` cuts it into, not as a raise: their signatures,
    an INFO ``cut`` hazard, no error, and the path the chain runs."""
    engine = SmartEngine(device="cpu")
    specs = CUT_RUNS[name]
    report = analyze_named(specs, widths=(40,), engine=engine)
    chain = _chain(specs, engine)
    assert report.segments == [seg._chain_sig for seg in chain.segments]
    assert len(report.segments) == 2 and report.chain_sig == "|".join(report.segments)
    assert not report.errors()
    assert "cut" in [h.code for h in report.hazards if h.level == "info"]
    values = [b"[1,2]", b'["a\\nb","c"]'] if name == "json_lines" else [b"1\n2", b"3"]
    observed, spilled = _observe(chain, values, ts=[5, 9, 11][: len(values)])
    assert report.predictions[0].path == observed == "fused" and not spilled
    assert report.to_dict()["segments"] == report.segments


def test_gates_report_the_engine_settings_and_move_no_counter():
    counters = (TELEMETRY.path_records(), dict(TELEMETRY.spills), dict(TELEMETRY.declines),
                TELEMETRY.device)
    engine = SmartEngine(device="cpu", stripes=SMALL,
                         link=LinkParams(compress=True, result_compress=True))
    gates = resolve_gates(engine)
    assert gates == {
        "cuda_available": torch.cuda.is_available(), "device": "cpu",
        "stripe_threshold": 64, "stripe_width": 64, "stripe_overlap": 16,
        "max_record_width": 1 << 20, "link_compress": True, "result_compress": True,
        "link_chunk": engine.link.chunk, "window_delta": True}
    defaults = resolve_gates()
    ref = ref_resolve_gates()
    for key in ("stripe_threshold", "max_record_width"):
        assert defaults[key] == ref[key], key
    assert defaults["window_delta"] == ref["window_delta"]
    assert not defaults["link_compress"] and not ref["link_compress"]
    preds = analyze_named(LADDER["headline"], widths=(40, 300), engine=engine).predictions
    assert [p.link_variant for p in preds] == ["glz-plain", "glz-plain"]
    assert (TELEMETRY.path_records(), dict(TELEMETRY.spills), dict(TELEMETRY.declines),
            TELEMETRY.device) == counters


def test_engine_check_reports_a_missing_cuda_without_raising(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    results = {r.name: r for r in ClusterChecker.local_preflight(str(tmp_path / "d"), [0]).run()}
    assert set(results) == {"python", "engine", "data-dir", "port-0"}
    assert results["python"].ok and results["data-dir"].ok and results["port-0"].ok
    assert not results["engine"].ok and "CUDA is not available" in results["engine"].message
    with pytest.raises(RuntimeError, match="preflight failed: engine: CUDA"):
        ClusterChecker.local_preflight(str(tmp_path / "d")).run_or_fail()
    # with a card but no nvcc the kernel build fails: reported, not raised
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_nvcc():
        raise native.KernelBuildError("nvcc not found")

    monkeypatch.setattr(native.KERNELS, "build", no_nvcc)
    engine = cluster_check._check_engine_stack()
    assert not engine.ok and engine.message == "KernelBuildError: nvcc not found"
