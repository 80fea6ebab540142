"""Whole chains with the glz link on: the port's SmartEngine (on the CPU)
against the JAX package's ``backend="tpu"`` SmartEngine (JAX on the CPU,
its glz Pallas kernels in interpret mode), over the same staged columns.

The JAX side reads its link switches from the environment when its chain
is built, so each test sets them with monkeypatch first; the port takes a
`LinkParams`. Both use 16 KiB link chunks. Outputs must be equal exactly:
count, values, keys, lengths, offset and timestamp deltas. The port's
`link_counts` must show the form each batch took.
"""

from __future__ import annotations

import numpy as np
import pytest

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.smartengine import (
    EngineError,
    LinkParams,
    SmartEngine,
    SmartModuleConfig,
    StripeParams,
)
from fluvio_tpu_torch.smartengine.gpu import glz
from fluvio_tpu_torch.smartengine.gpu.buffer import RecordBuffer
from tests.test_torch_chain import HEADLINE, _assert_equal, _port_buffer, _ref_buffer
from tests.test_torch_isolation import gen_json
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401
from tests.test_torch_stripes import PARAMS, _json_corpus

CHUNK = 16 * 1024
LINK = LinkParams(compress=True, result_compress=True, chunk=CHUNK)


@pytest.fixture
def ref_link(monkeypatch):
    monkeypatch.setenv("FLUVIO_LINK_COMPRESS", "on")
    monkeypatch.setenv("FLUVIO_RESULT_COMPRESS", "on")
    monkeypatch.setenv("FLUVIO_GLZ_PALLAS", "interpret")
    monkeypatch.setenv("FLUVIO_GLZ_ENC_PALLAS", "interpret")
    monkeypatch.setenv("FLUVIO_GLZ_CHUNK", str(CHUNK))


def _port_chain(specs, link, stripes=None):
    pb = SmartEngine(device="cpu", link=link, stripes=stripes or StripeParams()).builder()
    for name, params in specs:
        pb.add_smart_module(SmartModuleConfig(params=dict(params)), lookup(name))
    return pb.initialize().gpu_chain


def _linked(specs, link=LINK, stripes=None):
    """(JAX executor, port executor with ``link``) for the same chain of
    registry modules."""
    rb = RefEngine(backend="tpu").builder()
    for name, params in specs:
        rb.add_smart_module(RefConfig(params=dict(params)), ref_lookup(name))
    ref_chain = rb.initialize().tpu_chain
    assert ref_chain._link_compress and ref_chain._enc_variant == "pallas"
    return ref_chain, _port_chain(specs, link, stripes)


def _run_both(specs, ref_bufs, link=LINK, stripes=None):
    ref_chain, port_chain = _linked(specs, link, stripes)
    ref_outs = list(ref_chain.process_stream(ref_bufs))
    port_outs = list(port_chain.process_stream([_port_buffer(b) for b in ref_bufs]))
    assert len(port_outs) == len(ref_outs)
    for r, p in zip(ref_outs, port_outs):
        _assert_equal(r, p)
    return ref_chain, port_chain, port_outs


def test_headline_chain_with_the_link(ref_link):
    """Up link, down link and compress-ahead over a stream of batches:
    the tokens cross both ways and every batch equals the reference."""
    batches = [
        _ref_buffer(gen_json(1200, seed=s), ts=list(range(1200)), base_ts=3, base_offset=100 * s)
        for s in range(3)
    ]
    # constant descriptors (one name): the tokens beat the raw columns
    batches.append(_ref_buffer([b'{"name":"fluvio-1","n":1}'] * 2000))
    ref_chain, port_chain, outs = _run_both(HEADLINE, batches)
    counts = port_chain.link_counts
    assert counts["glz"] == 4 and counts["raw"] == 0
    assert counts["down-glz"] >= 1
    assert counts["down-glz"] + counts["down-packed"] == 4
    assert counts["h2d_bytes"] < sum(b.ragged_values()[0].nbytes for b in batches)
    assert outs[3].value_list() == [b"FLUVIO-1"] * 2000


def test_link_decline_reasons(ref_link):
    """Below-min and incompressible batches ship raw and count their
    reason; a small result declines the down link and ships raw columns."""
    rng = np.random.default_rng(5)
    noise = [b"fluvio" + rng.integers(0, 256, 60).astype(np.uint8).tobytes() for _ in range(300)]
    batches = [
        _ref_buffer([b'{"name":"fluvio-2"}', b"x", b'{"name":"kafka"}']),
        _ref_buffer(noise),
        _ref_buffer(gen_json(150, seed=8)),
    ]
    _, port_chain, _ = _run_both(HEADLINE, batches)
    counts = port_chain.link_counts
    assert counts[glz.DECLINE_BELOW_MIN] == 1 and counts[glz.DECLINE_RATIO] == 1
    assert counts["raw"] == 2 and counts["glz"] == 1
    assert counts[glz.DECLINE_ENC_RATIO] == 3 and counts["down-packed"] == 3


def test_only_one_half_on():
    """Either half alone gives the link-off output (which the tests above
    hold to the JAX package): the up link only, then the down link only."""
    buf = _port_buffer(_ref_buffer([b'{"name":"fluvio-1","n":1}'] * 2000 + gen_json(300, seed=2)))
    want = _port_chain(HEADLINE, LinkParams()).process_buffer(buf)
    for link, shipped in ((LinkParams(compress=True, chunk=CHUNK), ("glz", "down-packed")),
                          (LinkParams(result_compress=True, chunk=CHUNK), ("raw", "down-glz"))):
        chain = _port_chain(HEADLINE, link)
        got = chain.process_buffer(buf)
        assert got.count == want.count and got.value_list() == want.value_list()
        np.testing.assert_array_equal(got.offset_deltas[: got.count], want.offset_deltas[: want.count])
        assert [chain.link_counts[k] for k in shipped] == [1, 1], link


def test_striped_chain_with_the_link(ref_link, monkeypatch):
    """The striped path decodes the uploaded tokens before the stripe
    re-pad and encodes its int32 descriptors at the widest field tier."""
    monkeypatch.setenv("FLUVIO_STRIPE_THRESHOLD", str(PARAMS.threshold))
    monkeypatch.setenv("FLUVIO_STRIPE_WIDTH", str(PARAMS.width))
    monkeypatch.setenv("FLUVIO_STRIPE_OVERLAP", str(PARAMS.overlap))
    docs = _json_corpus(seed=14) * 6
    docs += [b'{"pad":"' + b"w" * 150 + b'","name":"fluvio-5"}'] * 600
    ref_buf = _ref_buffer(docs, base_offset=500)
    assert ref_buf.width > PARAMS.threshold
    specs = [("regex-filter", {"regex": "flu[vV]io"}), ("json-map", {"field": "name"})]
    ref_chain, port_chain, outs = _run_both(specs, [ref_buf], stripes=PARAMS)
    assert ref_chain._striped_chain() is not None
    counts = port_chain.link_counts
    assert counts["glz"] == 1 and counts["down-glz"] == 1
    assert b"FLUVIO-5" in outs[0].value_list()


def test_engine_refuses_the_link_without_its_compressor(monkeypatch, tmp_path):
    """A chain that asks for the link raises when the host library does
    not build; with the link off the same chain builds."""
    bad = tmp_path / "glz.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(glz, "_SOURCE", bad)
    monkeypatch.setattr(glz, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(glz, "_lib", None)

    def build(link):
        return (SmartEngine(device="cpu", link=link).builder()
                .add_smart_module(SmartModuleConfig(params={"regex": "fluvio"}), lookup("regex-filter"))
                .initialize())

    for link in (LinkParams(compress=True), LinkParams(result_compress=True)):
        with pytest.raises(EngineError, match="glz"):
            build(link)
    chain = build(LinkParams()).gpu_chain
    assert chain.process_buffer(RecordBuffer.from_values([b"fluvio"])).count == 1
