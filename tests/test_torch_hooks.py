"""User Python SmartModules in the port's chains against the JAX package's,
on the CPU: host hook segments beside the card's segments, exact
first-error on the card, look-back hooks and the topic's dedup chain.

The JAX chains are ``SmartEngine(backend="auto")``: a chain whose modules
all carry a DSL program runs fused (Pallas in interpret mode on the CPU)
and spills a transform error to its interpreter; any other chain runs in
its interpreter. The port's are ``SmartEngine(device="cpu")``: DSL runs on
the card's segments (their plain torch versions here), hooks on the host.
Tolerance 0: every output record (value, key, offset and timestamp
deltas), every error (hint, offset, kind, key, value) and the carries, as
the next batch's outputs show them, are equal.

Every test that starts a hook that spins waits for its thread to exit
before it returns: the test sets the hook's ``STOP`` (a list in the
source's namespace) and joins the metering's ``sm-meter-<name>`` threads.
"""

from __future__ import annotations

import asyncio
import shutil
import threading

import numpy as np
import pytest

from fluvio_tpu.models import lookup as ref_lookup
from fluvio_tpu.protocol import record as ref_record
from fluvio_tpu.smartengine import SmartEngine as RefEngine
from fluvio_tpu.smartengine import SmartModuleConfig as RefConfig
from fluvio_tpu.smartengine import metering as ref_metering
from fluvio_tpu.smartengine.config import Lookback as RefLookback
from fluvio_tpu.smartengine.engine import SmartModuleChainInitError as RefInitError
from fluvio_tpu.smartmodule import types as ref_types
from fluvio_tpu.smartmodule.sdk import load_source as ref_load_source
from fluvio_tpu_torch.models import lookup
from fluvio_tpu_torch.protocol import record
from fluvio_tpu_torch.smartengine import (
    SmartEngine,
    SmartModuleChainInitError,
    SmartModuleConfig,
)
from fluvio_tpu_torch.smartengine import metering
from fluvio_tpu_torch.smartengine.config import Lookback
from fluvio_tpu_torch.smartmodule import types
from fluvio_tpu_torch.smartmodule.sdk import load_source
from tests.test_torch_aggregate import _gauges_unchanged  # noqa: F401
from tests.test_torch_isolation import HOOK_TAG_SM, gen_arrays, gen_json
from tests.test_torch_redesign import _dfa_pallas_flags_restored  # noqa: F401
from tests.test_torch_server import _leaked_spin_threads_stopped  # noqa: F401

KIND_SOURCES = {
    "filter": b'''
@smartmodule.filter
def keep(record):
    if record.value.startswith(b"boom"):
        raise ValueError("filter boom at " + record.value.decode())
    return int(record.value.split(b":")[1]) % 3 != 0
''',
    "map": b'''
@smartmodule.map
def m(record):
    if record.value.startswith(b"boom"):
        raise ValueError("map boom")
    n = int(record.value.split(b":")[1])
    if n % 2:
        return (b"k%d" % (n % 5), record.value.upper())
    return record.value + b"!"
''',
    "filter_map": b'''
@smartmodule.filter_map
def fm(record):
    if record.value.startswith(b"boom"):
        raise KeyError("filter_map boom")
    n = int(record.value.split(b":")[1])
    if n % 3 == 0:
        return None
    if n % 3 == 1:
        return record.value[::-1]
    return (None, b"%d" % (2 * n))
''',
    "array_map": b'''
@smartmodule.array_map
def am(record):
    if record.value.startswith(b"boom"):
        raise ValueError("array_map boom")
    n = int(record.value.split(b":")[1])
    out = [b"%d" % i for i in range(n % 4)]
    if record.key is not None:
        out.append((record.key, b"tail"))
    return out
''',
    "aggregate": b'''
@smartmodule.aggregate
def agg(acc, record):
    if record.value.startswith(b"boom"):
        raise ValueError("aggregate boom")
    return b"%d" % (int(acc or b"0") + int(record.value.split(b":")[1]))
''',
}

INIT_SM = b'''
_cfg = {}


@smartmodule.init
def init(params):
    if params.get("mode") == "fail":
        raise ValueError("mode=fail refused")
    _cfg["min"] = int(params.get("min", "0"))


@smartmodule.filter
def above(record):
    return int(record.value.split(b":")[1]) >= _cfg["min"]
'''

# a hook that spins on the record ``spin`` until its ``STOP`` is set; the
# injected fuel error unwinds it
SPIN_SM = b'''
STOP = []


@smartmodule.%s
def spin(*args):
    record = args[-1]
    while record.value == b"spin" and not STOP:
        pass
    return %s
'''

# a hook that swallows the injected fuel error until its ``STOP`` is set:
# the metering abandons its thread
STUBBORN_SM = b'''
STOP = []


@smartmodule.filter
def stubborn(record):
    while not STOP:
        try:
            while not STOP:
                pass
        except BaseException:
            pass
    return True
'''

LOOK_BACK_SM = b'''
SEEN = []


@smartmodule.look_back
def look_back(record):
    if record.value == b"bad":
        raise ValueError("look-back refused " + record.value.decode())
    SEEN.append((record.offset, record.value))


@smartmodule.filter(dsl=dsl.FilterProgram(
    predicate=dsl.RegexMatch(arg=dsl.Value(), pattern="v:[0-9]*7")))
def f(record):
    import re
    return re.search(b"v:[0-9]*7", record.value) is not None
'''

BAD = b'{"no":17}'


def _values(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [b"v:%d" % x for x in rng.integers(0, 1000, size=n)]


def _keys(n: int):
    return [None if i % 3 == 0 else b"key%d" % (i % 7) for i in range(n)]


def _inputs(values, base_offset: int, keys=None):
    """The same input for both packages: offset deltas 0.., timestamp
    deltas ``3 * i`` from 1,000,000."""
    keys = keys if keys is not None else _keys(len(values))
    out = []
    for mod in (ref_record, record):
        recs = [mod.Record(value=v, key=keys[i], offset_delta=i, timestamp_delta=3 * i)
                for i, v in enumerate(values)]
        sm = ref_types if mod is ref_record else types
        out.append(sm.SmartModuleInput.from_records(recs, base_offset=base_offset,
                                                    base_timestamp=1_000_000))
    return out


def _view(out):
    err = out.error
    return ([(r.value, r.key, r.offset_delta, r.timestamp_delta) for r in out.successes],
            None if err is None else (err.hint, err.offset, err.kind.value, err.record_key,
                                      err.record_value))


def _module(spec, port: bool, name: str = "hook"):
    """A registry name, or a source (bytes) loaded under ``name``."""
    if isinstance(spec, str):
        return lookup(spec) if port else ref_lookup(spec)
    return (load_source if port else ref_load_source)(spec, name=name)


def _chains(specs, budget_ms: int = 0):
    """specs: [(registry name | source bytes, params, initial_data)] ->
    (JAX chain, port chain, [(JAX module, port module)])."""
    rb = RefEngine(backend="auto", hook_budget_ms=budget_ms).builder()
    pb = SmartEngine(device="cpu", hook_budget_ms=budget_ms).builder()
    modules = []
    for k, (spec, params, initial) in enumerate(specs):
        pair = (_module(spec, False, f"hook{k}"), _module(spec, True, f"hook{k}"))
        rb.add_smart_module(RefConfig(params=dict(params), initial_data=initial), pair[0])
        pb.add_smart_module(SmartModuleConfig(params=dict(params), initial_data=initial), pair[1])
        modules.append(pair)
    return rb.initialize(), pb.initialize(), modules


def _same_pass(ref_chain, port_chain, batches):
    """Each batch through both chains; returns the views."""
    views = []
    for values, base in batches:
        ref_in, port_in = _inputs(values, base)
        want, got = _view(ref_chain.process(ref_in)), _view(port_chain.process(port_in))
        assert got == want, (base, got[1], want[1])
        views.append(got)
    return views


def _stop_and_join(modules, name: str) -> None:
    """Set every module's ``STOP`` and wait for the metering threads of
    hooks named ``name`` to exit."""
    for m in modules:
        for hook in m.hooks.values():
            hook.__globals__["STOP"].append(True)
    for t in threading.enumerate():
        if t.name == f"sm-meter-{name}":
            t.join(10)
    assert not [t for t in threading.enumerate() if t.name == f"sm-meter-{name}"]


# ---------------------------------------------------------------------------
# hooks of each transform kind, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KIND_SOURCES))
def test_hook_kinds_equal_the_reference(kind):
    """Each kind's hook over three seeded batches on both packages (the
    aggregate seeded with ``initial_data``); the middle batch holds a record
    the hook raises on, so it ends with the output before it and the
    error, and the aggregate's accumulator runs on into the last batch."""
    ref_chain, port_chain, _ = _chains([(KIND_SOURCES[kind], {}, b"5")], budget_ms=5000)
    assert port_chain.backend_in_use == "host" and port_chain.gpu_chain is None
    mid = _values(40, seed=2)
    mid[23] = b"boom:1"
    views = _same_pass(ref_chain, port_chain,
                       [(_values(40, seed=1), 0), (mid, 100), (_values(40, seed=3), 200)])
    assert views[1][1] is not None and views[1][1][1] == 123
    assert views[0][1] is None and views[2][1] is None and views[2][0]


@pytest.mark.parametrize("mode", ["ok", "fail"])
def test_init_hook_and_its_failure(mode):
    """``init`` runs at build with the invocation's params on both
    packages; one that raises fails the build with the same
    `SmartModuleChainInitError` message."""
    spec = [(INIT_SM, {"mode": mode, "min": "500"}, b"")]
    if mode == "fail":
        with pytest.raises(RefInitError) as want:
            _chains(spec)
        with pytest.raises(SmartModuleChainInitError) as got:
            SmartEngine(device="cpu").builder().add_smart_module(
                SmartModuleConfig(params={"mode": "fail"}), INIT_SM, name="hook0").initialize()
        assert str(got.value) == str(want.value) and "mode=fail refused" in str(got.value)
        return
    ref_chain, port_chain, _ = _chains(spec)
    views = _same_pass(ref_chain, port_chain, [(_values(50, seed=4), 0)])
    assert 0 < len(views[0][0]) < 50


# ---------------------------------------------------------------------------
# fuel: a trap, abandonment and poisoning, the per-module quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind, result", [("filter", b"True"), ("aggregate", b"b'1'")])
def test_fuel_trap_and_poisoning(kind, result):
    """A hook that spins on one record, under a 50 ms budget: the fuel
    trap is the batch's error at its base offset on both packages. A
    filter's thread unwinds, so the next batch runs; an aggregate's
    accumulator may be half-written, so its chain is poisoned and the next
    batch gets the same error without a hook call."""
    src = SPIN_SM % (kind.encode(), result)
    ref_chain, port_chain, mods = _chains([(src, {}, b"")], budget_ms=50)
    try:
        spin = _values(20, seed=5)
        spin[7] = b"spin"
        views = _same_pass(ref_chain, port_chain, [(_values(20, seed=6), 0), (spin, 40),
                                                   (_values(20, seed=7), 80)])
        hint, offset = views[1][1][:2]
        assert "exceeded its execution budget (50 ms)" in hint and offset == 40
        assert (views[2][1] is not None) == (kind == "aggregate")
        assert (port_chain._poisoned is not None) == (kind == "aggregate")
    finally:
        _stop_and_join([m for pair in mods for m in pair], "hook0")


def test_abandoned_hook_poisons_and_quarantines_its_module(monkeypatch):
    """A hook that swallows the injected fuel error: the metering abandons
    its thread, the batch gets the trap's error and the chain is poisoned
    on both packages. Four abandoned threads of one module (four chains of
    the same source) quarantine it: a fifth chain's build is refused at
    once (its metered ``init`` call), with the same message, and both
    `quarantine_state` documents agree. Once the threads exit, the
    quarantine lifts."""
    for mod in (metering, ref_metering):
        monkeypatch.setattr(mod, "_KILL_GRACE_SECONDS", 0.3)
    loaded = []
    try:
        for _ in range(4):
            ref_chain, port_chain, mods = _chains([(STUBBORN_SM, {}, b"")], budget_ms=50)
            loaded += [m for pair in mods for m in pair]
            first = _same_pass(ref_chain, port_chain, [(_values(5, seed=8), 0)])[0][1]
            assert "exceeded its execution budget (50 ms)" in first[0]
            again = _same_pass(ref_chain, port_chain, [(_values(5, seed=9), 10)])[0][1]
            assert again == first  # poisoned: the same error, no hook call
            assert port_chain._poisoned is not None
        with pytest.raises(RefInitError) as want:
            _chains([(STUBBORN_SM, {}, b"")], budget_ms=50)
        with pytest.raises(SmartModuleChainInitError) as got:
            SmartEngine(device="cpu", hook_budget_ms=50).builder().add_smart_module(
                SmartModuleConfig(), STUBBORN_SM, name="hook0").initialize()
        assert str(got.value) == str(want.value) and "quarantined" in str(got.value)
        state = metering.quarantine_state()
        assert state == ref_metering.quarantine_state()
        assert state["abandoned_hook_threads"] == 4 and len(state["quarantined_modules"]) == 1
    finally:
        _stop_and_join(loaded, "hook0")
    assert metering.quarantine_state() == ref_metering.quarantine_state() == {
        "abandoned_hook_threads": 0, "by_module": {}, "quarantined_modules": [],
        "process_circuit_broken": False}


# ---------------------------------------------------------------------------
# exact first error on the card
# ---------------------------------------------------------------------------

FIRST_ERROR_CHAINS = {
    "explode": [("array-map-json", {}, b"")],
    "filter_explode": [("regex-filter", {"regex": "7"}, b""), ("array-map-json", {}, b"")],
    "explode_aggregate": [("array-map-json", {}, b""), ("aggregate-count", {}, b"")],
    "aggregate_explode_map": [("aggregate-count", {}, b"3"), ("array-map-json", {}, b""),
                              ("json-map", {"field": "name"}, b"")],
}


@pytest.mark.parametrize("position", ["first", "middle", "last", "none"])
@pytest.mark.parametrize("chain", sorted(FIRST_ERROR_CHAINS))
def test_first_error_on_the_card_equals_the_reference(chain, position):
    """A record that is no JSON array at the first, a middle or the last
    row of the middle of three batches (or none): the JAX chain spills and
    its interpreter returns the explode's output before the record with
    the error; the port re-dispatches the stages up to the explode on the
    card (no host interpreter). Outputs, errors and the next batch (the
    aggregates' carries) are equal. ``aggregate_explode_map`` fails at
    every batch's first row: the explode sees the count's decimals, which
    the error's value carries (copied from the card)."""
    ref_chain, port_chain, _ = _chains(FIRST_ERROR_CHAINS[chain])
    assert ref_chain.backend_in_use == "tpu" and port_chain.backend_in_use == "gpu"
    mid = gen_arrays(30, seed=11)
    at = {"first": 0, "middle": 13, "last": 29, "none": None}[position]
    if at is not None:
        mid[at] = BAD
    views = _same_pass(ref_chain, port_chain,
                       [(gen_arrays(30, seed=10), 0), (mid, 50), (gen_arrays(30, seed=12), 90)])
    err = views[1][1]
    if chain == "aggregate_explode_map":
        assert err is not None and err[1] == 50 and err[4] == b"%d" % (3 + 30 + 1)
        assert port_chain.gpu_chain.error_redispatches == 3
    elif at is None:
        assert err is None and port_chain.gpu_chain.error_redispatches == 0
    else:
        assert err == ("input record is not a JSON array", 50 + at, "array_map",
                       _keys(30)[at], BAD)
        assert port_chain.gpu_chain.error_redispatches == 1


# ---------------------------------------------------------------------------
# mixed chains
# ---------------------------------------------------------------------------


def test_mixed_chain_equals_the_reference():
    """``regex-filter("fluvio")`` on the card, a Python map hook on the
    host, ``json-map("name")`` on the card: three segments, the JAX chain
    all in its interpreter. Then a card explode after a host aggregate
    hook, whose error the card resolves inside the segment pass."""
    ref_chain, port_chain, _ = _chains([("regex-filter", {"regex": "fluvio"}, b""),
                                        (HOOK_TAG_SM, {}, b""),
                                        ("json-map", {"field": "name"}, b"")], budget_ms=5000)
    assert port_chain.backend_in_use == "mixed" and len(port_chain.segments) == 3
    views = _same_pass(ref_chain, port_chain, [(gen_json(60, seed=k), 100 * k) for k in range(3)])
    assert all(v[0] and v[1] is None for v in views)
    assert all(value.startswith(b"HOOK/FLUVIO") for value, *_ in views[0][0])  # json-map uppers

    wrap = b'''
@smartmodule.aggregate
def wrap(acc, record):
    return record.value if record.value != b"bad" else b"not an array"
'''
    ref_chain, port_chain, _ = _chains([(wrap, {}, b""), ("array-map-json", {}, b""),
                                        ("aggregate-count", {}, b"")], budget_ms=5000)
    assert [type(s).__name__ for s in port_chain.segments] == ["HookInstance",
                                                               "GpuChainExecutor"]
    mid = gen_arrays(20, seed=21)
    mid[9] = b"bad"
    views = _same_pass(ref_chain, port_chain, [(gen_arrays(20, seed=20), 0), (mid, 30),
                                               (gen_arrays(20, seed=22), 60)])
    assert views[1][1][1:] == (39, "array_map", _keys(20)[9], b"not an array")


def test_empty_output_of_a_host_segment_reaches_the_card():
    """A host filter that drops every record hands the card segment an
    empty input, on both packages alike."""
    drop = b'''
@smartmodule.filter
def none(record):
    return False
'''
    ref_chain, port_chain, _ = _chains([(drop, {}, b""), ("json-map", {"field": "name"}, b"")])
    views = _same_pass(ref_chain, port_chain, [(gen_json(10, seed=30), 0)])
    assert views == [([], None)]


# ---------------------------------------------------------------------------
# look_back
# ---------------------------------------------------------------------------


def _stored_records(values):
    return ([ref_types.SmartModuleRecord(ref_record.Record(value=v, offset_delta=i))
             for i, v in enumerate(values)],
            [types.SmartModuleRecord(record.Record(value=v, offset_delta=i))
             for i, v in enumerate(values)])


def test_look_back_hook_seeds_and_its_error():
    """A DSL filter that exports a ``look_back`` hook (its filter on the
    card, the hook on the host): the hook is asked for what the module's
    `Lookback` says and sees the records it is given, and the filter
    passes alike on both packages (the dedup test below reads state a
    look-back seeded); a record the hook raises on raises
    `SmartModuleLookbackError` with its offset."""
    ref_chain, port_chain, mods = _chains([(LOOK_BACK_SM, {}, b"")], budget_ms=5000)
    ref_chain.instances[0].config.lookback = RefLookback.last_n(3)
    port_chain.instances[0].config.lookback = Lookback.last_n(3)
    assert port_chain.backend_in_use == "gpu"
    values = _values(40, seed=40)
    seen_asks = []

    def read_fn(records):
        async def read(lookback):
            seen_asks.append((lookback.last, lookback.age_ms))
            return records
        return read

    ref_recs, port_recs = _stored_records([v for v in values if v.endswith(b"7")][:3])
    asyncio.run(ref_chain.look_back(read_fn(ref_recs)))
    asyncio.run(port_chain.look_back(read_fn(port_recs)))
    assert seen_asks == [(3, None), (3, None)]
    ref_m, port_m = mods[0]
    seen = [m.hook(k.LOOK_BACK).__globals__["SEEN"] for m, k in (
        (ref_m, ref_types.SmartModuleKind), (port_m, types.SmartModuleKind))]
    assert seen[0] == seen[1] and len(seen[1]) == 3
    views = _same_pass(ref_chain, port_chain, [(values, 0)])
    assert views[0][0]

    ref_chain, port_chain, _ = _chains([(LOOK_BACK_SM, {}, b"")], budget_ms=5000)
    ref_recs, port_recs = _stored_records([b"v:7", b"v:17", b"bad", b"v:27"])
    with pytest.raises(ref_types.SmartModuleLookbackError) as want:
        asyncio.run(ref_chain.look_back(read_fn(ref_recs)))
    with pytest.raises(types.SmartModuleLookbackError) as got:
        asyncio.run(port_chain.look_back(read_fn(port_recs)))
    assert (got.value.hint, got.value.offset) == (want.value.hint, want.value.offset) == (
        "look-back refused bad", 2)


# ---------------------------------------------------------------------------
# the topic's dedup chain
# ---------------------------------------------------------------------------

DEDUP_CONFIG = {"deduplication": {"bounds": {"count": 16},
                                  "filter": {"transform": {"uses": "dedup-filter"}}}}


def _record_sets(mod, start: int, n_batches: int, seed: int):
    """Record sets of 25 keyed records each, keys from 40 ids."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        recs = [mod.Record(value=b"payload-%d" % (start + 25 * b + i),
                           key=b"id%d" % rng.integers(0, 40), offset_delta=i,
                           timestamp_delta=i) for i in range(25)]
        rs = mod.RecordSet()
        rs.add(mod.Batch.from_records(recs, first_timestamp=1_700_000_000_000 + 1000 * b))
        out.append(rs)
    return out


def _stored(leader):
    """(offset, key, value) of every stored record."""
    out = []
    for batch in leader.storage.read_records(0, 1 << 30, "read_committed"):
        for r in batch.memory_records():
            out.append((batch.base_offset + r.offset_delta, r.key, r.value))
    return out


def test_dedup_leader_seeded_from_a_log_the_jax_spu_wrote(tmp_path):
    """A topic deduplicating through ``dedup-filter`` (count 16): the JAX
    SPU's leader stores four deduplicated produces. Both SPUs then open
    that log (the JAX one its own directory, the port a copy), attach the
    dedup chain seeded by a look-back of the last 16 records, and take two
    more produces: the stored logs are equal, record for record."""
    from fluvio_tpu.spu.config import SpuConfig as RefSpuConfig
    from fluvio_tpu.spu.context import GlobalContext as RefContext
    from fluvio_tpu.spu.smart_chain import ensure_dedup_chain as ref_ensure
    from fluvio_tpu.storage.config import ReplicaConfig as RefReplicaConfig
    from fluvio_tpu_torch.spu.config import SpuConfig
    from fluvio_tpu_torch.spu.context import GlobalContext
    from fluvio_tpu_torch.spu.smart_chain import ensure_dedup_chain
    from fluvio_tpu_torch.storage.config import ReplicaConfig

    def ref_context(path):
        cfg = RefSpuConfig(log_base_dir=str(path), replication=RefReplicaConfig(base_dir=str(path)))
        return RefContext(cfg)

    def port_context(path):
        cfg = SpuConfig(log_base_dir=str(path), replication=ReplicaConfig(base_dir=str(path)))
        cfg.smart_engine.device = "cpu"
        return GlobalContext(cfg)

    async def produce(ctx, ensure, record_sets):
        leader = ctx.create_replica("dedup", 0, topic_config=DEDUP_CONFIG)
        for rs in record_sets:
            await ensure(ctx, leader)
            await leader.write_record_set(rs)
        return leader

    async def main():
        ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
        ctx = ref_context(ref_dir)
        first = _stored(await produce(ctx, ref_ensure, _record_sets(ref_record, 0, 4, seed=1)))
        ctx.close()
        shutil.copytree(ref_dir, port_dir)
        ref_ctx, port_ctx = ref_context(ref_dir), port_context(port_dir)
        try:
            ref_leader = await produce(ref_ctx, ref_ensure, _record_sets(ref_record, 100, 2, 2))
            port_leader = await produce(port_ctx, ensure_dedup_chain,
                                        _record_sets(record, 100, 2, 2))
            assert port_leader.sm_chain.backend_in_use == "host"
            return first, _stored(ref_leader), _stored(port_leader)
        finally:
            ref_ctx.close()
            port_ctx.close()

    first, want, got = asyncio.run(main())
    assert got == want
    assert 0 < len(first) < 100 and len(first) < len(got) < len(first) + 50
    assert got[:len(first)] == first
