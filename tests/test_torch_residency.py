"""spark_rapids_tpu_torch's residency ledger (utils/residency.py) against
spark_rapids_tpu's: twins of the 15 tests of tests/test_residency.py, at
its scale.

The acceptance run is the reference's: Q5 on the shuffle manager lane
of two in-process executors under seeded OOM injection, profiled, once
per module in each package; the query result, the provenance sites the
residency timeline names and the clean leak verdict are held equal.
The storm runs the reference's mix of TPC-H and TPC-DS queries on eight
threads, each result against the same query run alone.
"""
import threading

import numpy as np
import pytest
from pandas.testing import assert_frame_equal

from parity import compare_frames
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory import BufferId
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.memory.env import ResourceEnv
from spark_rapids_tpu_torch.models import tpcds_data, tpcds_queries
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.utils import residency as RS
from spark_rapids_tpu_torch.utils import telemetry as T
from test_torch_movement import LANE, _shuffle_reset
from test_torch_profile import (port_conf, port_query, port_tables,
                                ref_profile, reset_observability)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _clean(one_torch_thread):  # noqa: F811
    reset_observability()
    yield
    reset_observability()


@pytest.fixture(scope="module")
def ds_tables():
    return tpcds_data.gen_tables(np.random.default_rng(3), 2000)


def _run_tpcds(name, ds_tables, conf):
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

    def run(plan):
        return collect(accelerate(plan, conf, device="cpu"), conf)
    return run(tpcds_queries.QUERIES[name](
        tpcds_data.sources(ds_tables, 2), run))


def _batch(rows=1000, seed=0):
    rng = np.random.default_rng(seed)
    return ColumnarBatch.from_numpy({
        "a": rng.integers(0, 100, rows).astype(np.int64),
        "b": rng.random(rows)}, device="cpu")


def _env(conf, tmp_path):
    C.set_active_conf(conf)
    return ResourceEnv.init(conf, spill_dir=str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# process registry units
def test_track_retire_registry_unit():
    RS.enable()
    token = RS.track(1000, site="unit-site")
    assert token is not None
    assert RS.resident_bytes() == 1000
    assert RS.by_tier() == {"device": 1000}
    assert RS.by_site() == {"unit-site": 1000}
    snap = RS.lookup(token)
    assert (snap["site"], snap["tier"], snap["kind"], snap["bytes"]) == \
        ("unit-site", RS.TIER_DEVICE, RS.KIND_STORE, 1000)
    t2 = RS.track(500, site="unit-site", tier=RS.TIER_HOST)
    assert RS.resident_bytes(RS.TIER_DEVICE) == 1000
    assert RS.by_tier() == {"device": 1000, "host": 500}
    assert RS.holders()[0]["bytes"] == 1000
    RS.retire(token)
    RS.retire(token)
    RS.retire(t2)
    assert RS.resident_bytes() == 0
    assert RS.track(0, site="x") is None


def test_disabled_path_allocation_free():
    assert not RS.enabled()
    assert RS.track(1 << 20, site="x") is None
    RS.retire(None)
    assert RS.resident_bytes() == 0
    assert RS.by_tier() == {}
    assert RS.describe_for_dump() == "  <residency tracking off>"
    with RS.tracked(1 << 20, site="x") as token:
        assert token is None


def test_site_scope_and_buffer_site():
    assert RS.buffer_site(BufferId(1)) == "store"
    assert RS.buffer_site(BufferId(1, shuffle_id=3, map_id=0,
                                   partition=1)) == "shuffle-map"
    with RS.site_scope("shuffle-recv"):
        assert RS.buffer_site(BufferId(1, shuffle_id=3)) == "shuffle-recv"
    assert RS.buffer_site(BufferId(1)) == "store"


def test_ledger_highwater_peak_and_report_unit():
    led = RS.QueryResidencyLedger("qunit", 0, timeline=64)

    def rec(size, site, tier=RS.TIER_DEVICE):
        return RS.ProvenanceRecord(0, "qunit", site, size, tier,
                                   RS.KIND_STORE, None)

    a, b = rec(100, "a"), rec(300, "b")
    led.on_alloc(a)
    led.on_alloc(b)
    assert led.live_bytes == 400 and led.hbm_high_water == 400
    led.on_alloc(rec(10_000, "spilled", tier=RS.TIER_HOST))
    assert led.hbm_high_water == 400
    led.on_free(a)
    assert led.live_bytes == 300
    c = rec(500, "c")
    led.on_alloc(c)
    assert led.hbm_high_water == 800
    rep = led.report()
    assert rep["peak_composition"] == {"b|device": 300, "c|device": 500}
    assert sum(rep["peak_composition"].values()) == rep["hbm_high_water"]
    led.on_free(b)
    led.on_free(b)
    led.on_free(c)
    assert led.live_bytes == 0
    assert led.samples()
    text = RS.format_report(rep)
    assert "hbm high water" in text and "at peak" in text
    assert RS.format_report(None) == "<no residency tracked>"


# ---------------------------------------------------------------------------
# DeviceManager: underflow guard + headroom gauges
def test_store_bytes_underflow_guard():
    dm = DeviceManager.get("cpu")
    before = dm.store_bytes
    uf0 = dm.store_bytes_underflows()
    dm.track_store_bytes(-(before + 12345), site="test-underflow")
    assert dm.store_bytes == 0
    assert dm.store_bytes_underflows() == uf0 + 1
    dm.track_store_bytes(-1, site="test-underflow")
    assert dm.store_bytes_underflows() == uf0 + 2
    assert dm.telemetry_gauges()["store_bytes_underflow"] == uf0 + 2
    dm.track_store_bytes(before, site="test-underflow-restore")
    assert dm.store_bytes == before


def test_headroom_and_split_gauges():
    dm = DeviceManager.get("cpu")
    g = dm.telemetry_gauges()
    assert g["in_use_bytes"] == g["store_bytes"] + g["reserved_bytes"]
    assert g["admission_headroom_bytes"] == (
        g["budget"] - g["store_bytes"] - g["reserved_bytes"]
        - g["admitted_bytes"])
    snap = dm.snapshot()
    assert isinstance(snap["admissions"], dict)
    assert snap["admission_headroom_bytes"] == g["admission_headroom_bytes"]
    assert dm.try_admit("residency-test-q", 1 << 20)
    try:
        assert dm.telemetry_gauges()["admission_headroom_bytes"] == \
            g["admission_headroom_bytes"] - (1 << 20)
    finally:
        dm.release_admission("residency-test-q")


# ---------------------------------------------------------------------------
# the store chain's registration reconciles with the accounting
def test_store_registration_reconciles(tmp_path):
    prev = C.get_active_conf()
    env = ResourceEnv.init(spill_dir=str(tmp_path), device="cpu")
    RS.enable()
    try:
        dm = env.device_manager
        bufs = []
        for i in range(3):
            bid = BufferId(env.catalog.next_table_id())
            bufs.append(env.device_store.add_batch(bid, _batch(seed=i)))
        assert RS.resident_bytes(RS.TIER_DEVICE) == dm.store_bytes > 0
        assert RS.by_site(RS.TIER_DEVICE) == {"store": dm.store_bytes}
        assert env.device_store.synchronous_spill(0) > 0
        assert RS.resident_bytes(RS.TIER_DEVICE) == dm.store_bytes == 0
        assert RS.resident_bytes(RS.TIER_HOST) > 0
        assert set(RS.by_site(RS.TIER_HOST)) == {"store"}
        for b in bufs:
            env.catalog.remove(b.id)
        assert RS.resident_bytes() == 0
    finally:
        ResourceEnv.shutdown()
        C.set_active_conf(prev)


def test_spill_inherits_original_owner(tmp_path):
    prev = C.get_active_conf()
    conf = port_conf()
    env = _env(conf, tmp_path)
    owner = P.begin_query(conf)
    assert owner is not None and owner.residency is not None
    bid = BufferId(env.catalog.next_table_id())
    try:
        env.device_store.add_batch(bid, _batch())
        recs = RS.live_records_for_query(owner.query_id)
        assert len(recs) == 1 and recs[0]["tier"] == "device"
        t = threading.Thread(
            target=lambda: env.device_store.synchronous_spill(0))
        t.start()
        t.join(60)
        recs = RS.live_records_for_query(owner.query_id)
        assert len(recs) == 1, recs
        assert (recs[0]["tier"], recs[0]["site"]) == ("host", "store")
    finally:
        env.catalog.remove(bid)
        P.end_query(owner, None)
        ResourceEnv.shutdown()
        C.set_active_conf(prev)


# ---------------------------------------------------------------------------
# leak detection
def test_deliberate_leak_flagged_with_provenance(tmp_path):
    prev = C.get_active_conf()
    conf = port_conf()
    env = _env(conf, tmp_path)
    leaks0 = RS.leaks_total()
    owner = P.begin_query(conf)
    assert owner is not None and owner.residency is not None
    bid = BufferId(env.catalog.next_table_id())
    buf = env.device_store.add_batch(bid, _batch())
    try:
        prof = P.end_query(owner, None)
        res = prof.residency
        assert res is not None and res["leaks"] == 1
        leak = res["leaked"][0]
        assert (leak["site"], leak["tier"], leak["kind"]) == \
            ("store", "device", RS.KIND_STORE)
        assert leak["bytes"] == buf.size_bytes
        assert leak["query_id"] == prof.query_id
        assert RS.leaks_total() == leaks0 + 1
        evs = [e for e in prof.events if e["kind"] == P.EV_RESIDENCY_LEAK]
        assert len(evs) == 1 and evs[0]["site"] == "store"
        assert "LEAKED" in RS.format_report(res)
        assert any(h["query_id"] == prof.query_id for h in RS.holders())
    finally:
        env.catalog.remove(bid)
        ResourceEnv.shutdown()
        C.set_active_conf(prev)


def test_watchdog_dump_has_residency_holder_table():
    from spark_rapids_tpu_torch.utils.watchdog import build_dump
    RS.enable()
    token = RS.track(1 << 20, site="dump-site")
    try:
        dump = build_dump()
        assert "-- residency --" in dump and "dump-site" in dump
        text = RS.describe_for_dump()
        assert "tracked resident" in text and "dump-site" in text
    finally:
        RS.retire(token)


# ---------------------------------------------------------------------------
# the profiled Q5 acceptance run
@pytest.fixture(scope="module")
def q5_residency():
    from spark_rapids_tpu_torch.memory import retry as R
    reset_observability()
    _shuffle_reset()
    R.reset_oom_injection()
    try:
        out = port_query(5, **LANE)
        prof = P.last_profile()
    finally:
        R.reset_oom_injection()
        _shuffle_reset()
        RS.reset()
    assert prof is not None
    return out, prof, ref_profile(5, **LANE)


def test_q5_high_water_nonzero_and_reconciles(q5_residency):
    out, prof, (ref_out, ref) = q5_residency
    compare_frames(ref_out, out, "q5")
    res = prof.residency
    assert res is not None
    assert res["hbm_high_water"] > 0
    comp = res["peak_composition"]
    assert comp and all(k.endswith("|device") for k in comp)
    assert sum(comp.values()) == res["hbm_high_water"]
    assert res["leaks"] == 0 == ref.residency["leaks"]
    assert res["live_end_bytes"] == 0
    assert res["allocs"] == res["frees"] > 0
    sites = {e[1] for e in prof.residency_samples}
    assert "shuffle-map" in sites
    assert any(s.startswith("reserve:") for s in sites)
    # the same kinds of provenance site as the reference's
    kind = {s.split(":")[0] for s in sites}
    assert kind == {s.split(":")[0] for _, s, _, _ in ref.residency_samples}


def test_q5_report_renders_everywhere(q5_residency):
    _, prof, _ = q5_residency
    text = prof.explain()
    assert "-- residency --" in text
    assert "leak verdict: clean" in text
    names = {e["name"] for e in prof.chrome_trace()["traceEvents"]
             if e["ph"] == "C" and e["name"].startswith("residency:")}
    assert "residency:total" in names
    assert len(names) > 2
    assert RS.live_records_for_query(prof.query_id) == []


def test_q5_bit_exact_with_residency_off(q5_residency):
    on, _, _ = q5_residency
    _shuffle_reset()
    try:
        off = port_query(5, **{
            "spark.rapids.shuffle.enabled": True,
            "spark.rapids.shuffle.localExecutors": 2,
            "spark.rapids.sql.profile.residency.enabled": False})
    finally:
        _shuffle_reset()
    prof = P.last_profile()
    assert prof.residency is None
    assert prof.residency_samples == []
    assert_frame_equal(off.reset_index(drop=True),
                       on.reset_index(drop=True))


# ---------------------------------------------------------------------------
# slow-query log: per-fingerprint observed high-water aggregation
def test_slow_query_log_hbm_high_water():
    t = T.start(C.RapidsConf({
        "spark.rapids.sql.telemetry.enabled": True,
        "spark.rapids.sql.telemetry.samplePeriodMs": 50.0}))
    for _ in range(2):
        port_query(1)
    entries = [e for e in t.slow_query_log() if "hbm_high_water" in e]
    assert entries, t.slow_query_log()
    hw = entries[0]["hbm_high_water"]
    assert hw["max_bytes"] >= hw["p95_bytes"] >= hw["p50_bytes"] > 0
    assert entries[0]["count"] >= 2
    snap = t.snapshot()
    assert snap["residency"]["enabled"] is True
    assert "tiers" in snap["residency"]


# ---------------------------------------------------------------------------
# the 8-thread mixed TPC-H/TPC-DS storm
def test_storm_residency_isolated_zero_leaks(ds_tables):
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.models.tpch_bench import run_query
    conf = port_conf()
    plain = C.RapidsConf({
        "spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.sql.incompatibleOps.enabled": True})
    mix = [("tpch", 1), ("tpch", 5), ("tpch", 6), ("tpcds", "q3"),
           ("tpcds", "q42"), ("tpch", 1), ("tpch", 6), ("tpcds", "q3")]

    def run_one(kind, q, cf):
        if kind == "tpch":
            return run_query(q, port_tables(), device="cpu", conf=cf)
        return _run_tpcds(q, ds_tables, cf)

    serial = {key: run_one(*key, plain) for key in set(mix)}
    P.clear_history()
    results, errors = {}, []

    def worker(i, kind, q):
        try:
            results[i] = ((kind, q), run_one(kind, q, conf))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append((i, kind, q, repr(e)))

    threads = [threading.Thread(target=worker, args=(i, kind, q),
                                name=f"res-storm-{i}")
               for i, (kind, q) in enumerate(mix)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    assert len(results) == len(mix)
    for i, (key, got) in results.items():
        assert_frame_equal(got.reset_index(drop=True),
                           serial[key].reset_index(drop=True))
    profs = P.profile_history()
    assert len(profs) == len(mix)
    assert len({p.query_id for p in profs}) == len(mix)
    for p in profs:
        res = p.residency
        assert res is not None, p.query_id
        assert res["hbm_high_water"] > 0, p.query_id
        assert sum(res["peak_composition"].values()) == \
            res["hbm_high_water"], p.query_id
        assert res["leaks"] == 0, (p.query_id, res["leaked"])
        assert res["live_end_bytes"] == 0, p.query_id
        assert RS.live_records_for_query(p.query_id) == []
    assert TpuSemaphore.get().snapshot()["refs"] == {}
    dm = DeviceManager.get("cpu")
    assert dm.admissions() == {}
    assert dm.reserved_bytes == 0
