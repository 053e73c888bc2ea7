"""spark_rapids_tpu_torch's data-movement ledger (utils/movement.py)
against spark_rapids_tpu's: twins of 13 of the 14 tests of
tests/test_movement.py, of tests/test_out_of_core.py's
test_three_way_spill_reconciliation and of tests/test_speculation.py's
test_losing_hedge_charged_to_wasted_site, at the reference's scale.

The acceptance run is the reference's: Q5 on the shuffle manager lane
of two in-process executors under seeded OOM injection, profiled, once
per module in each package; the edges that carried bytes, the receive
and send sites and the query result are held equal.

Left out: test_collective_edge_recorded_on_mesh_exchange.  Nothing
records to the collective edge until the port has a multi-device
exchange (ROADMAP item 8); the edge and its roofline entry are checked
to exist.

The roofline ceilings differ on purpose: the port's defaults are H100
SXM5 datasheet figures (utils/roofline.py), so a report's utilization is
checked against the port's own registry defaults.
"""
import json
import threading

import numpy as np
import pandas as pd
import pytest

from parity import compare_frames
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.utils import checks as CK
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import movement as MV
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.utils import roofline as RL
from test_torch_profile import (moved_edges, port_query, ref_profile,
                                reset_observability)
from test_torch_shuffle_manager import PORT, reset_world
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

LANE = {
    "spark.rapids.shuffle.enabled": True,
    "spark.rapids.shuffle.localExecutors": 2,
    "spark.rapids.memory.faultInjection.oomRate": 0.5,
    "spark.rapids.memory.faultInjection.seed": 7,
    "spark.rapids.memory.faultInjection.maxInjections": 16,
}


@pytest.fixture(autouse=True)
def _clean(one_torch_thread):  # noqa: F811
    reset_observability()
    yield
    reset_observability()


def _shuffle_reset():
    from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager
    TpuShuffleManager.close_all()
    reset_world(PORT)


def _lane_q5(**extra):
    from spark_rapids_tpu_torch.memory import retry as R
    _shuffle_reset()
    R.reset_oom_injection()
    try:
        out = port_query(5, **LANE, **extra)
        return out, P.last_profile()
    finally:
        R.reset_oom_injection()
        _shuffle_reset()


@pytest.fixture(scope="module")
def q5_movement():
    """The profiled manager-lane Q5 of both packages."""
    out, prof = _lane_q5()
    assert prof is not None
    return out, prof, ref_profile(5, **LANE)


# ---------------------------------------------------------------------------
# edge coverage + report shape
def test_q5_movement_report_covers_exercised_edges(q5_movement):
    out, prof, (ref_out, ref) = q5_movement
    compare_frames(ref_out, out, "q5")
    mv = prof.movement
    assert mv is not None and mv["total_bytes"] > 0
    assert set(mv["edges"]) == set(MV.EDGES)
    # the same edges carried bytes in both packages
    assert moved_edges(prof) == moved_edges(ref)
    for edge in ("upload", "readback", "wire"):
        e = mv["edges"][edge]
        assert e["bytes"] > 0, (edge, e)
        assert e["roofline_gbps"] > 0
        assert e["gbps_avg"] >= 0
        assert 0 <= e["roofline_utilization"] <= 1e6
    assert "serde.deserialize" in mv["edges"]["upload"]["sites"]
    assert any(s.startswith("send") for s in mv["edges"]["wire"]["sites"])
    assert {s.split(":")[0] for s in mv["edges"]["wire"]["sites"]} == \
        {s.split(":")[0] for s in ref.movement["edges"]["wire"]["sites"]}


def test_q5_wire_conservation_sent_equals_received(q5_movement):
    _, prof, _ = q5_movement
    sites = prof.movement["edges"]["wire"]["sites"]
    sent = sum(v["bytes"] for s, v in sites.items() if s.startswith("send"))
    recv = sum(v["bytes"] for s, v in sites.items() if s.startswith("recv"))
    sent_raw = sum(v["raw_bytes"] for s, v in sites.items()
                   if s.startswith("send"))
    recv_raw = sum(v["raw_bytes"] for s, v in sites.items()
                   if s.startswith("recv"))
    assert sent == recv > 0
    assert sent_raw == recv_raw >= sent
    assert prof.movement["edges"]["wire"]["bytes"] == sent


def test_q5_report_renders_everywhere(q5_movement):
    _, prof, _ = q5_movement
    text = prof.explain()
    assert "-- data movement --" in text
    assert "roofline" in text
    trace = json.loads(json.dumps(prof.chrome_trace()))
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert "movement:readback" in {e["name"] for e in counters}
    last = {}
    for e in counters:
        if not e["name"].startswith("movement:"):
            continue
        assert e["args"]["bytes"] >= last.get(e["name"], 0)
        last[e["name"]] = e["args"]["bytes"]
    for r in (e for e in prof.events if e["kind"] == "data_movement"):
        assert r["query_id"] == prof.query_id
        assert r["edge"] in MV.EDGES


def test_q5_per_node_byte_attribution(q5_movement):
    _, prof, (_, ref) = q5_movement
    for name in ("dataSize=", "shuffleCompressedBytes=",
                 "shuffleUncompressedBytes="):
        assert name in prof.plan_report
        assert name in ref.plan_report


def test_q5_bit_exact_with_movement_off(q5_movement):
    on, _, _ = q5_movement
    off, prof = _lane_q5(**{
        "spark.rapids.sql.profile.movement.enabled": False})
    assert prof.movement is None
    pd.testing.assert_frame_equal(off.reset_index(drop=True),
                                  on.reset_index(drop=True))


# ---------------------------------------------------------------------------
# spill conservation (seeded pressure against a tiny accounted budget)
def test_spill_hops_reconcile_with_spill_bytes(tmp_path):
    from spark_rapids_tpu_torch.memory import BufferId
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    C.set_active_conf(C.RapidsConf({
        C.HBM_ALLOC_FRACTION.key: 1.0, C.HBM_RESERVE.key: 0,
        C.HOST_SPILL_STORAGE.key: 1 << 22, C.CONCURRENT_TPU_TASKS.key: 1,
        C.PROFILE_ENABLED.key: True}))
    env = ResourceEnv.init(hbm_total=1 << 16, spill_dir=str(tmp_path),
                           device="cpu")
    owner = P.begin_query()
    try:
        rng = np.random.default_rng(0)
        bids = []
        for _ in range(3):
            bid = BufferId(env.catalog.next_table_id())
            env.device_store.add_batch(bid, ColumnarBatch.from_numpy({
                "a": rng.integers(0, 100, 1000).astype(np.int64),
                "b": rng.random(1000)}, device="cpu"))
            bids.append(bid)
        parked = env.device_store.current_size
        assert parked > 0
        ms = M.MetricSet()
        R.reset_oom_injection()
        with C.session(C.get_active_conf()):
            got = R.with_retry(lambda: "ok", out_bytes=60_000,
                               metrics=ms, label="t")
        assert got == "ok"
        led = MV.ledger()
        snap = led.snapshot().get("spill", {})
        dev_hops = {s: v for s, v in snap.items()
                    if s.startswith("device->")}
        assert dev_hops, snap
        dev_bytes = sum(v["bytes"] for v in dev_hops.values())
        cb = env.device_manager.spill_callback
        assert dev_bytes == cb.bytes_spilled == parked
        assert ms.value(M.SPILL_BYTES) == dev_bytes
        up0 = led.edge_bytes(MV.EDGE_UPLOAD, "serde.deserialize")
        for bid in bids:
            with env.catalog.acquired(bid) as buf:
                assert buf.tier.name in ("HOST", "DISK")
                buf.get_columnar_batch()
        assert led.edge_bytes(MV.EDGE_UPLOAD, "serde.deserialize") > up0
    finally:
        P.end_query(owner)
        ResourceEnv.shutdown()
        C.set_active_conf(C.RapidsConf())


def test_spill_attribution_is_per_thread():
    from spark_rapids_tpu_torch.memory.device_manager import SpillCallback

    class _Store:
        def __init__(self):
            self.current_size = 100

        def synchronous_spill(self, target):
            freed, self.current_size = self.current_size, 0
            return freed

    cb = SpillCallback(_Store())
    got = {}

    def victim():
        cb.take_thread_freed()
        cb.on_alloc_pressure(10, 1000, 0)
        got["victim"] = cb.take_thread_freed()

    t = threading.Thread(target=victim)
    t.start()
    t.join()
    assert got["victim"] == 100
    assert cb.take_thread_freed() == 0
    assert cb.bytes_spilled == 100


def test_three_way_spill_reconciliation(tmp_path):
    """The ledger's out-of-core spill edges == the process run
    accounting == the plan's spillRunBytes: three legs, one count."""
    from spark_rapids_tpu_torch.memory import oocore as OC
    from test_torch_out_of_core import (_Env, _orders, _sort_plan,
                                        _tree_metric)
    df = _orders()
    with _Env(tmp_path, "ledger", cap=1 << 16,
              **{"spark.rapids.sql.profile.enabled": True}) as e:
        plan = _sort_plan(df)
        e.run(plan)
        prof = P.last_profile()
        assert prof is not None
        sites = prof.movement["edges"][MV.EDGE_SPILL]["sites"]
        ledger_leg = sum(v["bytes"] for s, v in sites.items()
                         if s.startswith(OC.SITE_PREFIX))
        acct_leg = OC.run_bytes_spilled()
        metric_leg = _tree_metric(plan, M.SPILL_RUN_BYTES)
        assert ledger_leg > 0
        assert ledger_leg == acct_leg == metric_leg, \
            (ledger_leg, acct_leg, metric_leg)
        assert prof.oocore is not None
        assert prof.oocore["totals"]["spill_run_bytes"] == acct_leg
        assert prof.oocore["totals"]["merge_passes"] == \
            _tree_metric(plan, M.NUM_EXTERNAL_MERGE_PASSES)
        assert "-- out-of-core --" in prof.explain()
        e.assert_clean()


# ---------------------------------------------------------------------------
# wire + compression unit conservation
def test_wire_codec_roundtrip_conservation():
    from spark_rapids_tpu_torch.shuffle import compression as CP
    from spark_rapids_tpu_torch.shuffle.client_server import (
        BufferReceiveState, ShuffleReceiveHandler)
    pytest.importorskip("pyarrow")
    codec = CP.get_codec("lz4")
    blob = b"movement-ledger-payload-" * 500
    owner = P.begin_query(C.RapidsConf(
        {"spark.rapids.sql.profile.enabled": True,
         "spark.rapids.sql.profile.movement.minEventBytes": 0}))
    assert owner is not None
    try:
        wire = codec.compress(blob)
        CP.note_compression(codec.name, len(blob), len(wire))
        MV.record(MV.EDGE_WIRE, len(wire), site="send:dcn",
                  raw_bytes=len(blob))
        got = []

        class _H(ShuffleReceiveHandler):
            def buffer_received(self, w, r):
                got.append((w, r))

        state = BufferReceiveState.__new__(BufferReceiveState)
        state.progress = None
        state._chunks = {}
        state.completed = set()
        state._lock = threading.Lock()
        state.handler = _H()
        state.metas = {}
        try:
            state.on_chunk(1, 0, wire[:100], False, codec.codec_id,
                           len(blob))
            state.on_chunk(1, 1, wire[100:], True, codec.codec_id,
                           len(blob))
        except KeyError:
            pass  # no meta registered: assembly and ledger ran
        assert got == [(len(wire), len(blob))]
        snap = owner.ledger.snapshot()["wire"]
        assert snap["send:dcn"]["bytes"] == snap["recv"]["bytes"] \
            == len(wire)
        assert snap["recv"]["raw_bytes"] == len(blob)
        assert len(wire) < len(blob)
        st = CP.compression_stats()["lz4"]
        assert st["ratio"] < 1.0 and st["payloads"] >= 1
        rep = owner.ledger.report(1.0)
        assert rep["edges"]["wire"]["compression_ratio"] < 1.0
    finally:
        P.end_query(owner)


def test_collective_edge_exists_unrecorded():
    """(In place of the mesh twin, see the module docstring.)"""
    assert MV.EDGE_COLLECTIVE in MV.EDGES
    assert RL.edge_gbps("collective", C.RapidsConf()) == 450.0
    led = MV.DataMovementLedger("q", 0)
    assert led.report(1.0)["edges"]["collective"]["bytes"] == 0


# ---------------------------------------------------------------------------
# disabled path: zero-allocation hooks + parity
def test_disabled_hooks_allocate_nothing():
    assert P.tracer() is None
    assert MV.ledger() is None
    MV.record(MV.EDGE_UPLOAD, 123, site="x")
    CK.note_host_sync("movement-test", nbytes=64)
    assert CK.host_sync_bytes().get("movement-test") == 64
    assert MV.ledger() is None
    out = port_query(1, **{"spark.rapids.sql.profile.enabled": False})
    assert len(out) > 0
    assert P.profile_history() == []


def test_movement_off_rides_profile_on():
    port_query(1, **{"spark.rapids.sql.profile.movement.enabled": False})
    prof = P.last_profile()
    assert prof is not None and prof.spans
    assert prof.movement is None
    assert prof.movement_samples == []


def test_host_sync_bytes_counter_unit():
    CK.reset_host_syncs()
    CK.note_host_sync("a", nbytes=100)
    CK.note_host_sync("a", nbytes=50)
    CK.note_host_sync("b")
    assert CK.host_sync_bytes() == {"a": 150}
    assert CK.host_sync_sites()["a"] == 2
    assert CK.host_sync_sites()["b"] == 1
    CK.reset_host_syncs()
    assert CK.host_sync_bytes() == {}


# ---------------------------------------------------------------------------
# per-query isolation across concurrent scheduler sessions
def test_per_query_isolation_concurrent():
    results, errors = {}, []

    def worker(q):
        try:
            results[q] = port_query(q)
        except BaseException as e:  # noqa: BLE001
            errors.append((q, repr(e)))

    ts = [threading.Thread(target=worker, args=(q,)) for q in (1, 3)]
    [t.start() for t in ts]
    [t.join(300) for t in ts]
    assert not errors, errors
    profs = P.profile_history()
    assert len(profs) == 2
    assert len({p.query_id for p in profs}) == 2
    for p in profs:
        assert p.movement is not None
        assert p.movement["total_bytes"] > 0, p.query_id
        for e in p.events:
            assert e["query_id"] == p.query_id
    totals = sorted(p.movement["total_bytes"] for p in profs)
    assert totals[0] != totals[1]


def test_ledger_report_units_unit():
    led = MV.DataMovementLedger("qtest", 0, min_event_bytes=1 << 30)
    led.record(MV.EDGE_UPLOAD, 10 * 10 ** 9, site="s", dur_ns=10 ** 9)
    rep = led.report(wall_s=2.0)
    e = rep["edges"]["upload"]
    assert e["bytes"] == 10 * 10 ** 9
    assert e["gbps_avg"] == pytest.approx(5.0)
    assert e["gbps_busy"] == pytest.approx(10.0)
    assert e["roofline_gbps"] == MV.NOMINAL_GBPS["upload"] == 64.0
    assert e["roofline_utilization"] == pytest.approx(5.0 / 64.0)
    rep2 = led.report(wall_s=2.0, roofline_gbps=100.0)
    assert rep2["edges"]["upload"]["roofline_utilization"] == \
        pytest.approx(0.05)
    assert MV.format_report(rep).strip()
    assert MV.format_report(None) == "<no movement recorded>"


def test_vector_device_bytes_counts_logical_bytes():
    """The ledger charges numel() * element_size() per tensor (a view's
    own bytes, not its storage's)."""
    import torch
    from spark_rapids_tpu_torch.columnar.vector import ColumnVector
    from spark_rapids_tpu_torch import types as T
    data = torch.arange(64, dtype=torch.int64)[:16]
    col = ColumnVector(T.INT64, data, torch.ones(16, dtype=torch.bool))
    assert MV.vector_device_bytes(col) == 16 * 8 + 16


# ---------------------------------------------------------------------------
# the losing hedge's bytes are charged to the wasted site
def test_losing_hedge_charged_to_wasted_site():
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning
    from test_torch_shuffle_manager import local_source
    from test_torch_speculation import HEDGE, SLOW_SERVER, _df, _mgr_conf
    df = _df()
    conf = C.RapidsConf(_mgr_conf(**SLOW_SERVER, **HEDGE, **{
        "spark.rapids.sql.profile.enabled": True}))
    _shuffle_reset()
    try:
        with C.session(conf):
            ex = ShuffleExchangeExec(HashPartitioning([col("k")], 3),
                                     local_source(PORT, df, 4))
            out = ex.collect().to_pandas()
    finally:
        _shuffle_reset()
    assert len(out) == len(df)
    prof = P.last_profile()
    assert prof is not None and prof.movement is not None
    sites = prof.movement["edges"]["wire"]["sites"]
    assert sites.get("wasted", {}).get("bytes", 0) > 0, sites
    recv = sum(v["bytes"] for s, v in sites.items() if s.startswith("recv"))
    counted = sum(v["bytes"] for s, v in sites.items()
                  if not s.startswith("recv") and s != "replicate")
    assert counted == recv, sites
