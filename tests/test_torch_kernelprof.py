"""spark_rapids_tpu_torch's kernel attribution (utils/kernelprof.py)
against spark_rapids_tpu's: twins of the 16 tests of
tests/test_kernelprof.py, at its scale.

The design differs (the module's docstring says how): the reference
wraps the executables of its kernel cache, times every Nth dispatch
behind a device sync and asks XLA for each kernel's cost; the port
brackets each eager step at the counterpart of a kernel-cache site
(`TpuExec.kp_step`, `kp_site`) and each hand-kernel launch in a watch,
times every Nth entry with CUDA events resolved at query end (the host
clock on the CPU, where these tests run) and takes an analytic cost.
So the unit twins drive `KP.watch` where the reference drives
`KernelCache`/`WatchedKernel`, the "compile excluded" twin charges an
nvcc build inside the bracket (the port's only compile), and the XLA
`cost_analysis` fields of test_kernelprof.py:148 become the analytic
`bytes_accessed`/`flops`.  Held equal against the reference's profiled
Q1: the result and the labels of the kernels the query entered.
"""
import threading

import numpy as np
import pytest
from pandas.testing import assert_frame_equal

from parity import compare_frames
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.ops import cuda_build
from spark_rapids_tpu_torch.utils import kernelprof as KP
from spark_rapids_tpu_torch.utils import movement as MV
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.utils import roofline as RL
from test_torch_profile import (BASE, port_query, port_tables, ref_profile,
                                reset_observability)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

KCONF = {"spark.rapids.sql.profile.kernels.enabled": True,
         "spark.rapids.sql.profile.kernels.sampleRate": 1}
NOPIPE = {"spark.rapids.sql.pipeline.enabled": False}


@pytest.fixture(autouse=True)
def _clean(one_torch_thread):  # noqa: F811
    reset_observability()
    yield
    reset_observability()


def _conf(**extra):
    kv = dict(BASE)
    kv.update({k.replace("__", "."): v for k, v in extra.items()})
    return C.RapidsConf(kv)


@pytest.fixture(scope="module")
def q1_profiled():
    """(reference df, port df, QueryProfile, catalog snapshot) of a
    warmed Q1 with every entry sampled, and the reference's."""
    reset_observability()
    ref_out, ref = ref_profile(1, **KCONF, **NOPIPE)
    port_query(1, **KCONF, **NOPIPE)
    got = port_query(1, **KCONF, **NOPIPE)
    prof = P.last_profile()
    cat = KP.catalog()
    reset_observability()
    return ref_out, got, prof, cat, ref


def _exec_labels(rows) -> set:
    return {r["label"] for r in rows if r["owner_id"] is not None}


# ---------------------------------------------------------------------------
# disabled path: no entries, no allocation, bit-exact
def test_disabled_path_no_wrappers():
    assert not KP.enabled()
    assert KP.watch(("unit", ("k",))) is KP.NULL_WATCH
    with KP.watch(("unit", ("k",))) as w:
        w.cost(nbytes=1)
    port_query(1, **{"spark.rapids.sql.profile.enabled": False})
    assert KP.catalog_size() == 0


def test_disabled_hooks_allocate_nothing():
    assert not KP.enabled()

    class _E:
        exec_id = 999991

        def describe(self):
            return "E"

    assert TpuExec.kp_meta(_E(), "label") is None
    assert TpuExec.kp_step(_E(), "label", 1) is KP.NULL_WATCH
    assert KP.hand_watch("q1_fused", (1,), "cpu") is KP.NULL_WATCH
    assert KP.maybe_enable(_conf()) is False
    assert not KP.enabled()


def test_disabled_query_records_nothing():
    out = port_query(1)
    assert len(out) > 0
    prof = P.last_profile()
    assert prof is not None
    assert prof.kernels is None
    assert prof.kernel_samples == []
    assert "-- kernels --" not in prof.explain()


# ---------------------------------------------------------------------------
# enabled: parity + the report
def test_enabled_bit_exact_and_report(q1_profiled):
    ref_out, got, prof, _, ref = q1_profiled
    compare_frames(ref_out, got, "q1")
    assert_frame_equal(got.reset_index(drop=True),
                       port_query(1, **{"spark.rapids.sql.profile."
                                        "enabled": False}).reset_index(
                           drop=True))
    rows = prof.kernels
    assert rows, "no kernel attribution rows"
    assert all(len(r["fingerprint"]) == 12 for r in rows)
    assert sum(r["dispatches"] for r in rows) > 0
    assert sum(r["device_ms"] for r in rows) > 0
    ms = [r["device_ms"] for r in rows]
    assert ms == sorted(ms, reverse=True)
    ex = prof.explain()
    assert "-- kernels --" in ex
    assert rows[0]["fingerprint"] in ex
    # the kernels Q1 entered carry the reference's labels
    assert _exec_labels(rows) == _exec_labels(ref.kernels)


def test_cost_capture_and_roofline_join(q1_profiled):
    _, _, prof, cat, _ = q1_profiled
    roofed = [r for r in prof.kernels if "roofline_pct" in r]
    assert roofed, "no kernel carried a cost/roofline join"
    for r in roofed:
        assert r["flops_per_dispatch"] >= 0
        assert r["bytes_per_dispatch"] > 0
        assert r["gbps"] > 0
        assert 0 <= r["roofline_pct"] <= 100 * 50
        assert r["bound"] in ("compute", "memory")
    assert any(c["cost"] for c in cat)
    assert all(set(c["cost"]) == {"bytes_accessed", "flops"}
               for c in cat if c["cost"])
    assert any("/" in c["family"] for c in cat)


def test_coverage_vs_compute_bucket():
    """The summed per-kernel time explains the compute bucket at a
    scale the kernels dominate (the reference's 20,000 rows)."""
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    big = TD.gen_tables(np.random.default_rng(11), 20_000)
    conf = _conf(**{"spark.rapids.sql.profile.enabled": True},
                 **KCONF, **NOPIPE)
    TB.run_query(1, big, device="cpu", conf=conf)
    TB.run_query(1, big, device="cpu", conf=conf)
    prof = P.last_profile()
    kernel_ms = sum(r["device_ms"] for r in prof.kernels)
    compute_ms = prof.breakdown["compute_s"] * 1e3
    assert compute_ms > 0
    cov = kernel_ms / compute_ms
    assert 0.35 <= cov <= 1.5, f"kernel/compute coverage wildly off: {cov}"


def test_explain_inline_annotations(q1_profiled):
    _, _, prof, _, _ = q1_profiled
    lines = prof.plan_report.splitlines()
    annotated = [ln for ln in lines if "[kernel " in ln]
    assert annotated, "no inline kernel annotations in EXPLAIN"
    assert [ln for ln in annotated if ln.lstrip().startswith("* ")], \
        "fused member lines not annotated"
    assert any("roofline" in ln for ln in annotated)
    assert all(ln.rstrip().endswith("]") for ln in lines)


def test_perfetto_kernel_tracks(q1_profiled):
    _, _, prof, _, _ = q1_profiled
    ev = [e for e in prof.chrome_trace()["traceEvents"]
          if e.get("cat") == "kernel"]
    assert ev, "no kernel events in the Chrome trace"
    for e in ev:
        assert e["ph"] == "X" and e["dur"] > 0
        assert e["args"]["fingerprint"]
        assert e["args"]["query_id"] == prof.query_id


# ---------------------------------------------------------------------------
# sampling mechanics (unit)
def test_sample_rate_honored_and_compile_excluded():
    KP.enable(_conf(**{"spark.rapids.sql.profile.kernels.enabled": True,
                       "spark.rapids.sql.profile.kernels.sampleRate": 4,
                       "spark.rapids.sql.profile.kernels.costAnalysis":
                           False}))
    ident = (("kp-unit-rate",), ("k",))
    for i in range(40):
        with KP.watch(ident, device="cpu"):
            if i == 0:
                # an nvcc build inside the bracket: compile, not device
                cuda_build.record_builds(["unit-kernel"], 1000)
            sum(range(200))
    e = KP.entry_for(ident)
    assert e.dispatches == 40
    # entry 1 is the compile bracket; then every 4th: 4, 8, ..., 40
    assert e.sampled == 10, e.sampled
    assert e.compile_ns > 0
    assert e.device_ns > 0
    assert sum(e.snapshot()["hist"]) == e.sampled


def test_wrapper_transparency_and_upgrade_on_hit():
    """No wrapper in the port: an entry counts while attribution is on
    and the step runs unchanged; disabling returns the null watch."""
    ident = (("kp-unit-upgrade",), ("k",))
    assert KP.watch(ident) is KP.NULL_WATCH
    KP.enable(_conf(**{"spark.rapids.sql.profile.kernels.enabled": True,
                       "spark.rapids.sql.profile.kernels.costAnalysis":
                           False}))
    with KP.watch(ident, device="cpu"):
        out = 3 - 1
    assert out == 2
    assert KP.entry_for(ident).dispatches == 1
    KP.disable()
    assert KP.watch(ident) is KP.NULL_WATCH
    assert KP.entry_for(ident).dispatches == 1


def test_meta_annotation_reaches_catalog():
    KP.enable(_conf(**{"spark.rapids.sql.profile.kernels.enabled": True}))
    ident = (("kp-unit-meta",), ("k",))
    with KP.watch(ident, {"label": "unit-kernel", "owner_id": 424242,
                          "owner": "UnitExec(x)", "members": ["A", "B"]},
                  device="cpu") as w:
        w.cost(nbytes=64, flops=8)
    e = KP.entry_for(ident)
    assert e.label == "unit-kernel"
    assert e.members == ["A", "B"]
    assert "UnitExec(x)" in e.owners.values()
    assert e.cost == {"bytes_accessed": 64.0, "flops": 8.0}


# ---------------------------------------------------------------------------
# per-query isolation under the scheduler storm
def test_storm_keeps_per_query_isolation():
    ref = {q: port_query(q, **{"spark.rapids.sql.profile.enabled": False})
           for q in (1, 5)}
    P.clear_history()
    results, errors = {}, []

    def worker(i, q):
        try:
            results[i] = (q, port_query(q, **KCONF))
        except BaseException as e:  # noqa: BLE001
            errors.append((i, q, repr(e)))

    mix = [1, 5, 1, 5, 1, 5, 1, 5]
    ts = [threading.Thread(target=worker, args=(i, q))
          for i, q in enumerate(mix)]
    [t.start() for t in ts]
    [t.join(300) for t in ts]
    assert not errors, errors
    for i, (q, df) in results.items():
        assert_frame_equal(df.reset_index(drop=True),
                           ref[q].reset_index(drop=True))
    profs = P.profile_history()
    assert len(profs) == len(mix)
    assert len({p.query_id for p in profs}) == len(mix)
    for p in profs:
        assert p.kernels, f"{p.query_id} recorded no kernel rows"
        assert sum(r["dispatches"] for r in p.kernels) > 0
        for t0, dur, fp, label, tid in p.kernel_samples:
            assert dur > 0


# ---------------------------------------------------------------------------
# slow-query log + telemetry surface
def test_slow_query_log_top_kernel_and_prometheus():
    from spark_rapids_tpu_torch.utils import telemetry as T
    t = T.start(_conf(**{"spark.rapids.sql.telemetry.enabled": True,
                         "spark.rapids.sql.telemetry.samplePeriodMs": 20.0}),
                http_port=0)
    for _ in range(2):
        port_query(1, **KCONF)
    slow = t.slow_query_log()
    assert slow
    tk = slow[0]["top_kernel"]
    assert len(tk["fingerprint"]) == 12
    assert 0 < tk["device_share_pct"] <= 100.0
    text = t.registry.prometheus_text()
    assert "tpu_rapids_kernel_device_seconds_total" in text
    assert "tpu_rapids_kernel_time_seconds_" in text
    assert "tpu_rapids_kernel_catalog_entries" in text


# ---------------------------------------------------------------------------
# the shared roofline source
def test_roofline_single_source_defaults():
    assert MV.NOMINAL_GBPS is RL.DEFAULT_EDGE_GBPS
    assert RL.edge_table(C.RapidsConf()) == RL.DEFAULT_EDGE_GBPS
    # the port's defaults are H100 SXM5 datasheet figures
    assert RL.DEFAULT_EDGE_GBPS == {"upload": 64.0, "readback": 64.0,
                                    "spill": 64.0, "wire": 12.5,
                                    "collective": 450.0}
    assert RL.hbm_gbps(C.RapidsConf()) == 3350.0
    assert RL.peak_gflops(C.RapidsConf()) == 66900.0


def test_roofline_conf_overrides_flow_everywhere():
    conf = C.RapidsConf({
        "spark.rapids.sql.profile.roofline.wireGBps": 99.0,
        "spark.rapids.sql.profile.roofline.hbmGBps": 500.0,
        "spark.rapids.sql.profile.roofline.peakGflops": 1234.0})
    assert RL.edge_gbps("wire", conf) == 99.0
    assert RL.hbm_gbps(conf) == 500.0
    assert RL.peak_gflops(conf) == 1234.0
    led = MV.DataMovementLedger("qtest", 0)
    led.record(MV.EDGE_WIRE, 10_000_000, site="send:loop")
    assert led.report(1.0, conf=conf)["edges"]["wire"]["roofline_gbps"] \
        == 99.0
    both = conf.set("spark.rapids.sql.profile.movement.rooflineGBps", 7.0)
    rep2 = led.report(1.0, float(both[C.MOVEMENT_ROOFLINE_GBPS]), conf=both)
    assert rep2["edges"]["wire"]["roofline_gbps"] == 7.0
    assert RL.edge_gbps("wire", both) == 7.0


def test_roofline_changes_kernel_report():
    KP.enable(_conf(**{"spark.rapids.sql.profile.kernels.enabled": True,
                       "spark.rapids.sql.profile.kernels.sampleRate": 1}))
    ident = (("kp-unit-roofline",), ("k",))
    e = KP.entry_for(ident)
    e.set_cost({"bytes_accessed": 16384.0, "flops": 8192.0})
    led = KP.QueryKernelLedger("qtest", 0)
    for _ in range(4):
        led.note(e, KP._Sample(e, None, None, 0, 1_000_000, 0))
    led.resolve()
    lo = led.report(C.RapidsConf({
        "spark.rapids.sql.profile.roofline.hbmGBps": 1000.0,
        "spark.rapids.sql.profile.roofline.peakGflops": 1e6}))
    hi = led.report(C.RapidsConf({
        "spark.rapids.sql.profile.roofline.hbmGBps": 1.0,
        "spark.rapids.sql.profile.roofline.peakGflops": 1.0}))
    assert lo[0]["roofline_pct"] < hi[0]["roofline_pct"]
