"""spark_rapids_tpu_torch's SPMD whole-stage lane (exec/spmd.py, the SPMD
planning of plan/fusion.py, scheduler.whole_mesh_dispatch) against
spark_rapids_tpu's, on an 8-slot CPU mesh of one process (the reference
runs on eight virtual CPU devices).

Twins of the 15 tests (16 cases) of tests/test_spmd.py:
* one gang dispatch per fused stage, however many partitions, equal to
  the per-partition lane (and, with 3 partitions, to the reference's
  SPMD lane on the same frames);
* TPC-H Q1 against the per-partition lane and the reference's SPMD run
  over its 8-device mesh, TPC-DS q3 against the per-partition lane and
  the reference's CPU engine (keys, counts and order exact; sums at
  pandas' and compare_frames' rtol 1e-5), Q1 under seeded OOM
  injection, a ragged last partition;
* the conf flipped per query on four concurrent sessions;
* deopts with parity: a gang that fails to build (the reference's trace
  failure: the port runs eagerly and has no trace, so the stacker is
  made to raise), a mixed narrow-shadow layout;
* default off, no mesh: the per-partition lane;
* the collective edge (site spmd-stage), and its reconciliation with the
  mesh exchange's;
* make_mesh's refusal, memoized placements, the whole-mesh gate.
Plus the port's own case: a stage that reads the task context
(spark_partition_id(), monotonically_increasing_id()) deopts and equals
the per-partition lane, since flattened slots would shift its rows.
"""
import threading

import numpy as np
import pandas as pd
import pytest
from pandas.testing import assert_frame_equal
from parity import compare_frames

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import spmd as SP
from spark_rapids_tpu_torch.exec.basic import (FilterExec, LocalBatchSource,
                                               ProjectExec)
from spark_rapids_tpu_torch.exprs.base import col, lit
from spark_rapids_tpu_torch.models.tpch_bench import BENCH_CONF, run_query
from spark_rapids_tpu_torch.models.tpch_data import gen_tables
from spark_rapids_tpu_torch.parallel.mesh import (active_mesh, data_sharding,
                                                  make_mesh, replicated)
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.fusion import FusedStageExec, fuse_plan
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

SPMD_ON = {"spark.rapids.sql.spmd.enabled": True}


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device="cpu", slots_per_device=8)


@pytest.fixture(scope="module")
def rmesh8():
    import jax
    from spark_rapids_tpu.parallel.mesh import make_mesh as r_make_mesh
    assert len(jax.devices()) >= 8, "conftest must force 8 cpu devices"
    return r_make_mesh(8)


@pytest.fixture(scope="module")
def tpch_tables():
    return gen_tables(np.random.default_rng(11), 1500)


@pytest.fixture(scope="module")
def tpcds_tables():
    from spark_rapids_tpu_torch.models import tpcds_data
    return tpcds_data.gen_tables(np.random.default_rng(3), 3000)


@pytest.fixture(scope="module")
def q1_ref(tpch_tables):
    """The port's per-partition Q1, shared by the module's parity tests."""
    return run_query(1, tpch_tables, device="cpu", conf=_conf())


def _conf(**kv):
    base = dict(BENCH_CONF)
    base.update({k.replace("__", "."): v for k, v in kv.items()})
    return C.RapidsConf(base)


def _find(plan, name):
    if type(plan).__name__ == name:
        return plan
    for c in getattr(plan, "children", []):
        r = _find(c, name)
        if r is not None:
            return r
    return None


def _chain_frame(rows=4000, seed=1) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"a": rng.integers(0, 1000, rows).astype(np.int64),
                         "b": rng.uniform(0, 10, rows)})


def _chain_plan(nodes, col_, lit_, asc, df, parts):
    """Sort(Project(Filter(Project(source)))) over `df`, built from either
    package's classes."""
    src = nodes.CpuSource.from_pandas(df, num_partitions=parts)
    return nodes.CpuSort(
        [asc(col_("y"))],
        nodes.CpuProject(
            [(col_("x") + col_("x")).alias("y"), col_("b2")],
            nodes.CpuFilter(col_("x") > lit_(100),
                            nodes.CpuProject(
                                [(col_("a") * lit_(2)).alias("x"),
                                 (col_("b") * lit_(3.0)).alias("b2")],
                                src))),
        global_sort=True)


def _port_chain(df, parts):
    from spark_rapids_tpu_torch.exec.sort import asc
    return _chain_plan(N, col, lit, asc, df, parts)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("parts", [3, 13])
def test_one_gang_dispatch_per_stage(mesh8, rmesh8, parts):
    df = _chain_frame(seed=parts)
    on, off = _conf(**SPMD_ON), _conf()
    ref = collect(accelerate(_port_chain(df, parts), off, device="cpu"), off)
    SP.reset_spmd_stats()
    with active_mesh(mesh8):
        p = accelerate(_port_chain(df, parts), on, device="cpu")
        assert _find(p, "FusedStageExec") is not None, p.tree_string()
        got = collect(p, on)
    st = SP.spmd_stats()
    # one dispatch for the whole stage, however many partitions
    assert st["gang_dispatches"] == 1, st
    assert st["gang_batches"] == parts, st
    assert st["deopts"] == 0, st
    fused = _find(p, "FusedStageExec")
    assert fused.metrics.as_dict().get("numSpmdDispatches") == 1
    assert_frame_equal(got.reset_index(drop=True),
                       ref.reset_index(drop=True))
    if parts == 3:
        # the reference's SPMD lane over its 8 devices, same frame
        from spark_rapids_tpu import config as RC
        from spark_rapids_tpu.exec.sort import asc as r_asc
        from spark_rapids_tpu.exprs.base import col as r_col
        from spark_rapids_tpu.exprs.base import lit as r_lit
        from spark_rapids_tpu.parallel.mesh import active_mesh as r_active
        from spark_rapids_tpu.plan import nodes as RN
        from spark_rapids_tpu.plan import overrides as RO
        rconf = RC.RapidsConf({**BENCH_CONF, **SPMD_ON})
        with r_active(rmesh8):
            want = RO.collect(RO.accelerate(_chain_plan(
                RN, r_col, r_lit, r_asc, df, parts), rconf), rconf)
        assert_frame_equal(got.reset_index(drop=True),
                           want.reset_index(drop=True), check_dtype=False)


# ---------------------------------------------------------------------------
def _keys_exact(got, want) -> None:
    for c in got.columns:
        if not pd.api.types.is_float_dtype(got[c]):
            assert list(got[c]) == list(want[c]), f"{c}: keys or order"


def test_tpch_q1_parity_spmd_vs_per_partition(mesh8, rmesh8, tpch_tables,
                                              q1_ref):
    from spark_rapids_tpu import config as RC
    from spark_rapids_tpu.models import tpch_bench as RB
    from spark_rapids_tpu.parallel.mesh import active_mesh as r_active
    SP.reset_spmd_stats()
    with active_mesh(mesh8):
        got = run_query(1, tpch_tables, device="cpu", conf=_conf(**SPMD_ON))
    assert SP.spmd_stats()["gang_dispatches"] >= 1
    assert_frame_equal(got.reset_index(drop=True),
                       q1_ref.reset_index(drop=True))
    with r_active(rmesh8):
        want = RB.run_query(1, tpch_tables,
                            conf=RC.RapidsConf({**BENCH_CONF, **SPMD_ON}))
    compare_frames(want, got, "q1 spmd against the reference's")
    _keys_exact(got, want)


def _run_tpcds(name, tables, conf):
    from spark_rapids_tpu_torch.models import tpcds_data, tpcds_queries
    t = tpcds_data.sources(tables, 2)

    def runner(p):
        return collect(accelerate(p, conf, device="cpu"), conf)
    return runner(tpcds_queries.QUERIES[name](t, runner))


def test_tpcds_q3_parity_spmd_vs_per_partition(mesh8, tpcds_tables):
    from spark_rapids_tpu.models import tpcds_data as RDS
    from spark_rapids_tpu.models import tpcds_queries as RQ
    ref = _run_tpcds("q3", tpcds_tables, _conf())
    SP.reset_spmd_stats()
    with active_mesh(mesh8):
        got = _run_tpcds("q3", tpcds_tables, _conf(**SPMD_ON))
    assert SP.spmd_stats()["gang_dispatches"] >= 1
    assert_frame_equal(got.reset_index(drop=True),
                       ref.reset_index(drop=True))

    def cpu_run(p):
        return p.collect()
    want = cpu_run(RQ.QUERIES["q3"](RDS.sources(tpcds_tables, 2), cpu_run))
    compare_frames(want, got, "q3 spmd against the reference's CPU engine")
    _keys_exact(got, want)


def test_q1_parity_under_seeded_oom_injection(mesh8, tpch_tables, q1_ref):
    from spark_rapids_tpu_torch.memory.retry import reset_oom_injection
    inject = {
        "spark__rapids__memory__faultInjection__oomRate": 1.0,
        "spark__rapids__memory__faultInjection__seed": 7,
        "spark__rapids__memory__faultInjection__maxInjections": 12}
    reset_oom_injection()
    with active_mesh(mesh8):
        got = run_query(1, tpch_tables, device="cpu",
                        conf=_conf(**SPMD_ON, **inject))
    reset_oom_injection()
    assert_frame_equal(got.reset_index(drop=True),
                       q1_ref.reset_index(drop=True))


# ---------------------------------------------------------------------------
def test_ragged_last_partition(mesh8):
    """Per-slot masks keep padding exact: 4 non-empty partitions of very
    different sizes padded to 8 slots."""
    rng = np.random.default_rng(21)

    def part(n):
        return [ColumnarBatch.from_numpy({
            "v": rng.integers(0, 500, n).astype(np.int64),
            "w": rng.uniform(0, 1, n)}, device="cpu")] if n else []

    parts = [part(2000), part(700), part(33), [], part(3)]
    schema = parts[0][0].schema
    on = _conf(**SPMD_ON)

    def build():
        src = LocalBatchSource([list(p) for p in parts], schema,
                               device="cpu")
        return FilterExec(col("v") % lit(3) == lit(0),
                          ProjectExec([(col("v") * lit(2)).alias("v"),
                                       col("w")], src))

    off_conf = _conf()
    with C.session(off_conf):
        ref = fuse_plan(build(), off_conf).collect().to_pandas()
    SP.reset_spmd_stats()
    with C.session(on), active_mesh(mesh8):
        p = fuse_plan(build(), on)
        assert isinstance(p, FusedStageExec)
        got = p.collect().to_pandas()
    st = SP.spmd_stats()
    assert st["gang_dispatches"] == 1 and st["deopts"] == 0, st
    assert st["gang_batches"] == 4 and st["gang_slots"] == 8, st
    assert_frame_equal(got.reset_index(drop=True),
                       ref.reset_index(drop=True))


def test_spmd_flipped_per_query_concurrently(mesh8, tpch_tables, q1_ref):
    from spark_rapids_tpu_torch.exec.scheduler import mesh_gate_stats
    results, errors = {}, []

    def worker(i, conf):
        try:
            results[i] = run_query(1, tpch_tables, device="cpu", conf=conf)
        except BaseException as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    confs = [_conf(**SPMD_ON), _conf(), _conf(**SPMD_ON), _conf()]
    SP.reset_spmd_stats()
    gate0 = mesh_gate_stats()["dispatches"]
    with active_mesh(mesh8):
        ts = [threading.Thread(target=worker, args=(i, cf))
              for i, cf in enumerate(confs)]
        [t.start() for t in ts]
        [t.join(300) for t in ts]
    assert not errors, errors
    assert len(results) == len(confs)
    for df in results.values():
        assert_frame_equal(df.reset_index(drop=True),
                           q1_ref.reset_index(drop=True))
    # only the SPMD sessions ganged; the gate saw every dispatch
    assert SP.spmd_stats()["gang_dispatches"] >= 2
    assert mesh_gate_stats()["dispatches"] - gate0 >= 2


# ---------------------------------------------------------------------------
def test_gang_build_failure_deopts_to_per_partition_with_parity(
        mesh8, monkeypatch):
    """Twin of test_trace_failure_deopts_to_per_partition_with_parity: a
    gang that fails to build deopts this stage, which then runs on the
    per-partition lane with the right answer."""
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 50, 500).astype(np.int64)
    src = LocalBatchSource([[ColumnarBatch.from_numpy(
        {"v": part}, device="cpu")] for part in np.array_split(vals, 3)],
        device="cpu")
    p1 = ProjectExec([(col("v") * lit(2)).alias("w")], src)
    p2 = ProjectExec([(col("w") + lit(1)).alias("u")], p1)
    conf = _conf(**SPMD_ON)

    def broken(*a, **k):
        raise NotImplementedError("gang stacker broken for the deopt test")
    monkeypatch.setattr(SP, "_stack_gang", broken)
    SP.reset_spmd_stats()
    with C.session(conf), active_mesh(mesh8):
        fused = fuse_plan(p2, conf)
        assert isinstance(fused, FusedStageExec)
        out = fused.collect().to_pandas()
    assert fused._spmd_deopt and "spmd-deopt" in fused.describe()
    assert fused.metrics.as_dict().get("numSpmdDeopts", 0) >= 1
    assert SP.spmd_stats()["deopts"] >= 1
    assert (out["u"].to_numpy(dtype=np.int64) == vals * 2 + 1).all()


def test_mixed_narrow_layout_deopts_with_parity(mesh8):
    """One partition's int64 column fits int32 (its narrow shadow is
    uploaded) and another's does not: the gang's layout cannot be made
    one, so the stage deopts to the per-partition lane."""
    small = np.arange(100, dtype=np.int64)
    big = np.arange(100, dtype=np.int64) + (1 << 40)
    b_small = ColumnarBatch.from_numpy({"v": small}, device="cpu")
    b_big = ColumnarBatch.from_numpy({"v": big}, device="cpu")
    assert b_small.column("v").narrow is not None
    assert b_big.column("v").narrow is None
    src = LocalBatchSource([[b_small], [b_big]], b_small.schema,
                           device="cpu")
    plan = ProjectExec([(col("v") + lit(1)).alias("v1")], src)
    conf = _conf(**SPMD_ON)
    with C.session(conf):
        fused = fuse_plan(plan, conf)
        assert isinstance(fused, FusedStageExec)
        SP.reset_spmd_stats()
        with active_mesh(mesh8):
            got = fused.collect().to_pandas()
    assert SP.spmd_stats()["deopts"] == 1
    assert fused.metrics.as_dict().get("numSpmdDeopts") == 1
    exp = np.concatenate([small, big]) + 1
    assert (np.sort(got["v1"].to_numpy(dtype=np.int64))
            == np.sort(exp)).all()


def test_no_mesh_means_per_partition_lane(tpch_tables, q1_ref):
    SP.reset_spmd_stats()
    got = run_query(1, tpch_tables, device="cpu", conf=_conf(**SPMD_ON))
    assert SP.spmd_stats()["gang_dispatches"] == 0
    assert_frame_equal(got.reset_index(drop=True),
                       q1_ref.reset_index(drop=True))


def test_default_off_keeps_plan_and_lane_untouched(mesh8):
    """spmd.enabled off (the default): no lone-operator stage, the
    aggregate's pre-chain still folds, and no gang dispatches even with a
    mesh active."""
    conf = _conf()
    SP.reset_spmd_stats()
    with active_mesh(mesh8):
        p = accelerate(_port_chain(_chain_frame(seed=41), 5), conf,
                       device="cpu")
        collect(p, conf)
    assert SP.spmd_stats()["gang_dispatches"] == 0


# ---------------------------------------------------------------------------
def test_gang_collective_bytes_on_ledger(mesh8):
    from spark_rapids_tpu_torch.utils import profile as P
    conf = _conf(**SPMD_ON, spark__rapids__sql__profile__enabled=True)
    with active_mesh(mesh8):
        collect(accelerate(_port_chain(_chain_frame(seed=5), 8), conf,
                           device="cpu"), conf)
    prof = P.last_profile()
    sites = prof.movement["edges"]["collective"]["sites"]
    assert "spmd-stage" in sites, sites
    # at least the [8 slots x cap] keep mask of this filtering chain
    assert sites["spmd-stage"]["bytes"] >= 8 * 512, sites
    assert sites["spmd-stage"]["dur_ns"] > 0
    ev = [e for e in prof.events if e["kind"] == "stage_spmd"]
    assert ev and ev[0]["mesh_devices"] == 8, ev


def test_collective_edge_reconciles_with_mesh_exchange(mesh8):
    """One chain feeding a mesh-routed hash exchange, SPMD on and off:
    both runs put the exchange's payload on the collective edge, and the
    SPMD run adds only its gang's bytes."""
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning
    from spark_rapids_tpu_torch.utils import profile as P

    def build():
        rng = np.random.default_rng(77)
        k = rng.integers(0, 64, 2048).astype(np.int64)
        v = rng.uniform(0, 1, 2048)
        src = LocalBatchSource([[ColumnarBatch.from_numpy(
            {"k": kk, "v": vv}, device="cpu")] for kk, vv in zip(
            np.array_split(k, 4), np.array_split(v, 4))], device="cpu")
        chain = FilterExec(col("k") < lit(60),
                           ProjectExec([col("k"),
                                        (col("v") * lit(2.0)).alias("v2")],
                                       src))
        return ShuffleExchangeExec(HashPartitioning([col("k")], 8), chain)

    def run(conf):
        with C.session(conf), active_mesh(mesh8):
            fuse_plan(build(), conf).collect()
        return P.last_profile().movement["edges"]["collective"]

    off = run(_conf(spark__rapids__sql__profile__enabled=True))
    on = run(_conf(**SPMD_ON, spark__rapids__sql__profile__enabled=True))
    assert off["bytes"] > 0
    spmd_extra = on["sites"].get("spmd-stage", {}).get("bytes", 0)
    assert spmd_extra > 0
    # the same exchange payload; only the gang's bytes differ
    assert on["bytes"] - spmd_extra == pytest.approx(off["bytes"], rel=0.02)


# ---------------------------------------------------------------------------
def test_task_context_stage_deopts_with_parity(mesh8):
    """spark_partition_id() and monotonically_increasing_id() in an SPMD
    stage: flattened slots would shift the row positions these read, so
    the stage deopts and its result equals the per-partition lane's."""
    from spark_rapids_tpu_torch.exprs import misc as MX
    rng = np.random.default_rng(13)

    def build():
        src = LocalBatchSource([[ColumnarBatch.from_numpy(
            {"v": rng_v}, device="cpu")] for rng_v in (
            np.arange(300, dtype=np.int64), np.arange(40, dtype=np.int64))],
            device="cpu")
        return ProjectExec(
            [col("v"), MX.SparkPartitionID().alias("pid"),
             MX.MonotonicallyIncreasingID().alias("mid")],
            FilterExec(col("v") % lit(2) == lit(0), src))

    del rng
    off = _conf()
    with C.session(off):
        ref = fuse_plan(build(), off).collect().to_pandas()
    on = _conf(**SPMD_ON)
    SP.reset_spmd_stats()
    with C.session(on), active_mesh(mesh8):
        p = fuse_plan(build(), on)
        assert isinstance(p, FusedStageExec)
        got = p.collect().to_pandas()
    assert SP.spmd_stats()["deopts"] == 1 and p._spmd_deopt
    assert_frame_equal(got.reset_index(drop=True),
                       ref.reset_index(drop=True), check_exact=True)


def test_gang_over_two_device_groups():
    """A mesh whose slots lie on two devices (torch's "cpu" and "cpu:0",
    which compare unequal): each device evaluates its own slots and the
    outputs gather to the home device, equal to the per-partition lane."""
    from spark_rapids_tpu_torch.parallel.mesh import Mesh
    import torch
    mesh = Mesh(tuple([torch.device("cpu"), torch.device("cpu", 0)] * 4))
    df = _chain_frame(seed=7)
    on, off = _conf(**SPMD_ON), _conf()
    ref = collect(accelerate(_port_chain(df, 6), off, device="cpu"), off)
    SP.reset_spmd_stats()
    with active_mesh(mesh):
        got = collect(accelerate(_port_chain(df, 6), on, device="cpu"), on)
    st = SP.spmd_stats()
    assert st["gang_dispatches"] == 1 and st["deopts"] == 0, st
    assert st["gang_batches"] == 6 and st["gang_slots"] == 8, st
    assert_frame_equal(got.reset_index(drop=True),
                       ref.reset_index(drop=True))


# ---------------------------------------------------------------------------
def test_make_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="exceeds the"):
        make_mesh(2, device="cpu")


def test_shardings_are_memoized(mesh8):
    assert data_sharding(mesh8) is data_sharding(mesh8)
    assert replicated(mesh8) is replicated(mesh8)
    assert data_sharding(mesh8) is not replicated(mesh8)


def test_whole_mesh_dispatch_gate_serializes():
    import time
    from spark_rapids_tpu_torch.exec.scheduler import (mesh_gate_stats,
                                                       whole_mesh_dispatch)
    inside, overlaps = [0], [0]
    lock = threading.Lock()

    def body(i):
        with whole_mesh_dispatch(label=f"t{i}"):
            with lock:
                inside[0] += 1
                if inside[0] > 1:
                    overlaps[0] += 1
            time.sleep(0.02)
            with lock:
                inside[0] -= 1

    before = mesh_gate_stats()["dispatches"]
    ts = [threading.Thread(target=body, args=(i,)) for i in range(4)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert overlaps[0] == 0
    assert mesh_gate_stats()["dispatches"] - before == 4
