"""spark_rapids_tpu_torch's out-of-core lanes against spark_rapids_tpu's,
twins of 16 of the 17 tests of tests/test_out_of_core.py (the other one,
`test_three_way_spill_reconciliation`, reads the movement ledger: its
twin is in tests/test_torch_movement.py).

When the conf-capped device budget (`spark.rapids.memory.hbmBudgetBytes`)
cannot hold an operator's working set, sort / hash join / hash aggregate
degrade to external algorithms that stream runs through the
device→host→disk spill tiers.  Every budgeted result must equal the JAX
package's unconstrained result on the same seeded inputs, computed once
per module: bit-exact for sorts, joins, integer aggregates, keys and
counts; the chaos TPC-H query's float sums within compare_frames' rtol
1e-5 (the f32 lanes add in another order once a batch splits).  Corrupt
spills recover through replicas or recompute, and exhausted recursion
bounds raise a descriptive `TpuOutOfCoreError`.

The port's device bytes count the 32-bit shadows the reference's do not
(13 bytes a row for an int64 column with an int32 shadow, 9 in the
reference), and its grace slices are cut to tight capacities, so two
tests take other knobs than the reference's to reach the same lane
(each says which and why).
"""
import os
import time

import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec import aggregate as RA
from spark_rapids_tpu.exec import joins as RJ
from spark_rapids_tpu.exec import sort as RSo
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exprs import aggregates as RAg
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.memory import retry as RR
from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import aggregate as A
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec import sort as So
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exprs import aggregates as Ag
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.memory import ResourceEnv
from spark_rapids_tpu_torch.memory import oocore as OC
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory import stores as ST
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.transitions import batch_from_df
from spark_rapids_tpu_torch.utils import metrics as M
from test_torch_pipeline import run_tpch_files, write_tpch_files

#: an uncapped device total for the accounted arena: big enough that
#: the unconstrained lane never degrades
HBM_TOTAL = 1 << 26


class _Env:
    """One bounded-memory ResourceEnv of the port: active conf with the
    budget cap and injection knobs, fresh injection and accounting
    state, and a check that nothing leaked."""

    def __init__(self, tmp_path, name, cap=0, host_spill=1 << 22,
                 **extra):
        keys = {C.HBM_ALLOC_FRACTION.key: 1.0, C.HBM_RESERVE.key: 0,
                C.HOST_SPILL_STORAGE.key: host_spill,
                C.CONCURRENT_TPU_TASKS.key: 1}
        if cap:
            keys[C.HBM_BUDGET_BYTES.key] = cap
        keys.update(extra)
        self.conf = C.RapidsConf(keys)
        C.set_active_conf(self.conf)
        self.env = ResourceEnv.init(hbm_total=HBM_TOTAL,
                                    spill_dir=str(tmp_path / name),
                                    device="cpu")
        R.reset_oom_injection()
        ST.reset_spill_corruption()
        OC.reset_run_accounting()

    def __enter__(self):
        return self

    def run(self, plan):
        with C.session(self.conf):
            return plan.collect().to_pandas()

    def assert_clean(self):
        """No leaked buffers, admissions, reservations or spill files."""
        env, dm = self.env, self.env.device_manager
        assert len(env.catalog) == 0, \
            f"leaked buffers: {list(env.catalog.ids())}"
        assert dm.admissions() == {}, dm.admissions()
        assert dm.reserved_bytes == 0
        assert env.disk_store.orphaned_spill_files() == []

    def __exit__(self, *exc):
        ResourceEnv.shutdown()
        C.set_active_conf(C.RapidsConf())
        return False


@pytest.fixture(autouse=True)
def _isolated():
    yield
    ResourceEnv.shutdown()
    C.set_active_conf(C.RapidsConf())


def _src(df, nb):
    step = -(-len(df) // nb)
    schema = schema_of_df(df)
    return LocalBatchSource([[batch_from_df(
        df.iloc[i:i + step].reset_index(drop=True), schema, "cpu")
        for i in range(0, len(df), step)]], device="cpu")


def _ref_src(df, nb):
    step = -(-len(df) // nb)
    return RSource([[RBatch.from_pandas(
        df.iloc[i:i + step].reset_index(drop=True))
        for i in range(0, len(df), step)]])


def _parts(df, n):
    step = -(-len(df) // n)
    schema = schema_of_df(df)
    return LocalBatchSource([[batch_from_df(
        df.iloc[i:i + step].reset_index(drop=True), schema, "cpu")]
        for i in range(0, len(df), step)], device="cpu")


def _tree_metric(exec_, name):
    total = exec_.metrics.value(name)
    for ch in exec_.children:
        total += _tree_metric(ch, name)
    return total


def _rows(df: pd.DataFrame) -> list:
    return [tuple(None if v is None or v is pd.NA
                  or (isinstance(v, float) and v != v) else v for v in r)
            for r in df.astype(object).itertuples(index=False)]


def _key(row):
    return tuple((v is None, 0 if v is None else v) for v in row)


def _assert_bit_exact(want, got, label, ordered=False):
    assert list(want.columns) == list(got.columns), label
    w, g = _rows(want), _rows(got)
    if not ordered:
        w, g = sorted(w, key=_key), sorted(g, key=_key)
    assert w == g, label


# -- plan builders (the reference's shapes) ---------------------------------
def _orders(seed=5, n=5000):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "x": rng.integers(-500, 500, n).astype(np.int64),
        "y": rng.integers(0, 1_000_000, n).astype(np.int64)})


def _sort_plan(df, nb=8):
    return So.SortExec([So.asc(col("x")), So.desc(col("y"))], _src(df, nb))


def _ref_sort(df, nb=8):
    return RSo.SortExec([RSo.asc(rcol("x")), RSo.desc(rcol("y"))],
                        _ref_src(df, nb))


def _sales(seed=3, n=4000, nkeys=600):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, nkeys, n).astype(np.int64),
        "v": rng.integers(-1000, 1000, n).astype(np.int64)})


def _agg_plan(df, nb=6):
    return A.HashAggregateExec(
        [col("k")], [Ag.Sum(col("v")).alias("s"),
                     Ag.Count(col("v")).alias("c")], _src(df, nb))


def _join_frames(seed=3, n=1000, m=200):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({
        "k": rng.integers(0, m, n).astype(np.int64),
        "v": rng.integers(-1000, 1000, n).astype(np.int64)})
    # duplicate build keys: the sort-merge core, which the grace lane
    # wraps, runs rather than the dense table
    right = pd.DataFrame({
        "rk": rng.integers(0, m // 2, m).astype(np.int64),
        "w": rng.integers(0, 100, m).astype(np.int64)})
    return left, right


def _join_plan(left, right, jt="INNER", nb=4):
    return J.HashJoinExec(getattr(J.JoinType, jt), [col("k")], [col("rk")],
                          _src(left, nb), _parts(right, 2))


def _ref_run(plan):
    RR.reset_oom_injection()
    with RC.session(RC.RapidsConf()):
        return plan.collect().to_pandas()


CHAOS_SCALE = 3000


@pytest.fixture(scope="module")
def ref():
    """The JAX package's unconstrained results, once per module."""
    out = {"sort": _ref_run(_ref_sort(_orders())),
           "sort2000": _ref_run(_ref_sort(_orders(n=2000))),
           "sort3000": _ref_run(_ref_sort(_orders(n=3000)))}
    out["agg"] = _ref_run(RA.HashAggregateExec(
        [rcol("k")], [RAg.Sum(rcol("v")).alias("s"),
                      RAg.Count(rcol("v")).alias("c")],
        _ref_src(_sales(), 6)))
    left, right = _join_frames()
    for jt in ("INNER", "FULL_OUTER"):
        out[jt] = _ref_run(RJ.HashJoinExec(
            getattr(RJ.JoinType, jt), [rcol("k")], [rcol("rk")],
            _ref_src(left, 4), RSource.from_pandas(right, num_partitions=2)))
    ref_tables = RD.gen_tables(np.random.default_rng(11), CHAOS_SCALE)
    with RC.session(RC.RapidsConf(dict(RB.BENCH_CONF))):
        out["q1"] = RB.run_query(1, ref_tables, engine="tpu")
    return out


# ---------------------------------------------------------------------------
# external merge sort
def test_external_sort_bit_exact_across_budget_ladder(tmp_path, ref):
    """Tightening the budget walks the sort from one external flush and
    merge to more hierarchical passes — bit-exact at every rung."""
    df = _orders()
    passes_at = {}
    # the reference's ladder is (2^17, 2^15); with the shadows counted,
    # 2^17 already takes the port's sort to the 2^15 rung's three
    # passes, so its top rung is 2^18 (two passes)
    for cap in (1 << 18, 1 << 15):
        with _Env(tmp_path, f"cap{cap}", cap=cap) as e:
            plan = _sort_plan(df)
            got = e.run(plan)
            _assert_bit_exact(ref["sort"], got, f"external sort @{cap}",
                              ordered=True)
            assert OC.runs_spilled() > 0
            assert _tree_metric(plan, M.SPILL_RUN_BYTES) == \
                OC.run_bytes_spilled()
            passes_at[cap] = _tree_metric(plan,
                                          M.NUM_EXTERNAL_MERGE_PASSES)
            assert passes_at[cap] >= 1, f"cap={cap}: no external merge"
            e.assert_clean()
    # a tighter window means smaller runs and more hierarchical passes
    assert passes_at[1 << 15] > passes_at[1 << 18], passes_at


def test_sort_stays_in_core_when_budget_fits(tmp_path, ref):
    """A budget with headroom does not degrade: the live try_reserve
    probe keeps the in-core lane even above the window heuristic."""
    with _Env(tmp_path, "fit", cap=1 << 24) as e:
        plan = _sort_plan(_orders(n=2000))
        got = e.run(plan)
        _assert_bit_exact(ref["sort2000"], got, "in-core sort",
                          ordered=True)
        assert OC.runs_spilled() == 0
        assert _tree_metric(plan, M.NUM_EXTERNAL_MERGE_PASSES) == 0
        e.assert_clean()


def test_external_sort_exhausted_passes_raise_descriptive(tmp_path):
    """Merge passes are bounded by oocore.maxRecursionDepth: past it, a
    TpuOutOfCoreError naming the knobs — and no run left behind."""
    with _Env(tmp_path, "exh", cap=1 << 15,
              **{C.OOCORE_MAX_RECURSION.key: 1}) as e:
        with pytest.raises(R.TpuOutOfCoreError,
                           match="maxRecursionDepth"):
            e.run(_sort_plan(_orders()))
        e.assert_clean()


# ---------------------------------------------------------------------------
# grace-hash join
@pytest.mark.parametrize("jt", ["INNER", "FULL_OUTER"])
def test_grace_join_bit_exact(tmp_path, ref, jt):
    """Build side over budget: both sides partition by (salted) key
    hash and each pair joins in-window — bit-exact, FULL_OUTER's
    unmatched rows included (partitions are key-disjoint)."""
    left, right = _join_frames()
    with _Env(tmp_path, "grace", cap=1 << 13) as e:
        plan = _join_plan(left, right, jt)
        got = e.run(plan)
        _assert_bit_exact(ref[jt], got, f"grace {jt} join")
        assert plan.lane == "grace-hash"
        assert _tree_metric(plan, M.NUM_GRACE_PARTITIONS) > 0
        assert OC.runs_spilled() > 0
        e.assert_clean()


def test_grace_join_recurses_on_oversized_partitions(tmp_path, ref):
    """Grace partitions that still overflow the window recurse with a
    fresh salt: the partition metric exceeds one level's fan-out and
    the result stays bit-exact.  The port cuts each slice to its tight
    capacity bucket (the reference keeps wider ones), so at the
    reference's cap an eight-way partition already fits the window:
    a two-way fan-out makes the first level overflow."""
    left, right = _join_frames()
    with _Env(tmp_path, "grrec", cap=1 << 13,
              **{C.OOCORE_GRACE_PARTITIONS.key: 2}) as e:
        plan = _join_plan(left, right)
        got = e.run(plan)
        _assert_bit_exact(ref["INNER"], got, "recursive grace join")
        nparts = int(e.conf[C.OOCORE_GRACE_PARTITIONS])
        assert _tree_metric(plan, M.NUM_GRACE_PARTITIONS) > nparts, \
            "join never recursed past the first partitioning level"
        e.assert_clean()


def test_grace_join_irreducible_skew_raises_descriptive(tmp_path):
    """One hot key bigger than the window cannot be partitioned down:
    at maxRecursionDepth the join fails naming the skew and the knobs,
    never hangs, never emits partial data, and frees its runs."""
    rng = np.random.default_rng(11)
    left = pd.DataFrame({"k": np.zeros(500, np.int64),
                         "v": rng.integers(0, 10, 500).astype(np.int64)})
    right = pd.DataFrame({"rk": np.zeros(2000, np.int64),
                          "w": rng.integers(0, 10, 2000).astype(np.int64)})
    with _Env(tmp_path, "skew", cap=1 << 13,
              **{C.OOCORE_MAX_RECURSION.key: 1}) as e:
        with pytest.raises(R.TpuOutOfCoreError, match="skew") as ei:
            e.run(_join_plan(left, right))
        assert "maxRecursionDepth" in str(ei.value)
        e.assert_clean()


# ---------------------------------------------------------------------------
# aggregate spill-and-re-merge
def test_agg_spill_bit_exact_across_budget_ladder(tmp_path, ref):
    """Partial aggregation state over budget spills as merged runs and
    re-merges in window-sized groups — bit-exact at any pass count."""
    df = _sales()
    for cap in (1 << 16, 1 << 15):
        with _Env(tmp_path, f"agg{cap}", cap=cap) as e:
            plan = _agg_plan(df)
            got = e.run(plan)
            _assert_bit_exact(ref["agg"], got, f"agg spill @cap={cap}")
            assert OC.runs_spilled() > 0
            assert _tree_metric(plan, M.NUM_EXTERNAL_MERGE_PASSES) >= 1
            assert _tree_metric(plan, M.SPILL_RUN_BYTES) == \
                OC.run_bytes_spilled()
            e.assert_clean()


def test_oocore_composes_with_oom_split_retry(tmp_path, ref):
    """The inner OOM split-retry lattice stays live inside the outer
    out-of-core ring: seeded OOMs during an external sort still
    converge bit-exact."""
    with _Env(tmp_path, "compose", cap=1 << 16,
              **{C.OOM_INJECT_RATE.key: 0.15, C.OOM_INJECT_SEED.key: 7,
                 C.RETRY_MIN_SPLIT_ROWS.key: 64}) as e:
        plan = _sort_plan(_orders(n=3000))
        got = e.run(plan)
        _assert_bit_exact(ref["sort3000"], got,
                          "external sort + injected OOMs", ordered=True)
        assert OC.runs_spilled() > 0
        assert R.injected_oom_count() > 0, \
            "injection never fired; the compose test is vacuous"
        e.assert_clean()


# ---------------------------------------------------------------------------
# spill-corruption recovery (runs forced down to disk)
def _disk_frame():
    rng = np.random.default_rng(17)
    return pd.DataFrame({
        "a": rng.integers(0, 1000, 2000).astype(np.int64),
        "b": rng.integers(-50, 50, 2000).astype(np.int64)})


def _disk_batch():
    df = _disk_frame()
    return batch_from_df(df, schema_of_df(df), "cpu")


def _corrupt_payload(path):
    with open(path, "r+b") as f:
        f.seek(ST._SPILL_FRAME_HEADER + 7)
        b = f.read(1)
        f.seek(ST._SPILL_FRAME_HEADER + 7)
        f.write(bytes([b[0] ^ 0xFF]))


def test_run_replica_recovers_corrupt_primary(tmp_path):
    """runReplicas=2: a corrupt primary is quarantined (its file kept
    for triage) and the replica satisfies the read."""
    with _Env(tmp_path, "rep", host_spill=1 << 10,
              **{C.OOCORE_RUN_REPLICAS.key: 2}) as e:
        batch = _disk_batch()
        run = OC.spill_run(batch, label="t", conf=e.conf)
        assert len(run.bids) == 2
        primary = e.env.disk_store._buffers[run.bids[0]]._path
        _corrupt_payload(primary)
        ms = M.MetricSet()
        got = run.read(ms)
        pd.testing.assert_frame_equal(batch.to_pandas(), got.to_pandas(),
                                      check_exact=True)
        assert _rows(got.to_pandas()) == _rows(_disk_frame())
        assert ms.value(M.NUM_SPILL_CORRUPTIONS_RECOVERED) == 1
        qpath = primary + ".quarantined"
        assert os.path.exists(qpath), "poisoned file not preserved"
        assert not e.env.catalog.is_registered(run.bids[0])
        run.free()
        e.assert_clean()
        e.env.close()  # teardown unlinks quarantined files too
        assert not os.path.exists(qpath)


def test_run_recompute_fallback_when_all_copies_corrupt(tmp_path):
    """No readable copy but a recompute lineage: the recompute satisfies
    the read instead of failing the query."""
    with _Env(tmp_path, "rec", host_spill=1 << 10) as e:
        batch = _disk_batch()
        run = OC.spill_run(batch, label="t", conf=e.conf,
                           recompute=lambda: batch)
        _corrupt_payload(e.env.disk_store._buffers[run.bids[0]]._path)
        ms = M.MetricSet()
        got = run.read(ms)
        pd.testing.assert_frame_equal(batch.to_pandas(), got.to_pandas(),
                                      check_exact=True)
        assert ms.value(M.NUM_SPILL_CORRUPTIONS_RECOVERED) == 1
        run.free()
        e.assert_clean()


def test_run_unreadable_raises_descriptive(tmp_path):
    """All copies corrupt, no lineage: a descriptive SpillCorruption
    naming the runReplicas knob — never a garbage batch."""
    with _Env(tmp_path, "bad", host_spill=1 << 10) as e:
        run = OC.spill_run(_disk_batch(), label="t", conf=e.conf)
        _corrupt_payload(e.env.disk_store._buffers[run.bids[0]]._path)
        with pytest.raises(ST.SpillCorruption, match="runReplicas"):
            run.read()
        run.free()


def test_query_recovers_from_injected_spill_corruption(tmp_path, ref):
    """Under faultInjection.spillCorruptRate an external sort whose runs
    land on disk re-reads through corrupt frames via replicas, stays
    bit-exact, and charges the recovery metric."""
    with _Env(tmp_path, "inj", cap=1 << 16, host_spill=1 << 12,
              **{C.SPILL_CORRUPT_RATE.key: 0.05,
                 C.OOM_INJECT_SEED.key: 7,
                 C.OOCORE_RUN_REPLICAS.key: 2}) as e:
        plan = _sort_plan(_orders(n=3000))
        got = e.run(plan)
        _assert_bit_exact(ref["sort3000"], got,
                          "external sort + spill corruption", ordered=True)
        assert ST.injected_spill_corruptions() > 0, \
            "corruption never fired; the recovery test is vacuous"
        assert _tree_metric(plan, M.NUM_SPILL_CORRUPTIONS_RECOVERED) > 0
        assert len(e.env.catalog) == 0
        assert e.env.disk_store.orphaned_spill_files() == []


# ---------------------------------------------------------------------------
# chaos composite: TPC-H through the planner under a tiny budget with
# the OOM and spill-corruption injectors lit at once
def test_chaos_composite_tpch(tmp_path, ref):
    """TPC-H Q1 under a budget a fraction of its working set, with
    seeded OOM injection and spill corruption (replicated runs land on
    disk through the tiny host arena), equals the JAX package's
    unconstrained uninjected result; nothing leaks."""
    tables = TD.gen_tables(np.random.default_rng(11), CHAOS_SCALE)
    keys = {**TB.BENCH_CONF,
            C.OOM_INJECT_RATE.key: 0.05, C.OOM_INJECT_SEED.key: 7,
            C.RETRY_MIN_SPLIT_ROWS.key: 64,
            C.SPILL_CORRUPT_RATE.key: 0.005,
            C.OOCORE_RUN_REPLICAS.key: 2}
    with _Env(tmp_path, "chaos", cap=1 << 14, host_spill=1 << 14,
              **keys) as e:
        got = TB.run_query(1, tables, device="cpu", conf=e.conf)
        want = ref["q1"]
        compare_frames(want, got, "chaos q1")
        for name in ("l_returnflag", "l_linestatus", "count_order"):
            assert got[name].tolist() == want[name].tolist(), name
        assert OC.runs_spilled() > 0, \
            "budget never forced the out-of-core lane; soak is vacuous"
        assert R.injected_oom_count() > 0
        e.assert_clean()
        assert TpuSemaphore.get().holders() == 0


# ---------------------------------------------------------------------------
# the watchdog over the out-of-core lane
def test_watchdog_covers_hung_merge_pass(tmp_path):
    """A hang injected inside an external merge pass is detected by the
    heartbeat watchdog and killed with a dump naming the site: the
    out-of-core lane may be slow, never silently stuck."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    W.reset_hang_injection()
    df = _orders()
    with _Env(tmp_path, "hang", cap=1 << 16,
              **{C.HANG_INJECT_SITE.key: "oocore-merge",
                 C.HANG_INJECT_AFTER.key: 0,
                 "spark.rapids.sql.watchdog.taskTimeout": 1.5,
                 "spark.rapids.sql.watchdog.pollInterval": 0.1}) as e:
        t0 = time.monotonic()
        with pytest.raises(W.TpuQueryTimeout) as ei:
            e.run(_sort_plan(df))
        assert time.monotonic() - t0 < 2 * 1.5 + 10.0
        msg = str(ei.value)
        assert "oocore-merge" in msg, msg[:400]
        assert "watchdog" in msg
        assert TpuSemaphore.get().holders() == 0
    W.reset_hang_injection()


def test_chaos_hang_times_out_then_reruns_clean(tmp_path, ref):
    """Chaos and a seeded hang: the watchdog kills the wedged query with
    a descriptive dump, and the SAME process then runs the query again
    under the rest of the injection, equal to the JAX package's result
    (keys and counts exact, sums within compare_frames' rtol 1e-5), with
    nothing left behind."""
    from spark_rapids_tpu_torch.exec import pipeline as PL
    from spark_rapids_tpu_torch.utils import watchdog as W
    tables = TD.gen_tables(np.random.default_rng(11), CHAOS_SCALE)
    keys = {**TB.BENCH_CONF,
            C.OOM_INJECT_RATE.key: 0.05, C.OOM_INJECT_SEED.key: 7,
            C.RETRY_MIN_SPLIT_ROWS.key: 64,
            C.SPILL_CORRUPT_RATE.key: 0.005,
            C.OOCORE_RUN_REPLICAS.key: 2}
    hang = {C.HANG_INJECT_SITE.key: "producer",
            C.HANG_INJECT_AFTER.key: 1,
            "spark.rapids.sql.watchdog.taskTimeout": 2.0,
            "spark.rapids.sql.watchdog.pollInterval": 0.1}
    leaked = PL.pipeline_stats()["leaked_producers"]
    # the port prefetches at the file scan alone: the hung query reads
    # lineitem from Parquet, so its scan's producer is the one that hangs
    root = write_tpch_files(tables, tmp_path / "files", names=["lineitem"])
    W.reset_hang_injection()
    with _Env(tmp_path, "hang-chaos", cap=1 << 14, host_spill=1 << 14,
              **keys, **hang) as e:
        with pytest.raises(W.TpuQueryTimeout) as ei:
            run_tpch_files(1, root, e.conf, names=["lineitem"])
        assert "producer" in str(ei.value)
    W.reset_hang_injection()
    with _Env(tmp_path, "hang-rerun", cap=1 << 14, host_spill=1 << 14,
              **keys) as e:
        got = TB.run_query(1, tables, device="cpu", conf=e.conf)
        want = ref["q1"]
        compare_frames(want, got, "q1 after the chaos hang timeout")
        for name in ("l_returnflag", "l_linestatus", "count_order"):
            assert got[name].tolist() == want[name].tolist(), name
        e.assert_clean()
        assert TpuSemaphore.get().holders() == 0
        assert PL.pipeline_stats()["leaked_producers"] == leaked


# ---------------------------------------------------------------------------
def test_disk_store_close_drains_orphans_and_quarantine(tmp_path):
    """close() unlinks quarantined and orphaned spill files file by
    file."""
    with _Env(tmp_path, "drain", host_spill=1 << 10) as e:
        ds = e.env.disk_store
        run = OC.spill_run(_disk_batch(), label="t", conf=e.conf)
        path = ds._buffers[run.bids[0]]._path
        qpath = ds.quarantine(run.bids[0])
        assert qpath == path + ".quarantined" and os.path.exists(qpath)
        stray = os.path.join(ds.block_manager.root, "stray.bin")
        with open(stray, "wb") as f:
            f.write(b"leftover")
        assert stray in ds.orphaned_spill_files()
        assert qpath not in ds.orphaned_spill_files()
        e.env.close()
        assert not os.path.exists(qpath)
        assert not os.path.exists(stray)
