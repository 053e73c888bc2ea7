"""spark_rapids_tpu_torch's ExpandExec, GenerateExec, the misc
expressions, RangeExec, UnionExec and the planner's CpuExpand,
CpuGenerate, CpuRange and CpuUnion against spark_rapids_tpu's: twins of
every test of tests/test_expand_misc.py, of test_basic_exec.py's
test_range_exec and test_union_exec, and of test_plan_overrides.py's
test_limit_union_range_parity, on the same inputs.

Every comparison is exact (integers, strings, nulls, and Rand's float64
draws bit for bit) except the rollup's float sums, which hold to
compare_frames' rtol 1e-5 as the reference's own test does."""
import math

import numpy as np
import pandas as pd
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec import basic as RB
from spark_rapids_tpu.exec.expand import ExpandExec as RExpand
from spark_rapids_tpu.exec.expand import GenerateExec as RGenerate
from spark_rapids_tpu.exprs import aggregates as RA
from spark_rapids_tpu.exprs import misc as RMX
from spark_rapids_tpu.exprs.base import Literal as RLiteral
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.expand import ExpandExec, GenerateExec
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs import misc as MX
from spark_rapids_tpu_torch.exprs.base import Literal, col
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.transitions import batch_from_df


def _src(df, parts=1):
    """The port's exec-level source of `df`, on the CPU."""
    bounds = np.linspace(0, len(df), parts + 1).astype(int)
    schema = schema_of_df(df)
    return B.LocalBatchSource(
        [[batch_from_df(df.iloc[bounds[i]:bounds[i + 1]].reset_index(
            drop=True), schema, "cpu")] for i in range(parts)],
        schema, device="cpu")


def _same(got: pd.DataFrame, want: pd.DataFrame):
    """Equal frames: values, order and nulls."""
    assert list(got.columns) == list(want.columns)
    for name in want.columns:
        g, w = got[name], want[name]
        assert g.isna().tolist() == w.isna().tolist(), name
        assert g[g.notna()].tolist() == w[w.notna()].tolist(), name


def test_expand_grouping_sets():
    df = pd.DataFrame({"a": np.array([1, 2], np.int64),
                       "b": np.array([10, 20], np.int64)})
    want = RExpand(
        [[rcol("a"), RLiteral(None, RT.INT64), rcol("b")],
         [RLiteral(None, RT.INT64), rcol("b"), rcol("b")]],
        ["a", "b", "v"], RB.LocalBatchSource.from_pandas(df)).to_pandas()
    got = ExpandExec(
        [[col("a"), Literal(None, T.INT64), col("b")],
         [Literal(None, T.INT64), col("b"), col("b")]],
        ["a", "b", "v"], _src(df)).to_pandas()
    _same(got, want)
    assert got["v"].tolist() == [10, 10, 20, 20]


def test_expand_string_char_caps():
    """Projections that put strings of different char capacities in one
    column stack at the widest."""
    df = pd.DataFrame({"s": np.array(["x" * 20, "y"], dtype=object),
                       "k": np.array([1, 2], np.int64)})
    want = RExpand([[rcol("s"), rcol("k")],
                    [RLiteral("short", RT.STRING), rcol("k")],
                    [RLiteral(None, RT.STRING), rcol("k")]],
                   ["s", "k"], RB.LocalBatchSource.from_pandas(df)
                   ).to_pandas()
    got = ExpandExec([[col("s"), col("k")],
                      [Literal("short", T.STRING), col("k")],
                      [Literal(None, T.STRING), col("k")]],
                     ["s", "k"], _src(df)).to_pandas()
    _same(got, want)
    assert got["s"].tolist()[:3] == ["x" * 20, "short", None]


def test_generate_explode():
    df = pd.DataFrame({"k": np.array([7, 8], np.int64),
                       "x": np.array([1, 2], np.int64),
                       "y": np.array([100, 200], np.int64)})
    want = RGenerate([rcol("x"), rcol("y")],
                     RB.LocalBatchSource.from_pandas(df), include_pos=True,
                     retained=["k"]).to_pandas()
    got = GenerateExec([col("x"), col("y")], _src(df), include_pos=True,
                       retained=["k"]).to_pandas()
    _same(got, want)
    assert got["col"].tolist() == [1, 100, 2, 200]


def test_monotonic_id_and_partition_id():
    df = pd.DataFrame({"x": np.arange(5, dtype=np.int64)})
    RMX.set_task_context(RMX.TaskContextInfo(partition_id=3,
                                             row_offset=10))
    MX.set_task_context(MX.TaskContextInfo(partition_id=3, row_offset=10))
    try:
        want = RB.ProjectExec(
            [RMX.MonotonicallyIncreasingID().alias("id"),
             RMX.SparkPartitionID().alias("pid")],
            RB.LocalBatchSource.from_pandas(df)).to_pandas()
        got = B.ProjectExec([MX.MonotonicallyIncreasingID().alias("id"),
                             MX.SparkPartitionID().alias("pid")],
                            _src(df)).to_pandas()
    finally:
        RMX.set_task_context(RMX.TaskContextInfo())
        MX.set_task_context(MX.TaskContextInfo())
    _same(got, want)
    assert got["id"].tolist() == [(3 << 33) + 10 + i for i in range(5)]


def test_rand_deterministic():
    """Rand draws the reference's threefry stream bit for bit, for two
    seeds, a partition id and a row offset."""
    df = pd.DataFrame({"x": np.arange(100, dtype=np.int64)})
    for seed, pid, off in ((42, 0, 0), (7, 5, 12345)):
        RMX.set_task_context(RMX.TaskContextInfo(partition_id=pid,
                                                 row_offset=off))
        MX.set_task_context(MX.TaskContextInfo(partition_id=pid,
                                               row_offset=off))
        try:
            want = RB.ProjectExec([RMX.Rand(seed).alias("r")],
                                  RB.LocalBatchSource.from_pandas(df)
                                  ).to_pandas()["r"].to_numpy()
            got = B.ProjectExec([MX.Rand(seed).alias("r")], _src(df)
                                ).to_pandas()["r"].to_numpy()
            again = B.ProjectExec([MX.Rand(seed).alias("r")], _src(df)
                                  ).to_pandas()["r"].to_numpy()
        finally:
            RMX.set_task_context(RMX.TaskContextInfo())
            MX.set_task_context(MX.TaskContextInfo())
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
        np.testing.assert_array_equal(got, again)
        assert ((got >= 0.0) & (got < 1.0)).all()
        assert len(set(got.tolist())) > 90


def test_normalize_nan_zero():
    x = np.array([-0.0, 0.0, np.nan, 1.5])
    want = RB.ProjectExec(
        [RMX.NormalizeNaNAndZero(rcol("x")).alias("n"),
         RMX.KnownNotNull(rcol("x")).alias("k")],
        RB.LocalBatchSource([[RBatch.from_numpy({"x": x})]])).to_pandas()
    got = B.ProjectExec(
        [MX.NormalizeNaNAndZero(col("x")).alias("n"),
         MX.KnownNotNull(col("x")).alias("k")],
        B.LocalBatchSource([[B.ColumnarBatch.from_numpy(
            {"x": x}, device="cpu")]], device="cpu")).to_pandas()
    g, w = got["n"].tolist(), want["n"].tolist()
    assert math.copysign(1, g[0]) == math.copysign(1, w[0]) == 1.0
    assert g[1] == w[1] == 0.0 and math.isnan(g[2]) and math.isnan(w[2])
    assert g[3] == w[3] == 1.5
    np.testing.assert_array_equal(got["k"].to_numpy(), x)


def _rollup(ns):
    """ROLLUP(a, b) as Spark lowers it: an expand with projections
    (a, b, 0), (a, null, 1), (null, null, 3), then an aggregate."""
    Tm, L, c = ns["T"], ns["Literal"], ns["col"]
    df = pd.DataFrame({
        "a": np.array([1, 1, 2, 2, 2], np.int64),
        "b": np.array([10, 20, 10, 10, 30], np.int64),
        "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    })
    expand = ns["N"].CpuExpand(
        [[c("a"), c("b"), L(0, Tm.INT32), c("v")],
         [c("a"), L(None, Tm.INT64), L(1, Tm.INT32), c("v")],
         [L(None, Tm.INT64), L(None, Tm.INT64), L(3, Tm.INT32), c("v")]],
        ["a", "b", "gid", "v"],
        ns["N"].CpuSource.from_pandas(df, num_partitions=2))
    return ns["N"].CpuAggregate([c("a"), c("b"), c("gid")],
                                [ns["A"].Sum(c("v")).alias("sv")], expand)


PORT = {"T": T, "Literal": Literal, "col": col, "N": N, "A": A}
REF = {"T": RT, "Literal": RLiteral, "col": rcol, "N": RN, "A": RA}


def _twin_plan(build, exec_name=None, on_gpu=True):
    """build(ns): the reference's CPU engine and accelerated plan, the
    port's CPU engine and accelerated plan, all equal."""
    want = build(REF).collect()
    ref_acc = RO.collect(RO.accelerate(build(REF), RC.RapidsConf()))
    got_cpu = build(PORT).collect()
    acc = O.accelerate(build(PORT), C.RapidsConf(), device="cpu")
    got = O.collect(acc)
    if on_gpu is not None:
        assert isinstance(acc, TpuExec) == on_gpu
    if exec_name is not None:
        found = []

        def walk(e):
            found.append(type(e).__name__)
            kids = list(getattr(e, "children", []))
            if hasattr(e, "tpu_child"):
                kids.append(e.tpu_child)
            for k in kids:
                walk(k)
        walk(acc)
        assert exec_name in found
    for name, frame in (("reference accelerated", ref_acc),
                        ("port CPU engine", got_cpu),
                        ("port accelerated", got)):
        compare_frames(want, frame, name)
    return got


def test_cpu_expand_rollup_through_accelerate():
    # the float Sum stays on the CPU engine without variableFloatAgg, in
    # both packages; the expand runs on the device
    got = _twin_plan(_rollup, "ExpandExec", on_gpu=None)
    assert len(got) == 7  # 4 (a, b) groups + 2 a groups + 1 total


def test_cpu_generate_posexplode_through_accelerate():
    df = pd.DataFrame({
        "k": np.array([1, 2, 3], np.int64),
        "x": np.array([1.5, 2.5, 3.5]),
        "y": np.array([10.0, 20.0, 30.0]),
    })
    got = _twin_plan(lambda ns: ns["N"].CpuGenerate(
        [ns["col"]("x"), ns["col"]("y")],
        ns["N"].CpuSource.from_pandas(df, num_partitions=1),
        include_pos=True, value_name="val", retained=["k"]),
        "GenerateExec")
    assert len(got) == 6


def test_cpu_expand_fallback_on_unsupported_expr():
    df = pd.DataFrame({"a": np.array([1, 2], np.int64)})

    def build(ns):
        class _Mystery(type(ns["col"]("a"))):  # an unregistered expression
            pass
        return ns["N"].CpuExpand(
            [[ns["col"]("a")], [_Mystery("a")]], ["a"],
            ns["N"].CpuSource.from_pandas(df, num_partitions=1))
    acc = O.accelerate(build(PORT), C.RapidsConf(), device="cpu")
    assert acc.name() == "CpuExpand"
    _twin_plan(build, on_gpu=False)


def test_range_exec():
    want = RB.RangeExec(0, 1000, 3, num_partitions=4, target_rows=100)
    plan = B.RangeExec(0, 1000, 3, num_partitions=4, target_rows=100,
                       device="cpu")
    got = plan.to_pandas()
    _same(got, want.to_pandas())
    assert got["id"].tolist() == list(range(0, 1000, 3))
    assert len(plan.execute_partitions()) == 4


def test_union_exec():
    a, b = (pd.DataFrame({"x": np.array([1, 2], np.int64)}),
            pd.DataFrame({"x": np.array([3], np.int64)}))
    want = RB.UnionExec(RB.LocalBatchSource.from_pandas(a),
                        RB.LocalBatchSource.from_pandas(b)).to_pandas()
    got = B.UnionExec(_src(a), _src(b)).to_pandas()
    _same(got, want)
    assert got["x"].tolist() == [1, 2, 3]


def test_coalesce_partitions_exec():
    plan = B.CoalescePartitionsExec(
        2, B.RangeExec(0, 40, 1, num_partitions=5, target_rows=3,
                       device="cpu"))
    assert plan.output_partition_count() == 2
    assert sorted(plan.to_pandas()["id"].tolist()) == list(range(40))


def test_limit_union_range_parity():
    def build(ns):
        Nm = ns["N"]
        return Nm.CpuLimit(10, Nm.CpuUnion(
            Nm.CpuRange(0, 100, 1, num_partitions=4),
            Nm.CpuRange(100, 120, 1)))
    ref = RO.collect(RO.accelerate(build(REF), RC.RapidsConf()))
    acc = O.accelerate(build(PORT), C.RapidsConf(), device="cpu")
    got = O.collect(acc)
    assert isinstance(acc, TpuExec)
    assert len(got) == len(ref) == 10
    cpu = build(PORT).collect()
    assert len(cpu) == 10
    assert cpu["id"].tolist() == list(range(10))
