"""spark_rapids_tpu_torch's WindowExec and CpuWindow against
spark_rapids_tpu's, one twin per test of tests/test_window.py, on the
same inputs made from a seed.

Tolerances: integer results, ranks, row numbers, counts, strings and
nulls exact; a float window sum (one float64 cumsum over the batch,
read at the frame's ends) within n * eps * sum|x| over its batch, since
torch's scan adds in another order than XLA's; averages of integers
exact (an exact int64 sum over an int64 count)."""
import numpy as np
import pandas as pd

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exec import window as RW
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exec.sort import asc as rasc
from spark_rapids_tpu.exec.sort import desc as rdesc
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import window as W
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.transitions import batch_from_df

EPS = np.finfo(np.float64).eps


class _Ns:
    """One package's names, so a test builds the same plan in both."""

    def __init__(self, port: bool):
        self.port = port
        self.W = W if port else RW
        self.col = col if port else rcol
        self.asc = asc if port else rasc
        self.desc = desc if port else rdesc
        self.N = N if port else RN

    def exec_source(self, df):
        if self.port:
            return LocalBatchSource(
                [[batch_from_df(df, schema_of_df(df), "cpu")]],
                device="cpu")
        return RSource.from_pandas(df)

    def accelerate_collect(self, plan):
        if self.port:
            conf = C.RapidsConf()
            acc = O.accelerate(plan, conf, device="cpu")
            return acc, O.collect(acc, conf)
        conf = RC.RapidsConf()
        acc = RO.accelerate(plan, conf)
        return acc, RO.collect(acc, conf)


PORT, REF = _Ns(True), _Ns(False)


def _assert_same(got: pd.DataFrame, want: pd.DataFrame, sum_tol=None):
    """Frames equal column by column: exact, except the float columns
    named in `sum_tol`, each within its stated absolute bound."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        g, w = got[name], want[name]
        gn = g.isna().to_numpy()
        np.testing.assert_array_equal(gn, w.isna().to_numpy(), err_msg=name)
        gv, wv = g[~gn].tolist(), w[~gn].tolist()
        if sum_tol and name in sum_tol:
            np.testing.assert_allclose(np.asarray(gv, float),
                                       np.asarray(wv, float), rtol=0,
                                       atol=sum_tol[name], err_msg=name)
        else:
            assert gv == wv, name


def _sum_bound(values) -> float:
    """n * eps * sum|x| over one batch: how far two summation orders of
    a float64 prefix sum may drift apart."""
    v = np.abs(np.asarray(values, float))
    return len(v) * EPS * float(v.sum())


def _df(rng, n=100):
    return pd.DataFrame({
        "g": rng.choice(["a", "b", "c"], n).astype(object),
        "o": rng.permutation(n).astype(np.int64),
        "v": rng.integers(-50, 50, n).astype(np.int64),
    })


def _run_exec(ns, df, fns, spec_args):
    parts, order, frame = spec_args(ns)
    spec = ns.W.WindowSpec(parts, order, frame)
    return ns.W.WindowExec(fns(ns), spec, ns.exec_source(df)).to_pandas()


def _twin_exec(df, fns, spec_args, sum_tol=None):
    want = _run_exec(REF, df, fns, spec_args)
    got = _run_exec(PORT, df, fns, spec_args)
    _assert_same(got, want, sum_tol)
    return got


def _by_g(frame=None, desc_order=False):
    def spec(ns):
        o = ns.desc(ns.col("o")) if desc_order else ns.asc(ns.col("o"))
        return ([ns.col("g")], [o],
                frame(ns) if frame else ns.W.WindowFrame())
    return spec


def test_row_number_rank(rng):
    got = _twin_exec(_df(rng), lambda ns: [
        ns.W.RowNumber().alias("rn"), ns.W.Rank().alias("rk"),
        ns.W.DenseRank().alias("drk")], _by_g())
    assert sorted(got["rn"].tolist())[-1] >= 25


def test_rank_with_ties():
    df = pd.DataFrame({"g": np.array(["x"] * 6, dtype=object),
                       "o": np.array([10, 10, 20, 20, 20, 30], np.int64)})
    got = _twin_exec(df, lambda ns: [ns.W.Rank().alias("rk"),
                                     ns.W.DenseRank().alias("drk")],
                     lambda ns: ([ns.col("g")], [ns.asc(ns.col("o"))],
                                 ns.W.WindowFrame()))
    assert got["rk"].tolist() == [1, 1, 3, 3, 3, 6]
    assert got["drk"].tolist() == [1, 1, 2, 2, 2, 3]


def test_running_sum(rng):
    _twin_exec(_df(rng), lambda ns: [ns.W.WinSum(ns.col("v")).alias("rs")],
               _by_g())


def test_whole_partition_agg(rng):
    frame = _by_g(lambda ns: ns.W.WindowFrame(is_rows=True, lower=None,
                                              upper=None))
    _twin_exec(_df(rng), lambda ns: [
        ns.W.WinSum(ns.col("v")).alias("t"),
        ns.W.WinAvg(ns.col("v")).alias("a"),
        ns.W.WinCount(ns.col("v")).alias("c")], frame)


def test_sliding_rows_frame(rng):
    frame = _by_g(lambda ns: ns.W.WindowFrame(is_rows=True, lower=-2,
                                              upper=0))
    _twin_exec(_df(rng), lambda ns: [
        ns.W.WinSum(ns.col("v")).alias("s3"),
        ns.W.WinMin(ns.col("v")).alias("mn"),
        ns.W.WinMax(ns.col("v")).alias("mx")], frame)


def test_lead_lag(rng):
    _twin_exec(_df(rng), lambda ns: [ns.W.Lead(ns.col("v")).alias("ld"),
                                     ns.W.Lag(ns.col("v"), 2).alias("lg")],
               _by_g())


def test_range_frame():
    df = pd.DataFrame({"g": np.array(["x"] * 5, dtype=object),
                       "o": np.array([0, 5, 12, 13, 30], np.int64),
                       "v": np.array([1, 2, 4, 8, 16], np.int64)})
    frame = _by_g(lambda ns: ns.W.WindowFrame(is_rows=False, lower=-10,
                                              upper=0))
    got = _twin_exec(df, lambda ns: [ns.W.WinSum(ns.col("v")).alias("s")],
                     frame)
    assert got["s"].tolist() == [1, 3, 6, 14, 16]
    # bounds at the int64 ends saturate instead of wrapping
    df2 = df.assign(o=np.array([-2**63 + 1, -5, 0, 7, 2**63 - 2],
                               np.int64))
    wide = _by_g(lambda ns: ns.W.WindowFrame(is_rows=False, lower=-10,
                                             upper=2**62))
    got2 = _run_exec(PORT, df2, lambda ns: [
        ns.W.WinSum(ns.col("v")).alias("s")], wide)
    assert got2["s"].tolist() == [1, 14, 14, 12, 16]


def test_window_null_values():
    df = pd.DataFrame({"g": np.array(["x"] * 4, dtype=object),
                       "o": pd.array([1, 2, 3, 4], dtype="Int64"),
                       "v": pd.array([10, None, 30, None], dtype="Int64")})
    got = _twin_exec(df, lambda ns: [ns.W.WinSum(ns.col("v")).alias("s"),
                                     ns.W.WinCount(ns.col("v")).alias("c")],
                     _by_g())
    assert got["s"].tolist() == [10, 10, 40, 40]
    assert got["c"].tolist() == [1, 1, 2, 2]


# -- the planner's window node (CpuWindow -> WindowExec) ----------------------
def _wdf():
    return pd.DataFrame({
        "g": pd.array([1, 1, 2, 2, 2, 1, 3], dtype="Int64"),
        "o": pd.array([3, 1, 5, 5, 2, 2, 9], dtype="Int64"),
        "v": pd.array([10.0, 20.0, 30.0, None, 50.0, 60.0, 70.0],
                      dtype="Float64"),
    })


def _norm(df, sort_by):
    df = df.sort_values(list(sort_by), ignore_index=True)
    for name in df.columns:
        if df[name].dtype == object:
            df[name] = df[name].where(df[name].notna(), None)
    return df


def _plan_twin(build, sort_by=("g", "o"), on_gpu=True, sum_tol=None):
    """build(ns) -> a CpuWindow plan; the port's CPU engine and its
    accelerated plan against the reference's CPU engine and its
    accelerated plan."""
    want_cpu = _norm(build(REF).collect(), sort_by)
    acc_ref, want_acc = REF.accelerate_collect(build(REF))
    plan = build(PORT)
    got_cpu = _norm(plan.collect(), sort_by)
    acc, got_acc = PORT.accelerate_collect(build(PORT))
    assert isinstance(acc, TpuExec) == on_gpu
    assert isinstance(acc_ref, RN.CpuNode) != on_gpu
    _assert_same(got_cpu, want_cpu, sum_tol)
    _assert_same(_norm(got_acc, sort_by), _norm(want_acc, sort_by), sum_tol)
    _assert_same(_norm(got_acc, sort_by), got_cpu, sum_tol)
    return got_cpu


def test_cpu_window_node_rank_parity():
    _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.RowNumber().alias("rn"), ns.W.Rank().alias("rk"),
         ns.W.DenseRank().alias("drk")],
        ns.W.WindowSpec([ns.col("g")], [ns.asc(ns.col("o"))]),
        ns.N.CpuSource.from_pandas(_wdf(), num_partitions=2)))


def test_cpu_window_node_running_and_partition_aggs():
    tol = {"rs": _sum_bound(_wdf()["v"].dropna()),
           "pa": _sum_bound(_wdf()["v"].dropna())}
    # running, RANGE semantics: CURRENT ROW includes its peers
    _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.WinSum(ns.col("v")).alias("rs"),
         ns.W.WinCount(ns.col("v")).alias("rc")],
        ns.W.WindowSpec([ns.col("g")], [ns.asc(ns.col("o"))],
                        ns.W.WindowFrame(is_rows=False)),
        ns.N.CpuSource.from_pandas(_wdf())), sum_tol=tol)
    # whole partition
    _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.WinAvg(ns.col("v")).alias("pa")],
        ns.W.WindowSpec([ns.col("g")], [],
                        ns.W.WindowFrame(is_rows=True, lower=None,
                                         upper=None)),
        ns.N.CpuSource.from_pandas(_wdf())), sort_by=("g", "o", "v"),
        sum_tol=tol)


def test_cpu_window_node_lead_lag_and_rows_frame():
    _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.Lead(ns.col("v")).alias("nxt"),
         ns.W.Lag(ns.col("v"), 1).alias("prv"),
         ns.W.WinMax(ns.col("v")).alias("m3")],
        ns.W.WindowSpec([ns.col("g")], [ns.asc(ns.col("o"))],
                        ns.W.WindowFrame(is_rows=True, lower=-1, upper=1)),
        ns.N.CpuSource.from_pandas(_wdf(), num_partitions=2)))


def test_cpu_window_unsupported_shapes_fall_back():
    df = pd.DataFrame({
        "g": pd.array([1, 1, 2], dtype="Int64"),
        "s": pd.array(["b", "a", "c"], dtype=object),
        "v": pd.array([1.0, 2.0, 3.0], dtype="Float64")})
    # a range frame without an order key
    _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.WinSum(ns.col("v")).alias("x")],
        ns.W.WindowSpec([ns.col("g")], [],
                        ns.W.WindowFrame(is_rows=False)),
        ns.N.CpuSource.from_pandas(df)), sort_by=("g", "v"), on_gpu=False)
    # string max
    got = _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.WinMax(ns.col("s")).alias("mx")],
        ns.W.WindowSpec([ns.col("g")], [],
                        ns.W.WindowFrame(is_rows=True, lower=None,
                                         upper=None)),
        ns.N.CpuSource.from_pandas(df)), sort_by=("g", "s"), on_gpu=False)
    assert sorted(got["mx"].tolist()) == ["b", "b", "c"]


def test_cpu_window_desc_string_order_and_null_first_value():
    df = pd.DataFrame({
        "g": pd.array([1, 1, 1], dtype="Int64"),
        "s": pd.array(["a", "ab", "b"], dtype=object),
        "v": pd.array([None, 5.0, 7.0], dtype="Float64")})
    got = _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.RowNumber().alias("rn")],
        ns.W.WindowSpec([ns.col("g")], [ns.desc(ns.col("s"))]),
        ns.N.CpuSource.from_pandas(df)), sort_by=("s",))
    assert got["rn"].tolist() == [3, 2, 1]  # desc: b, ab, a
    got2 = _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.WindowFunction("first", ns.col("v")).alias("fv")],
        ns.W.WindowSpec([ns.col("g")], [],
                        ns.W.WindowFrame(is_rows=True, lower=None,
                                         upper=None)),
        ns.N.CpuSource.from_pandas(df)), sort_by=("s",))
    assert got2["fv"].isna().sum() == 3


def test_cpu_window_null_order_keys_match_tpu():
    df = pd.DataFrame({
        "g": pd.array([1, 1, 1], dtype="Int64"),
        "o": pd.array([None, -5, 5], dtype="Int64"),
        "s": pd.array([None, "b", "a"], dtype=object)})
    got = _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.RowNumber().alias("rn")],
        ns.W.WindowSpec([ns.col("g")], [ns.asc(ns.col("o"))]),
        ns.N.CpuSource.from_pandas(df)), sort_by=("o",))
    assert got[got["o"].isna()]["rn"].iloc[0] == 1  # nulls first
    got2 = _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.RowNumber().alias("rn")],
        ns.W.WindowSpec([ns.col("g")], [ns.asc(ns.col("s"))]),
        ns.N.CpuSource.from_pandas(df)), sort_by=("o",))
    assert got2[got2["s"].isna()]["rn"].iloc[0] == 1


def test_float_range_frame_falls_back():
    df = pd.DataFrame({
        "g": pd.array([1, 1, 1], dtype="Int64"),
        "o": pd.array([1.2, 1.9, 3.0], dtype="Float64"),
        "v": pd.array([10.0, 20.0, 40.0], dtype="Float64")})
    got = _plan_twin(lambda ns: ns.W.CpuWindow(
        [ns.W.WinSum(ns.col("v")).alias("rs")],
        ns.W.WindowSpec([ns.col("g")], [ns.asc(ns.col("o"))],
                        ns.W.WindowFrame(is_rows=False)),
        ns.N.CpuSource.from_pandas(df)), sort_by=("o",), on_gpu=False)
    assert got["rs"].tolist() == [10.0, 30.0, 70.0]


def test_window_wide_string_partitions_hash_lane(rng):
    """Five PARTITION BY keys with strings take the murmur3 hash lane in
    both packages; the order within each partition is exact."""
    n = 300
    df = pd.DataFrame({
        "city": rng.choice(["springfield", "shelbyville", "ogdenville"],
                           n).astype(object),
        "street": rng.choice(["elm st", "oak ave"], n).astype(object),
        "zip": rng.choice(["12345", "67890"], n).astype(object),
        "yr": rng.integers(1999, 2002, n).astype(np.int64),
        "sku": rng.integers(0, 4, n).astype(np.int64),
        "v": rng.uniform(0, 10, n),
        "ts": rng.permutation(np.arange(n)).astype(np.int64),
    })
    keys = ["city", "street", "zip", "yr", "sku"]
    plans = {}

    def spec(ns):
        return ([ns.col(k) for k in keys], [ns.asc(ns.col("ts"))],
                ns.W.WindowFrame(is_rows=True, lower=None, upper=0))

    for ns in (REF, PORT):
        parts, order, frame = spec(ns)
        plans[ns.port] = ns.W.WindowExec(
            [ns.W.RowNumber().alias("rn"), ns.W.WinSum(ns.col("v")).alias(
                "s")], ns.W.WindowSpec(parts, order, frame),
            ns.exec_source(df))
    port = plans[True]
    batch = batch_from_df(df, schema_of_df(df), "cpu")
    assert port._use_hash_partitions(batch)
    got, want = port.to_pandas(), plans[False].to_pandas()
    _assert_same(got, want, sum_tol={"s": _sum_bound(df["v"])})
    assert not port._hash_parts_disabled
