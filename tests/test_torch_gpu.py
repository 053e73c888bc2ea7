"""spark_rapids_tpu_torch's CUDA kernels against their plain PyTorch twins
on an NVIDIA card.  Skips without one (a CUDA kernel has no CPU mode).

This file imports neither JAX nor spark_rapids_tpu, so it also runs on a
GPU machine without them:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.models.tpch import (LINEITEM_SCHEMA,
                                                Q1_CUTOFF_DAYS,
                                                gen_lineitem_arrays)
from spark_rapids_tpu_torch.ops import grouped_window as GW
from spark_rapids_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain(cuda_device):
    """Each CUDA kernel against its plain twin on the card (counts exact,
    f32 sums rtol 1e-5 over these small shapes)."""
    dev = cuda_device
    cols = gen_lineitem_arrays(np.random.default_rng(6), 1 << 16)
    # NaN in a padding row (batch 1 holds 100 rows) and in a filtered row
    # must reach no sum
    cols["l_quantity"][(1 << 14) + 200] = np.nan
    cut = np.flatnonzero(cols["l_shipdate"][:1 << 14] > Q1_CUTOFF_DAYS)[0]
    cols["l_extendedprice"][cut] = np.nan
    arrays = [torch.from_numpy(cols[n]).to(dev)
              for n in LINEITEM_SCHEMA.names]
    nums = torch.tensor([1 << 14, 100, 0, 5000], dtype=torch.int32,
                        device=dev)
    before = K.q1_fused.launches
    got = K.q1_fused(*arrays, nums, capacity=1 << 16, cutoff=Q1_CUTOFF_DAYS,
                     batch_rows=1 << 14)
    want = K.q1_fused_plain(*arrays, nums, capacity=1 << 16,
                            cutoff=Q1_CUTOFF_DAYS, batch_rows=1 << 14)
    assert K.q1_fused.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, 5], want[:, 5], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)

    torch.cuda.synchronize()


def _plain_rows(n, dev):
    return torch.full((1,), n, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups,n_measures,tier", [
    (26, 14, "A"),     # Q1's dictionary-lane table
    (37, 3, "A"),
    (300, 14, "B"),    # a table per warp
    (3000, 14, "B"),   # one table per block, shared-memory atomics
    (40000, 3, "C"),   # past shared memory: global vector atomics
    (5, 70, "A"),      # two launches (64 + 6 measures)
])
@pytest.mark.parametrize("aligned", [True, False])
def test_grouped_sum_tiers_match_plain(cuda_device, n_groups, n_measures,
                                       tier, aligned):
    """Each tier against the plain twin (counts exact, f32 sums rtol
    1e-5), with out-of-range keys, a row count that is no multiple of 8,
    and columns that are not 16-byte aligned; tiers A and B with a table
    per warp give the same bits twice."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(n_groups + n_measures)
    n, nrows = 1 << 16, (1 << 16) - 9
    lead = 0 if aligned else 1
    keys = torch.randint(-2, n_groups + 3, (n + lead,), generator=gen,
                         device=dev, dtype=torch.int32)[lead:]
    vals = [torch.rand(n + lead, generator=gen, device=dev)[lead:]
            for _ in range(n_measures)]
    s, c = K.grouped_sum(keys, vals, nrows, n_groups=n_groups, capacity=n)
    assert K.grouped_sum.last_tiers[0] == tier
    ws, wc = K.grouped_sum_plain(keys, vals, _plain_rows(nrows, dev),
                                 n_groups=n_groups, capacity=n)
    torch.testing.assert_close(c, wc, rtol=0, atol=0)
    torch.testing.assert_close(s, ws, rtol=1e-5, atol=1e-9)
    deterministic = tier == "A" or (tier == "B" and n_groups == 300)
    if deterministic:
        s2, c2 = K.grouped_sum(keys, vals, nrows, n_groups=n_groups,
                               capacity=n)
        assert torch.equal(s, s2) and torch.equal(c, c2)
    torch.cuda.synchronize()


def _window_case(name, dev):
    """(gid, out_cap) of one edge case of window_group_sums."""
    gen = torch.Generator(device=dev).manual_seed(11)
    n = 1 << 16
    if name == "random":        # leading -1 ids, gaps, ids past out_cap
        gid = torch.sort(torch.randint(-1, 5000, (n,), generator=gen,
                                       device=dev))[0]
        return gid.to(torch.int32), 4000
    if name == "one_run":       # a single run over every row and tile
        return torch.full((n,), 7, dtype=torch.int32, device=dev), 100
    if name == "empty_batch":   # every row numbered -1
        return torch.full((n,), -1, dtype=torch.int32, device=dev), 50
    if name == "big_gaps":      # wide gaps, runs crossing tiles
        gid = torch.arange(n, device=dev) // 3000 * 1000 + 3
        return gid.to(torch.int32), 30000
    if name == "q1_merge":      # 48 live rows, the last id repeated
        gid = torch.clamp(torch.arange(1 << 14, device=dev) // 8, max=5)
        return gid.to(torch.int32), 1 << 14
    # ragged: a capacity that fills no whole tile or quad
    gid = torch.sort(torch.randint(0, 300, (n - 1001,), generator=gen,
                                   device=dev))[0]
    return gid.to(torch.int32), 256


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["random", "one_run", "empty_batch",
                                  "big_gaps", "q1_merge", "ragged"])
@pytest.mark.parametrize("n_measures", [17, 70])
def test_window_group_sums_match_plain(cuda_device, name, n_measures):
    """The kernel against the plain twin over float64 copies of the
    measures, cast to f32 at the end, so the oracle does not depend on
    the order its atomic adds land in (f32 sums rtol 1e-5; absent ids
    exactly 0, though the output is not zero-filled first), and the same
    bits on a second call."""
    dev = cuda_device
    gid, out_cap = _window_case(name, dev)
    gen = torch.Generator(device=dev).manual_seed(n_measures)
    vals = [torch.rand(gid.numel(), generator=gen, device=dev)
            for _ in range(n_measures)]
    # dirty the allocator's free blocks, so unwritten cells would show
    torch.full((out_cap * n_measures * 2,), float("nan"), device=dev)
    got = GW.window_group_sums(gid, vals, out_cap=out_cap,
                               capacity=gid.numel())
    want = GW.window_group_sums_plain(gid, [v.double() for v in vals],
                                      out_cap=out_cap).float()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got == 0, want == 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = GW.window_group_sums(gid, vals, out_cap=out_cap,
                                 capacity=gid.numel())
    assert torch.equal(got, again)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("query", range(1, 23))
def test_planner_queries_match_the_cpu_engine(cuda_device, query):
    """All 22 TPC-H queries through accelerate + collect on the card,
    wholly there (spark.rapids.sql.test.enabled; Q21's two semi/anti
    joins with a residual condition are CPU islands, as in the
    reference), against the CPU engine (keys and counts exact, floats
    rtol 1e-5); planner Q1 launches window_group_sums."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    tables = TD.gen_tables(np.random.default_rng(11), 20_000)
    islands = {C.TEST_ALLOWED_NONGPU.key: "CpuHashJoin"} if query == 21 \
        else {}
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                         **islands})
    before = GW.window_group_sums.launches
    got = TB.run_query(query, tables, device=cuda_device, conf=conf)
    launched = GW.window_group_sums.launches - before
    want = QUERIES[query](TD.sources(tables, 2),
                          lambda plan: plan.collect()).collect()
    compare_frames(want, got, f"q{query} on the card")
    if query == 1:
        assert launched >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("query", ["q9", "q72", "q95"])
def test_tpcds_queries_match_the_cpu_engine(cuda_device, query):
    """Three TPC-DS queries of the 85 at the reference fixture's 20,000
    store_sales rows (seed 3) through accelerate + collect on the card,
    wholly there (spark.rapids.sql.test.enabled), against the CPU engine
    (keys and counts exact, floats rtol 1e-3: the banded lane adds in
    f32): q9, whose five scalar subqueries each collect on the card
    through `run`; q72, which joins catalog_sales with inventory on the
    item alone (8.5M pairs); q95, web_sales' self-join on the order."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    from spark_rapids_tpu_torch.models import tpcds_data as DD
    from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    tables = DD.gen_tables(np.random.default_rng(3), 20_000)
    conf = C.RapidsConf({**DB.BENCH_CONF, C.TEST_ENABLED.key: True})
    collects = []

    def run(plan):
        collects.append(plan)
        return collect(accelerate(plan, conf, cuda_device), conf)
    got = run(QUERIES[query](DD.sources(tables, 2), run))
    want = QUERIES[query](DD.sources(tables, 2),
                          lambda plan: plan.collect()).collect()
    assert len(want) > 0
    compare_frames(want, got, f"{query} on the card", rtol=1e-3)
    assert len(collects) == (6 if query == "q9" else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("join_type", ["INNER", "LEFT_OUTER", "RIGHT_OUTER",
                                       "FULL_OUTER", "LEFT_SEMI",
                                       "LEFT_ANTI"])
@pytest.mark.parametrize("unique", [True, False])
def test_join_lanes_match_the_cpu(cuda_device, join_type, unique):
    """HashJoinExec on the card against the same join on the CPU, row for
    row: unique build keys at capacity 1024 take the dense lane (but
    FULL_OUTER), duplicates the sort-merge lane."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exprs.base import col
    rng = np.random.default_rng(4)
    probe = {"k": rng.integers(0, 1200, 5000).astype(np.int64),
             "v": rng.uniform(0, 1, 5000)}
    keys = (rng.permutation(1000) if unique
            else rng.integers(0, 1000, 1000)).astype(np.int64)
    build = {"r": keys, "w": rng.integers(0, 9, 1000).astype(np.int32)}
    pvalid = {"k": rng.random(5000) > 0.05}
    jt = J.JoinType[join_type]
    left, right = (build, probe) if jt == J.JoinType.RIGHT_OUTER \
        else (probe, build)
    lkey, rkey = ("r", "k") if jt == J.JoinType.RIGHT_OUTER else ("k", "r")

    def run(dev):
        def src(d):
            return LocalBatchSource([[ColumnarBatch.from_numpy(
                d, validity=pvalid if d is probe else None,
                capacity=1024 if d is build else None, device=dev)]],
                device=dev)
        plan = J.HashJoinExec(jt, [col(lkey)], [col(rkey)], src(left),
                              src(right))
        return plan.collect().to_pandas(), plan.lane
    got, lane = run(cuda_device)
    want, cpu_lane = run("cpu")
    dense = unique and jt != J.JoinType.FULL_OUTER
    assert lane == cpu_lane == ("dense" if dense else "sort-merge")
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for name in want.columns:
        assert got[name].isna().equals(want[name].isna())
        np.testing.assert_array_equal(got[name].dropna().to_numpy(float),
                                      want[name].dropna().to_numpy(float))


def _expression_inputs(n=4096):
    """Dates (1900-2100, leap days, before 1970), doubles with zeros,
    UTF-8 strings of several widths, a tenth of each null."""
    import pandas as pd
    rng = np.random.default_rng(8)
    pool = np.array(["", "green", "dark green ivory", "café", "日本語",
                     "a_c", "50%", "x" * 40, "forest green", "\\"],
                    dtype=object)
    s = pool[rng.integers(0, len(pool), n)]
    s[rng.random(n) < 0.1] = None
    days = pd.Series(rng.integers(-25_567, 47_482, n)).astype("Int32")
    # 1900-03-01, 2000-02-29, 2100-02-28 and 1969-12-31
    days[: 4] = [-25_508, 11_016, 47_540, -1]
    days[rng.random(n) < 0.1] = pd.NA
    y = rng.integers(-3, 4, n).astype(float)
    return pd.DataFrame({
        "d": days,
        "x": pd.Series(rng.uniform(-1e3, 1e3, n)).astype("Float64"),
        "y": pd.Series(y).astype("Float64"),
        "s": s})


_EXPRESSIONS = {
    "year": lambda E, M: M["Year"](E.col("d")),
    "case_when": lambda E, M: M["CaseWhen"](
        ((E.col("s") == E.lit("green"), E.col("x")),), E.lit(0.0)),
    "case_when_strings": lambda E, M: M["CaseWhen"](
        ((E.col("x") > E.lit(0.0), E.col("s")),)),
    "divide": lambda E, M: E.col("x") / E.col("y"),
    "contains": lambda E, M: M["Contains"](E.col("s"), E.lit("green")),
    "like": lambda E, M: M["Like"](E.col("s"), E.lit("%gr_en%")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_EXPRESSIONS))
def test_expressions_match_on_the_card(cuda_device, name):
    """Year, CaseWhen, Divide, Contains and Like on CUDA tensors against
    the same expressions on CPU tensors: values, strings and nulls
    exact."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.base import make_eval_context
    from spark_rapids_tpu_torch.exprs import base as E
    from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
    from spark_rapids_tpu_torch.exprs.datetime_exprs import Year
    from spark_rapids_tpu_torch.exprs.string_fns import Contains, Like
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    M = {"Year": Year, "CaseWhen": CaseWhen, "Contains": Contains,
         "Like": Like}
    df = _expression_inputs()
    schema = T.Schema.of(("d", T.DATE32), ("x", T.FLOAT64),
                         ("y", T.FLOAT64), ("s", T.STRING))
    expr = _EXPRESSIONS[name](E, M).bind(schema)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch_from_df(df, schema, device=dev)
        ctx = make_eval_context(b.columns, b.capacity,
                                torch.tensor(len(df), dtype=torch.int32,
                                             device=dev))
        out.append(expr.eval(ctx).to_numpy(len(df)))
    (gv, gok), (wv, wok) = out
    np.testing.assert_array_equal(gok, wok)
    assert list(gv[wok]) == list(wv[wok])
    torch.cuda.synchronize()


def _slice7_inputs(n=4096):
    """Timestamps on both sides of the epoch, dates, doubles across the
    exponent range (with +-0, subnormals, NaN, +-Infinity), int64s,
    shift distances past the width, and strings (numbers, dates,
    timestamps, phones, padding, multi-byte), a tenth of each null."""
    import pandas as pd
    rng = np.random.default_rng(9)
    day = 86_400_000_000

    def nulls(values, dtype):
        s = pd.Series(values).astype(dtype)
        s[rng.random(n) < 0.1] = pd.NA
        return s
    bits = rng.integers(0, 2 ** 63, n, dtype=np.int64).view(np.float64)
    f = np.where(rng.random(n) < 0.5, rng.normal(0, 1e4, n), bits)
    f[:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, 0.1, 1e7]
    pool = np.array(["12", " -7 ", "9223372036854775808", "1.5e3", "abc",
                     "2020-02-29", "2021-02-29 10:00:00", "1999-12-31 "
                     "23:59:59.5", "25-989-741-2988", "Customer#000000042",
                     "  hi  ", "café", "日本", "t", "NaN", "-Infinity", ""],
                    dtype=object)
    s = pool[rng.integers(0, len(pool), n)]
    s[rng.random(n) < 0.1] = None
    return pd.DataFrame({
        "ts": nulls(rng.integers(-40 * 365 * day, 60 * 365 * day, n),
                    "Int64"),
        "d": nulls(rng.integers(-30_000, 30_000, n), "Int32"),
        "f": pd.arrays.FloatingArray(f, rng.random(n) < 0.1),
        "i": nulls(rng.integers(-2 ** 62, 2 ** 62, n), "Int64"),
        "sh": nulls(rng.integers(-70, 70, n), "Int32"),
        "s": s})


def _slice7_expressions():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs import bitwise as B
    from spark_rapids_tpu_torch.exprs import datetime_exprs as D
    from spark_rapids_tpu_torch.exprs import math_exprs as M
    from spark_rapids_tpu_torch.exprs import string_fns as S
    from spark_rapids_tpu_torch.exprs.base import Literal, col, lit
    from spark_rapids_tpu_torch.exprs.cast import Cast
    from spark_rapids_tpu_torch.exprs.complex import GetArrayItem

    def cast(name, to):
        return Cast(col(name), getattr(T, to))
    return {
        "double_to_string": cast("f", "STRING"),
        "float_to_string": Cast(cast("f", "FLOAT32"), T.STRING),
        "int_to_string": cast("i", "STRING"),
        "timestamp_to_string": cast("ts", "STRING"),
        "string_to_double": cast("s", "FLOAT64"),
        "string_to_int": cast("s", "INT64"),
        "string_to_date": cast("s", "DATE32"),
        "string_to_timestamp": cast("s", "TIMESTAMP_US"),
        "string_to_bool": cast("s", "BOOL"),
        "double_to_timestamp": cast("f", "TIMESTAMP_US"),
        "timestamp_to_date": cast("ts", "DATE32"),
        "hour": D.Hour(col("ts")), "second": D.Second(col("ts")),
        "months_between": D.MonthsBetween(col("ts"), Literal(
            8035 * 86_400_000_000, T.TIMESTAMP_US)),
        "from_unixtime": D.FromUnixTime(D.UnixTimestamp(col("d"))),
        "trunc": D.TruncDate(col("ts"), lit("MM")),
        "weekday": D.WeekDay(col("d")),
        "upper": S.Upper(col("s")), "initcap": S.InitCap(col("s")),
        "trim": S.StringTrim(col("s")),
        "concat": S.ConcatStrings((col("s"), lit("|"), col("s"))),
        "replace": S.StringReplace(col("s"), lit("-"), lit("")),
        "lpad": S.LPad(col("s"), lit(9), lit("日")),
        "locate": S.StringLocate(lit("9"), col("s")),
        "substring_index": S.SubstringIndex(col("s"), lit("-"), lit(-2)),
        "split": GetArrayItem(S.StringSplit(col("s"), lit("-")), lit(1)),
        "round": M.Round(col("f"), 2),
        "log10": M.Log10(col("f")), "cbrt": M.Cbrt(col("f")),
        "shift_right_unsigned": B.ShiftRightUnsigned(col("i"), col("sh")),
        "bit_and": B.BitwiseAnd(col("i"), Literal(255, T.INT64)),
    }


#: the functions whose last bit the card's libm may change
_SLICE7_CLOSE = {"months_between", "log10", "cbrt"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_slice7_expressions()))
def test_slice7_expressions_match_the_cpu_engine(cuda_device, name):
    """The casts, timestamp, string, math and bitwise expressions on CUDA
    tensors against the port's CPU engine (plan/cpu_eval.py) on the same
    rows: strings, integers and nulls exact (the float formatter's and
    parser's bits too); log10, cbrt and months_between rtol 1e-14."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.base import make_eval_context
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
    from spark_rapids_tpu_torch.plan.nodes import normalize_df
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    df = _slice7_inputs()
    schema = T.Schema.of(("ts", T.TIMESTAMP_US), ("d", T.DATE32),
                         ("f", T.FLOAT64), ("i", T.INT64), ("sh", T.INT32),
                         ("s", T.STRING))
    expr = _slice7_expressions()[name]
    b = batch_from_df(df, schema, device=cuda_device)
    ctx = make_eval_context(b.columns, b.capacity,
                            torch.tensor(len(df), dtype=torch.int32,
                                         device=cuda_device))
    gv, gok = expr.bind(schema).eval(ctx).to_numpy(len(df))
    cpu = cpu_eval(expr, normalize_df(df, schema), schema)
    wok = ~cpu.isna().to_numpy()
    np.testing.assert_array_equal(gok, wok, err_msg=name)
    if gv.dtype == object:
        assert list(gv[wok]) == list(cpu[wok]), name
    elif name in _SLICE7_CLOSE:
        np.testing.assert_allclose(gv[wok], cpu[wok].to_numpy(gv.dtype),
                                   rtol=1e-14, equal_nan=True, err_msg=name)
    else:
        np.testing.assert_array_equal(gv[wok], cpu[wok].to_numpy(gv.dtype),
                                      err_msg=name)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["x1", "x2", "x3", "x3_country", "x4",
                                  "x4_supplier"])
def test_etl_plans_match_the_cpu_engine(cuda_device, plan):
    """chip_smoke.py's phase-10 plans (models/etl_bench.py) at scale
    factor 0.01 on the card, wholly there (spark.rapids.sql.test.enabled),
    against the CPU engine: keys, counts, integers and strings exact;
    floats rtol 1e-9 (pandas' var/std sum in another order)."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import etl_bench as EB
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    tables, _ = TB.sf10_tables(2, 0.01)
    build = getattr(EB, f"{plan}_plan")
    conf = C.RapidsConf({**EB.ETL_CONF, C.TEST_ENABLED.key: True})
    got = collect(accelerate(build(EB.port_classes(), TD.sources(tables, 4)),
                             conf, device=cuda_device), conf)
    want = build(EB.port_classes(), TD.sources(tables, 4)).collect()
    keys = list(want.columns[:2 if plan == "x4" else 1])
    want = want.sort_values(keys, ignore_index=True)
    got = got.sort_values(keys, ignore_index=True)
    floats = [c for c in want.columns if want[c].dtype.kind == "f"
              or str(want[c].dtype).startswith("Float")]
    compare_frames(want.drop(columns=floats), got.drop(columns=floats),
                   f"{plan} on the card", rtol=0, atol=0)
    if floats:
        compare_frames(want[floats], got[floats], f"{plan} on the card",
                       rtol=1e-9, atol=0)


# -- the memory layer on the card --------------------------------------------
def _memory_batch(dev):
    """Strings (empty, long and null), nulls, and both 32-bit shadows."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    rng = np.random.default_rng(21)
    n = 5000
    words = np.array(["", "a", "x" * 70, "naïve", "tpc-h"], dtype=object)
    strs = words[rng.integers(0, len(words), n)]
    strs[rng.random(n) < 0.1] = None
    return ColumnarBatch.from_numpy(
        {"i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int64),
         "f": rng.standard_normal(n) * 1e6, "s": strs},
        validity={"i": rng.random(n) > 0.1, "f": rng.random(n) > 0.1},
        device=dev)


def _same_bits(a, b):
    assert a.num_rows == b.num_rows
    n = a.num_rows
    for ca, cb in zip(a.columns, b.columns):
        assert ca.device == cb.device
        assert torch.equal(ca.validity[:n], cb.validity[:n])
        if ca.dtype.is_string:
            assert torch.equal(ca.lengths[:n], cb.lengths[:n])
            w = int(ca.lengths[:n].max())
            assert torch.equal(ca.data[:n, :w], cb.data[:n, :w])
        else:
            assert torch.equal(ca.data[:n].view(torch.uint8),
                               cb.data[:n].view(torch.uint8))
        assert (ca.narrow is None) == (cb.narrow is None)
        if ca.narrow is not None:
            assert torch.equal(ca.narrow[:n].view(torch.uint8),
                               cb.narrow[:n].view(torch.uint8))


@pytest.mark.gpu
def test_spill_chain_round_trip_on_the_card(cuda_device, tmp_path):
    """A CUDA batch with strings, nulls and f32/int32 shadows goes
    device -> host -> disk and back to the device with the same bits."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.memory import BufferId, ResourceEnv
    batch = _memory_batch(cuda_device)
    C.set_active_conf(C.RapidsConf(
        {"spark.rapids.memory.host.spillStorageSize": 1 << 24}))
    env = ResourceEnv.init(spill_dir=str(tmp_path), device=cuda_device)
    try:
        bid = BufferId(env.catalog.next_table_id())
        env.device_store.add_batch(bid, batch)
        assert env.device_store.synchronous_spill(0) > 0
        with env.catalog.acquired(bid) as buf:
            assert buf.tier.name == "HOST"
        assert env.host_store.synchronous_spill(0) > 0
        with env.catalog.acquired(bid) as buf:
            assert buf.tier.name == "DISK"
            back = buf.get_columnar_batch()
        assert back.device == batch.device
        _same_bits(batch, back)
    finally:
        ResourceEnv.shutdown()
        C.set_active_conf(C.RapidsConf())


@pytest.mark.gpu
def test_split_retry_under_injection_on_the_card(cuda_device):
    """with_split_retry over CUDA tensors under injection gives the
    uninjected result: a sort of each piece, merged, equals the whole
    sort."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.utils import metrics as M
    batch = _memory_batch(cuda_device)

    def body(b):
        return b.columns[0].data[:b.num_rows].clone()

    want = torch.sort(body(batch)).values
    keys = {"spark.rapids.memory.faultInjection.oomRate": 1.0,
            "spark.rapids.memory.faultInjection.seed": 3,
            "spark.rapids.memory.faultInjection.maxInjections": 6,
            "spark.rapids.memory.retry.minSplitRows": 256}
    ms = M.MetricSet()
    R.reset_oom_injection()
    with C.session(C.RapidsConf(keys)):
        pieces = list(R.with_split_retry(batch, body, metrics=ms,
                                         label="t"))
    assert R.injected_oom_count() == 6
    assert ms.value(M.NUM_SPLIT_RETRIES) + ms.value(M.NUM_RETRIES) > 0
    assert len(pieces) > 1
    assert all(p.device == batch.device for p in pieces)
    assert torch.equal(torch.sort(torch.cat(pieces)).values, want)


@pytest.mark.gpu
def test_device_manager_reads_the_card(cuda_device):
    """DeviceManager on a card reads its total from the CUDA driver and
    its resident bytes from the caching allocator."""
    from spark_rapids_tpu_torch.memory import DeviceManager
    dm = DeviceManager(device=cuda_device)
    assert dm.hbm_total == torch.cuda.mem_get_info(cuda_device)[1]
    assert dm.resident_bytes() == torch.cuda.memory_allocated(cuda_device)
    assert dm.budget == int(dm.hbm_total * 0.9) - (1 << 30)


@pytest.mark.gpu
def test_parquet_round_trip_on_the_card(cuda_device, tmp_path):
    """A batch with strings (empty ones too), nulls, dates and floats
    written as Parquet from CUDA tensors and read back onto the card:
    every tensor the same bits."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.io.writer import write_batches
    from spark_rapids_tpu_torch.plan.overrides import accelerate
    rng = np.random.default_rng(5)
    n = 5000
    strs = np.array([None if i % 7 == 0 else "" if i % 5 == 0
                     else "x" * (i % 23) + f"é{i}" for i in range(n)],
                    dtype=object)
    schema = T.Schema.of(("i", T.INT64), ("f", T.FLOAT64), ("s", T.STRING),
                         ("d", T.DATE32), ("b", T.BOOL))
    f = rng.normal(size=n)
    f[3] = np.nan
    batch = ColumnarBatch.from_numpy(
        {"i": np.arange(n, dtype=np.int64), "f": f, "s": strs,
         "d": rng.integers(-200000, 20000, n).astype(np.int32),
         "b": rng.random(n) < 0.5}, schema,
        {"i": np.arange(n) % 11 != 0, "f": np.arange(n) % 13 != 0,
         "s": np.array([v is not None for v in strs]),
         "d": np.ones(n, bool), "b": np.arange(n) % 3 != 0},
        device=cuda_device)
    conf = {"spark.sql.legacy.parquet.datetimeRebaseModeInWrite":
            "CORRECTED",
            "spark.sql.legacy.parquet.datetimeRebaseModeInRead":
            "CORRECTED"}
    with C.session(C.RapidsConf(conf)):
        stats = write_batches(iter([batch]), str(tmp_path / "o"),
                              "parquet", schema)
    assert stats.num_rows == n
    plan = accelerate(pio.read_parquet(str(tmp_path / "o")),
                      C.RapidsConf(conf), device=cuda_device)
    back = plan.collect()
    assert back.num_rows == n
    for name in schema.names:
        a, b = batch.column(name), back.column(name)
        assert b.device.type == cuda_device.type
        assert torch.equal(a.validity[:n], b.validity[:n]), name
        if a.dtype.is_string:
            assert torch.equal(torch.where(a.validity, a.lengths, 0)[:n],
                               b.lengths[:n]), name
            cc = min(a.char_cap, b.char_cap)
            inside = torch.arange(cc, device=cuda_device)[None, :] < \
                b.lengths[:n, None]
            assert torch.equal(torch.where(inside, a.data[:n, :cc], 0),
                               torch.where(inside, b.data[:n, :cc], 0))
        else:
            av = torch.where(a.validity, a.data, torch.zeros_like(a.data))
            bv = torch.where(b.validity, b.data, torch.zeros_like(b.data))
            assert torch.equal(av[:n].view(torch.uint8),
                               bv[:n].view(torch.uint8)), name


@pytest.mark.gpu
def test_q1_over_a_partitioned_parquet_dataset(cuda_device, tmp_path):
    """TPC-H Q1 over lineitem written by the port's writer on the card,
    partitioned by l_returnflag and l_linestatus, read back through
    read_parquet, against the CPU engine over the in-memory frame (keys
    and counts exact, floats rtol 1e-5), with window_group_sums
    launched."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    tables = TD.gen_tables(np.random.default_rng(11), 3000)
    conf = C.RapidsConf({**TB.BENCH_CONF,
                         "spark.rapids.sql.test.enabled": True})
    out = str(tmp_path / "lineitem")
    res = collect(accelerate(pio.write(
        TD.sources(tables, 4)["lineitem"], out, "parquet",
        ["l_returnflag", "l_linestatus"]), conf, device=cuda_device), conf)
    assert int(res["num_rows"][0]) == len(tables["lineitem"])
    before = GW.window_group_sums.launches
    got = collect(accelerate(QUERIES[1]({"lineitem": pio.read_parquet(out)},
                                        None), conf, device=cuda_device),
                  conf)
    assert GW.window_group_sums.launches > before
    want = QUERIES[1](TD.sources(tables, 2), None).collect()
    compare_frames(want, got, "q1 over parquet on the card")


@pytest.mark.gpu
def test_wrappers_under_threads_give_the_same_bits(cuda_device):
    """grouped_sum tiers A and B and window_group_sums called from four
    threads at once, interleaved: every result equal to the bit to the
    same call made alone, and the launch counters grown exactly (the
    runtime puts the wrappers on prefetch producers and concurrent
    sessions)."""
    import threading
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(3)
    rows = 1 << 20
    vals = [torch.rand(rows, generator=g, device=dev) for _ in range(6)]
    keys_a = torch.randint(0, 26, (rows,), generator=g, device=dev,
                           dtype=torch.int32)
    keys_b = torch.randint(0, 300, (rows,), generator=g, device=dev,
                           dtype=torch.int32)
    gid = torch.clamp(torch.arange(1 << 14, device=dev) // 8,
                      max=5).to(torch.int32)
    mvals = [torch.rand(1 << 14, generator=g, device=dev) for _ in range(17)]
    calls = {
        "A": lambda: K.grouped_sum(keys_a, vals, rows, n_groups=26,
                                   capacity=rows),
        "B": lambda: K.grouped_sum(keys_b, vals, rows, n_groups=300,
                                   capacity=rows),
        "W": lambda: (GW.window_group_sums(gid, mvals, out_cap=50,
                                           capacity=1 << 14),)}
    alone = {name: fn() for name, fn in calls.items()}
    before = (K.grouped_sum.launches, GW.window_group_sums.launches)
    errors = []

    def worker():
        try:
            for _ in range(25):
                for name, fn in calls.items():
                    for x, y in zip(fn(), alone[name]):
                        assert torch.equal(x, y), name
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errors, errors
    assert K.grouped_sum.launches - before[0] == 4 * 25 * 2
    assert GW.window_group_sums.launches - before[1] == 4 * 25


@pytest.mark.gpu
def test_producer_enqueues_on_its_creators_stream(cuda_device):
    """A prefetch producer's launches go on the stream current where its
    iterator was made (a side stream here), so its batches need no sync
    between streams."""
    from spark_rapids_tpu_torch.exec.pipeline import PrefetchIterator
    side = torch.cuda.Stream(device=cuda_device)
    seen = []

    def src():
        seen.append(torch.cuda.current_stream(cuda_device).cuda_stream)
        yield torch.ones(4, device=cuda_device)

    with torch.cuda.stream(side):
        (x,) = list(PrefetchIterator(src(), depth=1))
        assert x.sum().item() == 4
    assert seen == [side.cuda_stream]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["broadcast_join", "aqe_q5"])
def test_runtime_plans_match_the_cpu(cuda_device, case):
    """A planner join with broadcast=True (BroadcastHashJoinExec) and
    TPC-H Q5 under spark.sql.adaptive.enabled (query stages, a demoted
    broadcast join) on the card, against the same plans on the CPU
    (keys and counts exact, floats rtol 1e-5)."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec.joins import JoinType
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models import tpch_queries as TQ
    from spark_rapids_tpu_torch.plan import aqe
    from spark_rapids_tpu_torch.plan.overrides import (ExecutionPlanCapture,
                                                       accelerate, collect)
    tables, _ = TB.sf10_tables(2, 0.01)
    adaptive = case == "aqe_q5"
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                         C.ADAPTIVE_ENABLED.key: adaptive})

    def plan_of():
        t = TD.sources(tables, 4)
        if adaptive:
            return TQ.QUERIES[5](t, None)
        return TQ._join(JoinType.INNER, t["orders"], t["customer"],
                        ["o_custkey"], ["c_custkey"], broadcast=True)

    plan = accelerate(plan_of(), conf, device=cuda_device)
    got = collect(plan, conf)
    kinds = set()
    node_stack = [ExecutionPlanCapture.last_plan]
    while node_stack:
        n = node_stack.pop()
        kinds.add(type(n).__name__)
        node_stack.extend(n.children)
        if isinstance(n, aqe.ShuffleQueryStageExec):
            node_stack.append(n.exchange)
        if isinstance(n, aqe.CustomShuffleReaderExec):
            node_stack.append(n.stage)
    assert "BroadcastHashJoinExec" in kinds, kinds
    if adaptive:
        assert "ShuffleQueryStageExec" in kinds, kinds
    want = collect(accelerate(plan_of(), conf, device="cpu"), conf)
    compare_frames(want, got, f"{case} on the card")


@pytest.mark.gpu
def test_shuffle_write_on_a_side_stream_fetched_over_tcp(cuda_device):
    """A map task writes its slices on a side stream while the output is
    fetched over TCP at once: the serving handler thread (on no stream of
    the writer's) waits on each buffer's event, so the bytes the reader
    gets are the writer's, every time."""
    import threading

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    from spark_rapids_tpu_torch.shuffle.manager import (MapOutputRegistry,
                                                        TpuShuffleManager)
    dev = cuda_device
    conf = C.RapidsConf({"spark.rapids.shuffle.enabled": True})
    env = ResourceEnv.init(conf, device=dev)
    try:
        m0 = TpuShuffleManager("gpu-w", env, conf)
        m1 = TpuShuffleManager("gpu-r", env, conf)
        rounds, rows = 8, 1 << 20
        for m in (m0, m1):
            for sid in range(rounds):
                m.register_shuffle(sid)
        side = torch.cuda.Stream(dev)
        want = []
        errors: list = []

        def read(sid):
            try:
                got = list(m1.get_reader(sid, 0, timeout=30.0))
                assert len(got) == 1
                errors.append(None if torch.equal(
                    got[0].column("k").data[:rows], want[sid]) else sid)
            except BaseException as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        readers = []
        for sid in range(rounds):
            with torch.cuda.stream(side):
                # a slow producer on the side stream: the values land long
                # after the host has moved on
                base = torch.arange(rows, device=dev, dtype=torch.int64)
                for _ in range(20):
                    base = base * 3 + sid
                torch.cuda._sleep(5_000_000)
                k = base + 1
                b = ColumnarBatch.from_numpy(
                    {"k": np.zeros(rows, np.int64)}, device=dev)
                b.columns[0].data[:rows].copy_(k)
                b.columns[0].narrow = None
                # ordered before the write's event, so a reader that got
                # the bytes may read it
                want.append(k.clone())
                w = m0.get_writer(sid, 0)
                w.write_partition(0, b)
                status = w.commit(1)
            status.address = m0.tcp_address  # the wire lane
            MapOutputRegistry.register(sid, 0, status)
            t = threading.Thread(target=read, args=(sid,))
            t.start()
            readers.append(t)
        for t in readers:
            t.join(60)
        torch.cuda.synchronize(dev)
        assert errors == [None] * rounds, errors
    finally:
        MapOutputRegistry.clear()
        TpuShuffleManager.close_all()
        ResourceEnv.shutdown()


# -- the observability layer on the card --------------------------------------
@pytest.mark.gpu
def test_nvtx_annotation_on_a_cuda_query(cuda_device):
    """A CUDA query's spans annotate as NVTX ranges; pushing and popping
    them raises nothing (a failing range would, nothing is caught)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.utils import profile as P
    from spark_rapids_tpu_torch.utils import tracing as TR
    conf = C.RapidsConf({"spark.rapids.sql.profile.enabled": True})
    scope = S.QueryScope(conf, device=cuda_device)
    try:
        assert TR.query_device_is_cuda()
        assert isinstance(TR.annotation("unit"), TR._NvtxRange)
        tr = P.tracer()
        assert tr is not None and tr.cuda
        with P.span("nvtx-unit"), TR.trace_range("inner"):
            torch.ones(4, device=cuda_device).sum()
    finally:
        scope.close()
    prof = P.last_profile()
    assert any(s.name == "nvtx-unit" for s in prof.spans)
    P.clear_history()


@pytest.mark.gpu
def test_sampled_kernel_timing_adds_no_host_sync(cuda_device, monkeypatch):
    """Every launch sampled (sampleRate 1): no host sync and no
    torch.cuda.synchronize while the query launches; the events are read
    once, at the query's end."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.utils import checks as CK
    from spark_rapids_tpu_torch.utils import kernelprof as KP
    from spark_rapids_tpu_torch.utils import profile as P
    dev = cuda_device
    rows = 1 << 20
    g = torch.Generator(device=dev).manual_seed(5)
    vals = [torch.rand(rows, generator=g, device=dev) for _ in range(4)]
    keys = torch.randint(0, 26, (rows,), generator=g, device=dev,
                         dtype=torch.int32)
    K.grouped_sum(keys, vals, rows, n_groups=26, capacity=rows)  # build
    torch.cuda.synchronize()
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), real_sync(*a,
                                                                   **k)))
    conf = C.RapidsConf({
        "spark.rapids.sql.profile.enabled": True,
        "spark.rapids.sql.profile.kernels.enabled": True,
        "spark.rapids.sql.profile.kernels.sampleRate": 1})
    KP.reset()
    scope = S.QueryScope(conf, device=dev)
    try:
        h0 = CK.host_sync_count()
        before = K.grouped_sum.launches
        for _ in range(20):
            K.grouped_sum(keys, vals, rows, n_groups=26, capacity=rows)
        assert CK.host_sync_count() == h0
        assert syncs == []
        launches = K.grouped_sum.launches - before
    finally:
        scope.close()
    prof = P.last_profile()
    rows_ = [r for r in prof.kernels if r["label"] == "grouped_sum"]
    assert sum(r["dispatches"] for r in rows_) == launches == 20
    assert sum(r["sampled"] for r in rows_) == 20
    assert all(r["device_ms"] > 0 for r in rows_)
    assert CK.host_sync_sites().get("kernelprof.resolve", 0) >= 1
    KP.reset()
    P.clear_history()


@pytest.mark.gpu
def test_catalog_launches_equal_wrapper_counts_under_threads(cuda_device):
    """Eight threads calling the three hand kernels at once: each
    kernel's catalog launches equal its wrapper's `.launches` delta."""
    import threading
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models.tpch import gen_lineitem_arrays
    from spark_rapids_tpu_torch.utils import kernelprof as KP
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(9)
    rows = 1 << 18
    vals = [torch.rand(rows, generator=g, device=dev) for _ in range(6)]
    keys = torch.randint(0, 26, (rows,), generator=g, device=dev,
                         dtype=torch.int32)
    gid = torch.clamp(torch.arange(1 << 14, device=dev) // 8,
                      max=5).to(torch.int32)
    mvals = [torch.rand(1 << 14, generator=g, device=dev) for _ in range(17)]
    cols = gen_lineitem_arrays(np.random.default_rng(6), 1 << 16)
    arrays = [torch.from_numpy(cols[n]).to(dev)
              for n in LINEITEM_SCHEMA.names]
    calls = [
        lambda: K.grouped_sum(keys, vals, rows, n_groups=26, capacity=rows),
        lambda: GW.window_group_sums(gid, mvals, out_cap=50,
                                     capacity=1 << 14),
        lambda: K.q1_fused(*arrays, 1 << 16, capacity=1 << 16,
                           cutoff=Q1_CUTOFF_DAYS)]
    for fn in calls:
        fn()  # build outside the counted window
    KP.reset()
    KP.enable(C.RapidsConf({"spark.rapids.sql.profile.kernels.enabled":
                            True,
                            "spark.rapids.sql.profile.kernels.sampleRate":
                            3}))
    wrappers = (K.grouped_sum, GW.window_group_sums, K.q1_fused)
    before = [w.launches for w in wrappers]
    errors = []

    def worker():
        try:
            for _ in range(10):
                for fn in calls:
                    fn()
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    torch.cuda.synchronize()
    try:
        assert not errors, errors
        for w, b, name in zip(wrappers, before, ("grouped_sum",
                                                 "window_group_sums",
                                                 "q1_fused")):
            tot = KP.hand_kernel_totals(name)
            assert tot["launches"] == w.launches - b > 0, name
            assert tot["sampled"] > 0, name
    finally:
        KP.reset()


@pytest.mark.gpu
def test_plugin_brings_the_executor_up_on_the_card_and_back(cuda_device):
    """plugin.activate() makes the ResourceEnv on the card and runs a UDF
    that compiles there; deactivate() gives the device memory back."""
    import gc

    import pandas as pd

    from spark_rapids_tpu_torch import plugin
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import collect
    from spark_rapids_tpu_torch.udf import tpu_udf

    @tpu_udf(T.INT64)
    def tag(s):
        return 1 if s.find("ok") >= 0 else 0

    gc.collect()
    before = torch.cuda.memory_allocated(cuda_device)
    conf = plugin.activate({"spark.rapids.sql.test.enabled": True})
    try:
        assert ResourceEnv.peek().device.type == "cuda"
        rules = plugin.active_extensions().columnar_rules[0](conf)
        plan = rules.pre_columnar_transitions(N.CpuProject(
            [tag(col("s")).alias("t")], N.CpuSource.from_pandas(
                pd.DataFrame({"s": ["ok", "no", "okay", None]}))))
        assert isinstance(plan, TpuExec)
        assert collect(plan)["t"].tolist() == [1, 0, 1, 0]
        del plan
    finally:
        plugin.deactivate()
    gc.collect()
    torch.cuda.synchronize()
    assert ResourceEnv.peek() is None
    assert torch.cuda.memory_allocated(cuda_device) == before


@pytest.mark.gpu
def test_a_udf_worker_sees_no_card(cuda_device):
    """A daemon worker on a machine with a card runs with
    CUDA_VISIBLE_DEVICES empty: torch there finds no device."""
    import pandas as pd

    from spark_rapids_tpu_torch.pyudf import daemon

    def probe(frame):
        import os

        import torch as t
        return pd.DataFrame({"env": [os.environ["CUDA_VISIBLE_DEVICES"]],
                             "cuda": [t.cuda.is_available()]})

    pool = daemon.PythonWorkerPool(max_workers=1)
    try:
        out = pool.run_udf(probe, pd.DataFrame({"x": [0]}))
    finally:
        pool.close()
    assert out["env"].tolist() == [""] and out["cuda"].tolist() == [False]


@pytest.mark.gpu
def test_a_plan_that_raises_out_of_memory_frees_its_memory_at_once(
        cuda_device, monkeypatch):
    """The card twin of tests/test_torch_tpch.py
    test_a_dropped_plan_is_freed_at_once for a query that raises
    torch.cuda.OutOfMemoryError partway: once its error is dropped, with
    the cycle collector off, the card's memory is back where it was
    before the query."""
    import gc

    from spark_rapids_tpu_torch.columnar.vector import ColumnVector
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    tables = TD.gen_tables(np.random.default_rng(7), 20_000)
    TB.run_query(3, tables, device=cuda_device)  # the wrappers' own state
    orig = ColumnVector.gather
    calls = [0]

    def gather(self, indices, index_valid=None):
        out = orig(self, indices, index_valid)
        calls[0] += 1
        if calls[0] == 120:
            raise torch.cuda.OutOfMemoryError("injected for the test")
        return out
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    monkeypatch.setattr(ColumnVector, "gather", gather)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        err = None
        try:
            TB.run_query(3, tables, device=cuda_device)
        except torch.cuda.OutOfMemoryError as e:
            err = e
        assert err is not None and calls[0] == 120
        held = torch.cuda.memory_allocated(cuda_device)
        del err
        torch.cuda.synchronize()
        assert held > before
        assert torch.cuda.memory_allocated(cuda_device) == before
    finally:
        if was_enabled:
            gc.enable()


@pytest.mark.gpu
def test_mesh_lanes_on_the_card(cuda_device):
    """A 4-slot mesh over the visible cards (all four on one card when
    there is one): TPC-H Q3 and Q5 with the SPMD lane on run their hash
    exchanges through the mesh all-to-all and their fused stages as
    gangs, and equal the CPU engine (keys and counts exact, floats rtol
    1e-5)."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import spmd as SP
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.parallel.mesh import active_mesh, make_mesh
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    cards = torch.cuda.device_count()
    mesh = make_mesh(4, slots_per_device=-(-4 // cards))
    tables = TD.gen_tables(np.random.default_rng(11), 20_000)
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                         C.SPMD_ENABLED.key: True})
    for query in (3, 5):
        ShuffleExchangeExec._MESH_EXCHANGES_RUN = 0
        SP.reset_spmd_stats()
        with active_mesh(mesh):
            got = TB.run_query(query, tables, device=cuda_device, conf=conf,
                               num_partitions=4)
        assert ShuffleExchangeExec._MESH_EXCHANGES_RUN > 0
        st = SP.spmd_stats()
        assert st["gang_dispatches"] > 0 and st["deopts"] == 0, st
        want = QUERIES[query](TD.sources(tables, 4),
                              lambda plan: plan.collect()).collect()
        compare_frames(want, got, f"q{query} over the mesh on the card")
