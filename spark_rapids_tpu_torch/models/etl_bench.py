"""ETL plans over the TPC-H tables (`tpch_bench.sf10_tables`): the
shapes of a CSV ingest's round trip through text, timestamps, the
cleansing of customer strings, and sample statistics (TPC-DS's
stddev_samp queries, Q17 and Q39, compute the same statistics).

Each builder takes a namespace `M` of expression, aggregate and plan
node classes (`port_classes()` gives this package's) and a dict of
CpuSource plan leaves, and returns the CpuNode plan a user would submit
through `accelerate` + `collect`.  Nothing is cut in scale: the plans
read whole tables.

  X1  orders: o_orderkey, o_orderdate, o_totalprice and the order date
      as a timestamp cast to STRING and back, the mismatches counted
      (`x1_plan`, all 0); `x1_strings_plan` projects the strings alone.
  X2  orders: ts = from_unixtime(unix_timestamp(o_orderdate)
      + o_orderkey * 7919 % 86400); its fields, to_date (== the order
      date), trunc, months_between, time_add, weekday and its text,
      grouped by its hour (`x2_plan`); `x2_rows_plan` projects them.
  X3  customer: upper/lower/initcap, trims, concat, replace, pads,
      substring_index, locate and split(c_phone, '-')[0] cast to an int,
      TPC-H's country code (spec 4.2.2.9: c_nationkey + 10)
      (`x3_plan`); `x3_country_plan` counts the customers per code.
  X4  lineitem: var_samp, stddev_samp, first/last, sums of narrow casts,
      of sqrt and log10, of a bitwise and, the max of an unsigned shift
      and a rounded average, by (l_returnflag, l_linestatus)
      (`x4_plan`); stddev_samp by l_suppkey (`x4_supplier_plan`); and
      an ANSI cast whose overflow raises at collect (`x4_ansi_plan`).

The three gated casts must be on (`ETL_CONF`) for X1-X3 to run on the
device.
"""
from __future__ import annotations

import types

from spark_rapids_tpu_torch.models import tpch_bench

#: the conf of the ETL plans: the TPC bench conf plus the three cast gates
ETL_CONF = {
    **tpch_bench.BENCH_CONF,
    "spark.rapids.sql.castFloatToString.enabled": True,
    "spark.rapids.sql.castStringToFloat.enabled": True,
    "spark.rapids.sql.castStringToTimestamp.enabled": True,
}

#: 1992-01-01 00:00:00 UTC in microseconds, X2's months_between origin
X2_ORIGIN_US = 8035 * 86_400_000_000


def port_classes():
    """This package's classes under the names the builders use."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs import (aggregates, arithmetic, base,
                                              bitwise, cast, complex,
                                              datetime_exprs, math_exprs,
                                              predicates, string_fns)
    from spark_rapids_tpu_torch.plan import nodes
    return namespace(T, base, (aggregates, arithmetic, bitwise, cast,
                               complex, datetime_exprs, math_exprs,
                               predicates, string_fns, nodes))


def namespace(types_mod, base, modules):
    """A namespace of `types_mod` as T, `base`'s col/lit/Literal/Alias
    and every class of `modules` by its name."""
    ns = types.SimpleNamespace(T=types_mod, col=base.col, lit=base.lit,
                               Literal=base.Literal, Alias=base.Alias)
    for m in modules:
        for k, v in vars(m).items():
            if isinstance(v, type):
                setattr(ns, k, v)
    return ns


def _miss(M, expr, dt):
    """1 where `expr` does not survive a cast to STRING and back to
    `dt` (a null that appears counts too), else 0."""
    back = M.Cast(M.Cast(expr, M.T.STRING), dt)
    return M.Cast(M.Not(M.EqualNullSafe(back, expr)), M.T.INT64)


def x1_plan(M, src):
    o = src["orders"]
    ts = M.Cast(M.col("o_orderdate"), M.T.TIMESTAMP_US)
    proj = M.CpuProject([
        _miss(M, M.col("o_orderkey"), M.T.INT64).alias("k_miss"),
        _miss(M, M.col("o_orderdate"), M.T.DATE32).alias("d_miss"),
        _miss(M, M.col("o_totalprice"), M.T.FLOAT64).alias("p_miss"),
        _miss(M, ts, M.T.TIMESTAMP_US).alias("t_miss")], o)
    return M.CpuAggregate([], [
        M.Count(None).alias("rows"),
        M.Sum(M.col("k_miss")).alias("k_miss"),
        M.Sum(M.col("d_miss")).alias("d_miss"),
        M.Sum(M.col("p_miss")).alias("p_miss"),
        M.Sum(M.col("t_miss")).alias("t_miss")], proj)


def x1_strings_plan(M, orders):
    """The four strings of X1 over an orders source (a sample)."""
    s = M.T.STRING
    return M.CpuProject([
        M.col("o_orderkey"),
        M.Cast(M.col("o_orderkey"), s).alias("k_str"),
        M.Cast(M.col("o_orderdate"), s).alias("d_str"),
        M.Cast(M.col("o_totalprice"), s).alias("p_str"),
        M.Cast(M.Cast(M.col("o_orderdate"), M.T.TIMESTAMP_US), s
               ).alias("t_str")], orders)


def _x2_rows(M, orders):
    ts = M.FromUnixTime(M.UnixTimestamp(M.col("o_orderdate"))
                        + (M.col("o_orderkey") * M.lit(7919)) % M.lit(86400))
    with_ts = M.CpuProject([M.col("o_orderkey"), M.col("o_orderdate"),
                            ts.alias("ts")], orders)
    t, d = M.col("ts"), M.col("o_orderdate")
    return M.CpuProject([
        M.col("o_orderkey"), t,
        M.Hour(t).alias("h"), M.Minute(t).alias("mi"),
        M.Second(t).alias("s"), M.ToDate(t).alias("td"),
        M.TruncDate(d, M.lit("MM")).alias("tm"),
        M.TruncDate(d, M.lit("YEAR")).alias("ty"),
        M.MonthsBetween(t, M.Literal(X2_ORIGIN_US, M.T.TIMESTAMP_US)
                        ).alias("mb"),
        M.TimeAdd(t, M.Literal(3_600_000_000, M.T.INT64)).alias("ta"),
        M.WeekDay(d).alias("wd"),
        M.Cast(t, M.T.STRING).alias("t_str"),
        M.Cast(M.Not(M.EqualNullSafe(M.ToDate(t), d)), M.T.INT64
               ).alias("d_miss")], with_ts)


def x2_plan(M, src):
    rows = _x2_rows(M, src["orders"])
    c = M.col
    return M.CpuAggregate([c("h")], [
        M.Count(None).alias("rows"), M.Sum(c("mi")).alias("sum_minute"),
        M.Sum(c("s")).alias("sum_second"), M.Sum(c("wd")).alias("sum_wd"),
        M.Min(c("mb")).alias("min_mb"), M.Max(c("mb")).alias("max_mb"),
        M.Min(c("tm")).alias("min_tm"), M.Max(c("ty")).alias("max_ty"),
        M.Max(c("ta")).alias("max_ta"), M.Sum(c("d_miss")).alias("d_miss"),
        M.Sum(M.Length(c("t_str"))).alias("text_len")], rows)


def x2_rows_plan(M, orders):
    return _x2_rows(M, orders)


def _x3_exprs(M):
    s = M.T.STRING
    c, lit = M.col, M.lit
    cc = M.Cast(M.GetArrayItem(M.StringSplit(c("c_phone"), lit("-"),
                                             M.Literal(-1, M.T.INT32)),
                               lit(0)), M.T.INT32)
    return [
        c("c_custkey"),
        M.Upper(c("c_name")).alias("up"),
        M.Lower(c("c_mktsegment")).alias("lo"),
        M.InitCap(M.Lower(c("c_mktsegment"))).alias("ic"),
        M.StringTrim(M.ConcatStrings((lit("  "), c("c_phone"), lit(" ")))
                     ).alias("tr"),
        M.ConcatStrings((c("c_name"), lit("|"), c("c_phone"))).alias("cat"),
        M.StringReplace(c("c_phone"), lit("-"), lit("")).alias("rep"),
        M.LPad(M.Cast(c("c_custkey"), s), lit(9), lit("0")).alias("lp"),
        M.RPad(c("c_mktsegment"), lit(12), lit(".")).alias("rp"),
        M.SubstringIndex(c("c_phone"), lit("-"), lit(2)).alias("si"),
        M.StringLocate(lit("#"), c("c_name")).alias("loc"),
        cc.alias("cc")]


def x3_plan(M, src):
    return M.CpuProject(_x3_exprs(M), src["customer"])


def x3_country_plan(M, src):
    codes = M.CpuProject([_x3_exprs(M)[-1]], src["customer"])
    return M.CpuAggregate([M.col("cc")], [M.Count(None).alias("n")], codes)


def x4_plan(M, src):
    c, lit = M.col, M.lit
    ext = c("l_extendedprice")
    proj = M.CpuProject([
        c("l_returnflag"), c("l_linestatus"), ext,
        c("l_quantity"),
        M.Cast(c("l_linenumber"), M.T.INT8).alias("ln8"),
        M.Cast(c("l_quantity"), M.T.INT16).alias("q16"),
        M.Sqrt(ext).alias("sq"), M.Log10(ext).alias("lg"),
        M.BitwiseAnd(c("l_orderkey"), M.Literal(255, M.T.INT64)
                     ).alias("band"),
        M.ShiftRightUnsigned(c("l_orderkey"), lit(3)).alias("shr"),
        (ext * (lit(1.0) - c("l_discount"))).alias("disc")],
        src["lineitem"])
    agg = M.CpuAggregate([c("l_returnflag"), c("l_linestatus")], [
        M.VarianceSamp(ext).alias("var_price"),
        M.StddevSamp(c("l_quantity")).alias("sd_qty"),
        M.First(c("l_linestatus")).alias("first_status"),
        M.Last(c("l_linestatus")).alias("last_status"),
        M.Sum(c("ln8")).alias("sum_ln"), M.Sum(c("q16")).alias("sum_q16"),
        M.Sum(c("sq")).alias("sum_sqrt"), M.Sum(c("lg")).alias("sum_log10"),
        M.Sum(c("band")).alias("sum_band"), M.Max(c("shr")).alias("max_shr"),
        M.Average(c("disc")).alias("avg_disc"),
        M.Count(None).alias("rows")], proj)
    names = ["l_returnflag", "l_linestatus", "var_price", "sd_qty",
             "first_status", "last_status", "sum_ln", "sum_q16", "sum_sqrt",
             "sum_log10", "sum_band", "max_shr", "rows"]
    return M.CpuProject([c(n) for n in names]
                        + [M.Round(c("avg_disc"), 2).alias("avg_disc")], agg)


def x4_supplier_plan(M, src):
    return M.CpuAggregate([M.col("l_suppkey")], [
        M.StddevSamp(M.col("l_extendedprice")).alias("sd_price"),
        M.Count(None).alias("rows")], src["lineitem"])


def x4_ansi_plan(M, src, column: str, to):
    """sum(cast(column as `to`)) with Spark's ANSI mode: an overflow
    raises ArithmeticError when the plan is collected."""
    proj = M.CpuProject([M.Cast(M.col(column), to, True).alias("v")],
                        src["lineitem"])
    return M.CpuAggregate([], [M.Sum(M.col("v")).alias("total")], proj)
