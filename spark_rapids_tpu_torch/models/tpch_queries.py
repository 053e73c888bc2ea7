"""TPC-H queries as CPU plan trees (port of
spark_rapids_tpu/models/tpch_queries.py, cut to Q1 and Q3-Q10).

Each query is `qN(t, run) -> CpuNode`: `t` maps table name -> a fresh
source plan; `run(plan) -> DataFrame` executes a sub-plan on the engine
under test (for scalar subqueries; these queries have none).  Q4's
correlated EXISTS is decorrelated the way Catalyst does it, as a left
semi join.  Dates are DATE32 day literals via `tpch_data.days`.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.exprs.base import Literal, col, lit
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
from spark_rapids_tpu_torch.exprs.datetime_exprs import Year
from spark_rapids_tpu_torch.exprs.string_fns import Contains
from spark_rapids_tpu_torch.models.tpch_data import days
from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuFilter,
                                               CpuHashJoin, CpuLimit,
                                               CpuProject, CpuSort)

J = JoinType


def dlit(s: str) -> Literal:
    """DATE32 literal from 'YYYY-MM-DD'."""
    return Literal(days(s), T.DATE32)


def _join(jt, left, right, lk, rk, condition=None, broadcast=False):
    return CpuHashJoin(jt, [col(k) for k in lk], [col(k) for k in rk],
                       left, right, condition=condition,
                       broadcast=broadcast)


def _rename(node, mapping):
    """Project that renames `mapping` keys and keeps only them."""
    return CpuProject([col(a).alias(b) for a, b in mapping.items()], node)


def _cols(node, *names):
    return CpuProject([col(n) for n in names], node)


def q1(t, run):
    """Pricing summary report."""
    li = CpuFilter(col("l_shipdate") <= dlit("1998-09-02"),
                   t["lineitem"])
    disc = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc * (lit(1.0) + col("l_tax"))
    agg = CpuAggregate(
        [col("l_returnflag"), col("l_linestatus")],
        [Sum(col("l_quantity")).alias("sum_qty"),
         Sum(col("l_extendedprice")).alias("sum_base_price"),
         Sum(disc).alias("sum_disc_price"),
         Sum(charge).alias("sum_charge"),
         Average(col("l_quantity")).alias("avg_qty"),
         Average(col("l_extendedprice")).alias("avg_price"),
         Average(col("l_discount")).alias("avg_disc"),
         Count(None).alias("count_order")], li)
    return CpuSort([asc(col("l_returnflag")), asc(col("l_linestatus"))],
                   agg)


def q3(t, run):
    """Shipping priority."""
    cust = CpuFilter(col("c_mktsegment") == lit("BUILDING"),
                     t["customer"])
    orders = CpuFilter(col("o_orderdate") < dlit("1995-03-15"),
                       t["orders"])
    li = CpuFilter(col("l_shipdate") > dlit("1995-03-15"),
                   t["lineitem"])
    joined = _join(J.INNER,
                   _join(J.INNER, cust, orders,
                         ["c_custkey"], ["o_custkey"]),
                   li, ["o_orderkey"], ["l_orderkey"])
    agg = CpuAggregate(
        [col("l_orderkey"), col("o_orderdate"), col("o_shippriority")],
        [Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))
             ).alias("revenue")], joined)
    return CpuLimit(10, CpuSort(
        [desc(col("revenue")), asc(col("o_orderdate"))], agg))


def q4(t, run):
    """Order priority checking (EXISTS -> left semi join)."""
    orders = CpuFilter(
        (col("o_orderdate") >= dlit("1993-07-01")) &
        (col("o_orderdate") < dlit("1993-10-01")), t["orders"])
    late = CpuFilter(col("l_commitdate") < col("l_receiptdate"),
                     t["lineitem"])
    semi = _join(J.LEFT_SEMI, orders, late,
                 ["o_orderkey"], ["l_orderkey"])
    agg = CpuAggregate([col("o_orderpriority")],
                       [Count(None).alias("order_count")], semi)
    return CpuSort([asc(col("o_orderpriority"))], agg)


def q5(t, run):
    """Local supplier volume."""
    region = CpuFilter(col("r_name") == lit("ASIA"), t["region"])
    orders = CpuFilter(
        (col("o_orderdate") >= dlit("1994-01-01")) &
        (col("o_orderdate") < dlit("1995-01-01")), t["orders"])
    joined = _join(
        J.INNER,
        _join(J.INNER,
              _join(J.INNER,
                    _join(J.INNER, t["customer"], orders,
                          ["c_custkey"], ["o_custkey"]),
                    t["lineitem"], ["o_orderkey"], ["l_orderkey"]),
              t["supplier"], ["l_suppkey", "c_nationkey"],
              ["s_suppkey", "s_nationkey"]),
        _join(J.INNER, t["nation"], region,
              ["n_regionkey"], ["r_regionkey"]),
        ["s_nationkey"], ["n_nationkey"])
    agg = CpuAggregate(
        [col("n_name")],
        [Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))
             ).alias("revenue")], joined)
    return CpuSort([desc(col("revenue"))], agg)


def q6(t, run):
    """Forecast revenue change."""
    li = CpuFilter(
        (col("l_shipdate") >= dlit("1994-01-01")) &
        (col("l_shipdate") < dlit("1995-01-01")) &
        (col("l_discount") >= lit(0.05)) &
        (col("l_discount") <= lit(0.07)) &
        (col("l_quantity") < lit(24.0)), t["lineitem"])
    return CpuAggregate(
        [], [Sum(col("l_extendedprice") * col("l_discount"))
             .alias("revenue")], li)


def _year_of(day_col):
    """year(DATE32), through the Year expression both engines have."""
    return Year(day_col)


def q7(t, run):
    """Volume shipping between FRANCE and GERMANY."""
    n1 = _rename(t["nation"], {"n_nationkey": "n1_key",
                               "n_name": "supp_nation"})
    n2 = _rename(t["nation"], {"n_nationkey": "n2_key",
                               "n_name": "cust_nation"})
    li = CpuFilter(
        (col("l_shipdate") >= dlit("1995-01-01")) &
        (col("l_shipdate") <= dlit("1996-12-31")), t["lineitem"])
    joined = _join(
        J.INNER,
        _join(J.INNER,
              _join(J.INNER,
                    _join(J.INNER,
                          _join(J.INNER, t["supplier"], li,
                                ["s_suppkey"], ["l_suppkey"]),
                          t["orders"], ["l_orderkey"], ["o_orderkey"]),
                    t["customer"], ["o_custkey"], ["c_custkey"]),
              n1, ["s_nationkey"], ["n1_key"]),
        n2, ["c_nationkey"], ["n2_key"])
    joined = CpuFilter(
        ((col("supp_nation") == lit("FRANCE")) &
         (col("cust_nation") == lit("GERMANY"))) |
        ((col("supp_nation") == lit("GERMANY")) &
         (col("cust_nation") == lit("FRANCE"))), joined)
    proj = CpuProject(
        [col("supp_nation"), col("cust_nation"),
         _year_of(col("l_shipdate")).alias("l_year"),
         (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
          ).alias("volume")], joined)
    agg = CpuAggregate(
        [col("supp_nation"), col("cust_nation"), col("l_year")],
        [Sum(col("volume")).alias("revenue")], proj)
    return CpuSort([asc(col("supp_nation")), asc(col("cust_nation")),
                    asc(col("l_year"))], agg)


def q8(t, run):
    """National market share of BRAZIL in AMERICA."""
    n1 = _rename(t["nation"], {"n_nationkey": "n1_key",
                               "n_regionkey": "n1_region"})
    n2 = _rename(t["nation"], {"n_nationkey": "n2_key",
                               "n_name": "nation_name"})
    part = CpuFilter(col("p_type") == lit("ECONOMY ANODIZED STEEL"),
                     t["part"])
    orders = CpuFilter(
        (col("o_orderdate") >= dlit("1995-01-01")) &
        (col("o_orderdate") <= dlit("1996-12-31")), t["orders"])
    region = CpuFilter(col("r_name") == lit("AMERICA"), t["region"])
    joined = _join(
        J.INNER,
        _join(J.INNER,
              _join(J.INNER,
                    _join(J.INNER,
                          _join(J.INNER,
                                _join(J.INNER, part, t["lineitem"],
                                      ["p_partkey"], ["l_partkey"]),
                                t["supplier"], ["l_suppkey"],
                                ["s_suppkey"]),
                          orders, ["l_orderkey"], ["o_orderkey"]),
                    t["customer"], ["o_custkey"], ["c_custkey"]),
              _join(J.INNER, n1, region, ["n1_region"], ["r_regionkey"]),
              ["c_nationkey"], ["n1_key"]),
        n2, ["s_nationkey"], ["n2_key"])
    proj = CpuProject(
        [_year_of(col("o_orderdate")).alias("o_year"),
         (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
          ).alias("volume"),
         col("nation_name")], joined)
    brazil_vol = CaseWhen(
        (((col("nation_name") == lit("BRAZIL")), col("volume")),),
        lit(0.0))
    agg = CpuAggregate(
        [col("o_year")],
        [Sum(brazil_vol).alias("brazil"), Sum(col("volume")).alias("all")],
        proj)
    share = CpuProject(
        [col("o_year"), (col("brazil") / col("all")).alias("mkt_share")],
        agg)
    return CpuSort([asc(col("o_year"))], share)


def q9(t, run):
    """Product type profit measure."""
    part = CpuFilter(Contains(col("p_name"), lit("green")), t["part"])
    joined = _join(
        J.INNER,
        _join(J.INNER,
              _join(J.INNER,
                    _join(J.INNER,
                          _join(J.INNER, part, t["lineitem"],
                                ["p_partkey"], ["l_partkey"]),
                          t["supplier"], ["l_suppkey"], ["s_suppkey"]),
                    t["partsupp"], ["l_suppkey", "l_partkey"],
                    ["ps_suppkey", "ps_partkey"]),
              t["orders"], ["l_orderkey"], ["o_orderkey"]),
        t["nation"], ["s_nationkey"], ["n_nationkey"])
    proj = CpuProject(
        [col("n_name").alias("nation"),
         _year_of(col("o_orderdate")).alias("o_year"),
         (col("l_extendedprice") * (lit(1.0) - col("l_discount")) -
          col("ps_supplycost") * col("l_quantity")).alias("amount")],
        joined)
    agg = CpuAggregate([col("nation"), col("o_year")],
                       [Sum(col("amount")).alias("sum_profit")], proj)
    return CpuSort([asc(col("nation")), desc(col("o_year"))], agg)


def q10(t, run):
    """Returned item reporting."""
    orders = CpuFilter(
        (col("o_orderdate") >= dlit("1993-10-01")) &
        (col("o_orderdate") < dlit("1994-01-01")), t["orders"])
    li = CpuFilter(col("l_returnflag") == lit("R"), t["lineitem"])
    joined = _join(
        J.INNER,
        _join(J.INNER,
              _join(J.INNER, t["customer"], orders,
                    ["c_custkey"], ["o_custkey"]),
              li, ["o_orderkey"], ["l_orderkey"]),
        t["nation"], ["c_nationkey"], ["n_nationkey"])
    agg = CpuAggregate(
        [col("c_custkey"), col("c_name"), col("c_acctbal"),
         col("c_phone"), col("n_name"), col("c_address"),
         col("c_comment")],
        [Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))
             ).alias("revenue")], joined)
    return CpuLimit(20, CpuSort([desc(col("revenue")),
                                 asc(col("c_custkey"))], agg))


QUERIES = {1: q1, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
           10: q10}
