"""All 22 TPC-H queries as CPU plan trees (port of
spark_rapids_tpu/models/tpch_queries.py).

Each query is `qN(t, run) -> CpuNode`: `t` maps table name -> a fresh
source plan; `run(plan) -> DataFrame` executes a sub-plan on the engine
under test (the scalar subqueries of Q11, Q15 and Q22, each computed
before the outer query, as Spark computes a scalar).  Correlated
subqueries are decorrelated the way Catalyst does it: as
aggregate-then-join (Q2, Q17, Q20) or as semi and anti joins (Q4, Q16,
Q18, Q21, Q22).  Dates are DATE32 day literals via `tpch_data.days`.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.exprs.aggregates import (Average, Count, Max,
                                                     Min, Sum)
from spark_rapids_tpu_torch.exprs.base import Literal, col, lit
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
from spark_rapids_tpu_torch.exprs.datetime_exprs import Year
from spark_rapids_tpu_torch.exprs.predicates import InSet, Not
from spark_rapids_tpu_torch.exprs.string_fns import (Contains, Like,
                                                     StartsWith, Substring)
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


def q2(t, run):
    """Minimum cost supplier (correlated min decorrelated as agg-join)."""
    eu_supp = _join(J.INNER,
                    _join(J.INNER, t["supplier"],
                          _join(J.INNER, t["nation"],
                                CpuFilter(col("r_name") == lit("EUROPE"),
                                          t["region"]),
                                ["n_regionkey"], ["r_regionkey"]),
                          ["s_nationkey"], ["n_nationkey"]),
                    t["partsupp"], ["s_suppkey"], ["ps_suppkey"])
    min_cost = CpuProject(
        [col("ps_partkey").alias("mc_key"), col("min_cost")],
        CpuAggregate(
            [col("ps_partkey")],
            [Min(col("ps_supplycost")).alias("min_cost")],
            _cols(eu_supp, "ps_partkey", "ps_supplycost")))
    part = CpuFilter((col("p_size") == lit(15)) &
                     Like(col("p_type"), lit("%BRASS")), t["part"])
    joined = _join(J.INNER, _join(J.INNER, eu_supp, part,
                                  ["ps_partkey"], ["p_partkey"]),
                   min_cost, ["ps_partkey"], ["mc_key"],
                   condition=(col("ps_supplycost") == col("min_cost")))
    out = CpuProject([col("s_acctbal"), col("s_name"), col("n_name"),
                      col("p_partkey"), col("p_mfgr"), col("s_address"),
                      col("s_phone"), col("s_comment")], joined)
    return CpuLimit(100, CpuSort(
        [desc(col("s_acctbal")), asc(col("n_name")), asc(col("s_name")),
         asc(col("p_partkey"))], out))


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


def q11(t, run):
    """Important stock identification (HAVING scalar via run())."""
    de = CpuFilter(col("n_name") == lit("GERMANY"), t["nation"])
    base = _join(J.INNER,
                 _join(J.INNER, t["partsupp"], t["supplier"],
                       ["ps_suppkey"], ["s_suppkey"]),
                 de, ["s_nationkey"], ["n_nationkey"])
    value = col("ps_supplycost") * col("ps_availqty")
    total = run(CpuAggregate([], [Sum(value).alias("total")], base))
    v = total["total"].iloc[0]
    threshold = 0.0 if v is None or v != v else float(v) * 0.0001
    agg = CpuAggregate([col("ps_partkey")],
                       [Sum(value).alias("value")], base)
    return CpuSort([desc(col("value"))],
                   CpuFilter(col("value") > lit(threshold), agg))


def q12(t, run):
    """Shipping modes and order priority."""
    li = CpuFilter(
        InSet(col("l_shipmode"), ("MAIL", "SHIP")) &
        (col("l_commitdate") < col("l_receiptdate")) &
        (col("l_shipdate") < col("l_commitdate")) &
        (col("l_receiptdate") >= dlit("1994-01-01")) &
        (col("l_receiptdate") < dlit("1995-01-01")), t["lineitem"])
    joined = _join(J.INNER, t["orders"], li,
                   ["o_orderkey"], ["l_orderkey"])
    urgent = InSet(col("o_orderpriority"), ("1-URGENT", "2-HIGH"))
    agg = CpuAggregate(
        [col("l_shipmode")],
        [Sum(CaseWhen(((urgent, lit(1)),), lit(0))).alias("high_line"),
         Sum(CaseWhen(((urgent, lit(0)),), lit(1))).alias("low_line")],
        joined)
    return CpuSort([asc(col("l_shipmode"))], agg)


def q13(t, run):
    """Customer distribution (left outer join + double aggregate)."""
    orders = CpuFilter(
        Not(Like(col("o_comment"), lit("%special%requests%"))), t["orders"])
    joined = _join(J.LEFT_OUTER, t["customer"], orders,
                   ["c_custkey"], ["o_custkey"])
    per_cust = CpuAggregate([col("c_custkey")],
                            [Count(col("o_orderkey")).alias("c_count")],
                            _cols(joined, "c_custkey", "o_orderkey"))
    dist = CpuAggregate([col("c_count")],
                        [Count(None).alias("custdist")], per_cust)
    return CpuSort([desc(col("custdist")), desc(col("c_count"))], dist)


def q14(t, run):
    """Promotion effect."""
    li = CpuFilter(
        (col("l_shipdate") >= dlit("1995-09-01")) &
        (col("l_shipdate") < dlit("1995-10-01")), t["lineitem"])
    joined = _join(J.INNER, li, t["part"], ["l_partkey"], ["p_partkey"])
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    promo = CaseWhen(
        ((StartsWith(col("p_type"), lit("PROMO")), rev),), lit(0.0))
    agg = CpuAggregate(
        [], [Sum(promo).alias("promo"), Sum(rev).alias("total")], joined)
    return CpuProject(
        [(lit(100.0) * col("promo") / col("total"))
         .alias("promo_revenue")], agg)


def _q15_revenue(t):
    li = CpuFilter(
        (col("l_shipdate") >= dlit("1996-01-01")) &
        (col("l_shipdate") < dlit("1996-04-01")), t["lineitem"])
    return CpuAggregate(
        [col("l_suppkey")],
        [Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))
             ).alias("total_revenue")], li)


def q15(t, run):
    """Top supplier (max over a revenue view via run())."""
    revenue = _q15_revenue(t)
    max_rev = float(run(CpuAggregate(
        [], [Max(col("total_revenue")).alias("m")],
        _q15_revenue(t)))["m"].iloc[0])
    top = CpuFilter(col("total_revenue") >= lit(max_rev), revenue)
    joined = _join(J.INNER, t["supplier"], top,
                   ["s_suppkey"], ["l_suppkey"])
    out = CpuProject([col("s_suppkey"), col("s_name"), col("s_address"),
                      col("s_phone"), col("total_revenue")], joined)
    return CpuSort([asc(col("s_suppkey"))], out)


def q16(t, run):
    """Parts/supplier relationship (NOT IN -> anti join; count distinct
    via two-level aggregate)."""
    bad_supp = CpuFilter(
        Like(col("s_comment"), lit("%Customer%Complaints%")),
        t["supplier"])
    ps = _join(J.LEFT_ANTI, t["partsupp"], bad_supp,
               ["ps_suppkey"], ["s_suppkey"])
    part = CpuFilter(
        (col("p_brand") != lit("Brand#45")) &
        Not(Like(col("p_type"), lit("MEDIUM POLISHED%"))) &
        InSet(col("p_size"), (49, 14, 23, 45, 19, 3, 36, 9)), t["part"])
    joined = _join(J.INNER, part, ps, ["p_partkey"], ["ps_partkey"])
    distinct = CpuAggregate(
        [col("p_brand"), col("p_type"), col("p_size"),
         col("ps_suppkey")], [Count(None).alias("_dup")], joined)
    agg = CpuAggregate(
        [col("p_brand"), col("p_type"), col("p_size")],
        [Count(col("ps_suppkey")).alias("supplier_cnt")], distinct)
    return CpuSort([desc(col("supplier_cnt")), asc(col("p_brand")),
                    asc(col("p_type")), asc(col("p_size"))], agg)


def q17(t, run):
    """Small-quantity-order revenue (correlated avg via agg-join)."""
    part = CpuFilter(
        (col("p_brand") == lit("Brand#23")) &
        (col("p_container") == lit("MED BOX")), t["part"])
    li_part = _join(J.INNER, t["lineitem"], part,
                    ["l_partkey"], ["p_partkey"])
    avg_qty = CpuAggregate(
        [col("ap_key")],
        [Average(col("l_quantity")).alias("avg_qty")],
        CpuProject([col("l_partkey").alias("ap_key"),
                    col("l_quantity")],
                   _join(J.INNER, t["lineitem"], part,
                         ["l_partkey"], ["p_partkey"])))
    joined = _join(J.INNER, li_part, avg_qty, ["l_partkey"], ["ap_key"],
                   condition=(col("l_quantity") <
                              lit(0.2) * col("avg_qty")))
    agg = CpuAggregate(
        [], [Sum(col("l_extendedprice")).alias("s")], joined)
    return CpuProject([(col("s") / lit(7.0)).alias("avg_yearly")], agg)


def q18(t, run):
    """Large volume customers.  Threshold lowered 300 -> 150 so the
    synthetic ~4-lines-per-order data produces qualifying orders."""
    big = CpuFilter(
        col("sum_qty") > lit(150.0),
        CpuAggregate([col("big_key")],
                     [Sum(col("l_quantity")).alias("sum_qty")],
                     CpuProject([col("l_orderkey").alias("big_key"),
                                 col("l_quantity")], t["lineitem"])))
    orders = _join(J.LEFT_SEMI, t["orders"], big,
                   ["o_orderkey"], ["big_key"])
    joined = _join(J.INNER,
                   _join(J.INNER, t["customer"], orders,
                         ["c_custkey"], ["o_custkey"]),
                   t["lineitem"], ["o_orderkey"], ["l_orderkey"])
    agg = CpuAggregate(
        [col("c_name"), col("c_custkey"), col("o_orderkey"),
         col("o_orderdate"), col("o_totalprice")],
        [Sum(col("l_quantity")).alias("sum_qty")], joined)
    return CpuLimit(100, CpuSort(
        [desc(col("o_totalprice")), asc(col("o_orderdate")),
         asc(col("o_orderkey"))], agg))


def q19(t, run):
    """Discounted revenue: OR of three brand/container/quantity brackets."""
    joined = _join(J.INNER, t["lineitem"], t["part"],
                   ["l_partkey"], ["p_partkey"])
    sm = (col("p_brand") == lit("Brand#12")) & \
        InSet(col("p_container"), ("SM CASE", "SM BOX", "SM PACK",
                                   "SM PKG")) & \
        (col("l_quantity") >= lit(1.0)) & \
        (col("l_quantity") <= lit(11.0)) & (col("p_size") <= lit(5))
    med = (col("p_brand") == lit("Brand#23")) & \
        InSet(col("p_container"), ("MED BAG", "MED BOX", "MED PKG",
                                   "MED PACK")) & \
        (col("l_quantity") >= lit(10.0)) & \
        (col("l_quantity") <= lit(20.0)) & (col("p_size") <= lit(10))
    lg = (col("p_brand") == lit("Brand#34")) & \
        InSet(col("p_container"), ("LG CASE", "LG BOX", "LG PACK",
                                   "LG PKG")) & \
        (col("l_quantity") >= lit(20.0)) & \
        (col("l_quantity") <= lit(30.0)) & (col("p_size") <= lit(15))
    common = (col("p_size") >= lit(1)) & \
        InSet(col("l_shipmode"), ("AIR", "REG AIR")) & \
        (col("l_shipinstruct") == lit("DELIVER IN PERSON"))
    filt = CpuFilter(common & (sm | med | lg), joined)
    return CpuAggregate(
        [], [Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))
                 ).alias("revenue")], filt)


def q20(t, run):
    """Potential part promotion (nested IN -> semi joins + agg-join)."""
    forest = CpuFilter(StartsWith(col("p_name"), lit("forest")),
                       t["part"])
    shipped = CpuAggregate(
        [col("sk_part"), col("sk_supp")],
        [Sum(col("l_quantity")).alias("qty")],
        CpuProject([col("l_partkey").alias("sk_part"),
                    col("l_suppkey").alias("sk_supp"),
                    col("l_quantity")],
                   CpuFilter(
                       (col("l_shipdate") >= dlit("1994-01-01")) &
                       (col("l_shipdate") < dlit("1995-01-01")),
                       t["lineitem"])))
    ps = _join(J.LEFT_SEMI, t["partsupp"], forest,
               ["ps_partkey"], ["p_partkey"])
    qualified = CpuFilter(
        col("ps_availqty").cast(T.FLOAT64) > lit(0.5) * col("qty"),
        _join(J.INNER, ps, shipped, ["ps_partkey", "ps_suppkey"],
              ["sk_part", "sk_supp"]))
    supp = _join(J.LEFT_SEMI, t["supplier"], qualified,
                 ["s_suppkey"], ["ps_suppkey"])
    canada = CpuFilter(col("n_name") == lit("CANADA"), t["nation"])
    out = _join(J.INNER, supp, canada, ["s_nationkey"], ["n_nationkey"])
    return CpuSort([asc(col("s_name"))],
                   _cols(out, "s_name", "s_address"))


def q21(t, run):
    """Suppliers who kept orders waiting (EXISTS/NOT EXISTS with
    inequality -> semi/anti joins with conditions)."""
    sa = CpuFilter(col("n_name") == lit("SAUDI ARABIA"), t["nation"])
    late = CpuFilter(col("l_receiptdate") > col("l_commitdate"),
                     t["lineitem"])
    f_orders = CpuFilter(col("o_orderstatus") == lit("F"), t["orders"])
    l1 = _join(J.INNER,
               _join(J.INNER,
                     _join(J.INNER, t["supplier"], sa,
                           ["s_nationkey"], ["n_nationkey"]),
                     late, ["s_suppkey"], ["l_suppkey"]),
               f_orders, ["l_orderkey"], ["o_orderkey"])
    l2 = _rename(t["lineitem"], {"l_orderkey": "l2_order",
                                 "l_suppkey": "l2_supp"})
    l3 = _rename(late, {"l_orderkey": "l3_order",
                        "l_suppkey": "l3_supp"})
    with_other = _join(J.LEFT_SEMI, l1, l2, ["l_orderkey"], ["l2_order"],
                       condition=(col("l_suppkey") != col("l2_supp")))
    no_other_late = _join(J.LEFT_ANTI, with_other, l3,
                          ["l_orderkey"], ["l3_order"],
                          condition=(col("l_suppkey") != col("l3_supp")))
    agg = CpuAggregate([col("s_name")],
                       [Count(None).alias("numwait")], no_other_late)
    return CpuLimit(100, CpuSort(
        [desc(col("numwait")), asc(col("s_name"))], agg))


def q22(t, run):
    """Global sales opportunity (scalar avg via run(), NOT EXISTS ->
    anti join)."""
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cntry = Substring(col("c_phone"), lit(1), lit(2))
    cust = CpuFilter(InSet(cntry, codes), t["customer"])
    avg_bal = float(run(CpuAggregate(
        [], [Average(col("c_acctbal")).alias("a")],
        CpuFilter(InSet(cntry, codes) & (col("c_acctbal") > lit(0.0)),
                  t["customer"])))["a"].iloc[0])
    rich = CpuFilter(col("c_acctbal") > lit(avg_bal), cust)
    no_orders = _join(J.LEFT_ANTI, rich, t["orders"],
                      ["c_custkey"], ["o_custkey"])
    proj = CpuProject(
        [Substring(col("c_phone"), lit(1), lit(2)).alias("cntrycode"),
         col("c_acctbal")], no_orders)
    agg = CpuAggregate(
        [col("cntrycode")],
        [Count(None).alias("numcust"),
         Sum(col("c_acctbal")).alias("totacctbal")], proj)
    return CpuSort([asc(col("cntrycode"))], agg)


QUERIES = {i: fn for i, fn in enumerate(
    [q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15,
     q16, q17, q18, q19, q20, q21, q22], start=1)}
