"""TPC-H queries as CPU plan trees (port of
spark_rapids_tpu/models/tpch_queries.py, cut to Q1 and Q6).

Each query is `qN(t, run) -> CpuNode`: `t` maps table name -> a fresh
source plan; `run(plan) -> DataFrame` executes a sub-plan on the engine
under test (for scalar subqueries; Q1 and Q6 have none).  Dates are
DATE32 day literals via `tpch_data.days`.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import asc
from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.exprs.base import Literal, col, lit
from spark_rapids_tpu_torch.models.tpch_data import days
from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuFilter,
                                               CpuSort)


def dlit(s: str) -> Literal:
    """DATE32 literal from 'YYYY-MM-DD'."""
    return Literal(days(s), T.DATE32)


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


QUERIES = {1: q1, 6: q6}
