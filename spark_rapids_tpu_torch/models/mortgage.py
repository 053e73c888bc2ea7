"""Mortgage ETL workload (port of spark_rapids_tpu/models/mortgage.py;
reference `integration_tests/src/main/scala/.../mortgage/Mortgage.scala`:
Fannie-Mae performance + acquisition CSV ETL — parse, clean, join,
aggregate into delinquency features).

Shape preserved: two raw tables (perf: loan monthly records; acq: loan
originations), per-loan delinquency aggregation, join back to
originations, feature projection.  Data is generated in-memory in the
same value ranges, the reference's frames from the same seed.
`run_plan(plan_fn, tables)` runs `etl_plan` or `summary_plan` through
the planner, on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import asc
from spark_rapids_tpu_torch.exprs.aggregates import Count, Max, Min, Sum
from spark_rapids_tpu_torch.exprs.base import col, lit
from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
from spark_rapids_tpu_torch.models.data_util import make_sources
from spark_rapids_tpu_torch.models.tpch_bench import BENCH_CONF
from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuHashJoin,
                                               CpuProject, CpuSort)

PERF_SCHEMA = T.Schema.of(
    ("loan_id", T.INT64), ("monthly_reporting_period", T.INT32),
    ("current_actual_upb", T.FLOAT64), ("loan_age", T.FLOAT64),
    ("current_loan_delinquency_status", T.INT32),
    ("interest_rate", T.FLOAT64))

ACQ_SCHEMA = T.Schema.of(
    ("loan_id", T.INT64), ("orig_channel", T.STRING),
    ("seller_name", T.STRING), ("orig_interest_rate", T.FLOAT64),
    ("orig_upb", T.INT64), ("orig_loan_term", T.INT32),
    ("orig_ltv", T.FLOAT64), ("orig_cltv", T.FLOAT64),
    ("num_borrowers", T.FLOAT64), ("dti", T.FLOAT64),
    ("borrower_credit_score", T.FLOAT64))

CHANNELS = ["R", "C", "B"]
SELLERS = ["BANK OF AMERICA", "WELLS FARGO", "JPMORGAN", "CITI",
           "QUICKEN", "OTHER"]


def gen_tables(rng: np.random.Generator, loans: int = 1000,
               months: int = 24) -> dict[str, pd.DataFrame]:
    n_perf = loans * months
    loan_ids = np.repeat(np.arange(loans, dtype=np.int64), months)
    period = np.tile(np.arange(months, dtype=np.int32), loans)
    delinq = rng.choice([0, 0, 0, 0, 0, 1, 1, 2, 3, 6],
                        size=n_perf).astype(np.int32)
    perf = pd.DataFrame({
        "loan_id": loan_ids,
        "monthly_reporting_period": period,
        "current_actual_upb": np.round(
            rng.uniform(10_000, 800_000, n_perf), 2),
        "loan_age": period.astype(np.float64),
        "current_loan_delinquency_status": delinq,
        "interest_rate": np.round(rng.uniform(2.5, 7.5, n_perf), 3),
    })
    acq = pd.DataFrame({
        "loan_id": np.arange(loans, dtype=np.int64),
        "orig_channel": np.array(CHANNELS, dtype=object)[
            rng.integers(0, len(CHANNELS), loans)],
        "seller_name": np.array(SELLERS, dtype=object)[
            rng.integers(0, len(SELLERS), loans)],
        "orig_interest_rate": np.round(rng.uniform(2.5, 7.5, loans), 3),
        "orig_upb": rng.integers(10_000, 800_000, loans).astype(
            np.int64),
        "orig_loan_term": rng.choice([180, 240, 360],
                                     loans).astype(np.int32),
        "orig_ltv": np.round(rng.uniform(40, 97, loans), 1),
        "orig_cltv": np.round(rng.uniform(40, 99, loans), 1),
        "num_borrowers": rng.choice([1.0, 2.0], loans),
        "dti": np.round(rng.uniform(10, 50, loans), 1),
        "borrower_credit_score": rng.integers(
            550, 830, loans).astype(np.float64),
    })
    return {"perf": perf, "acq": acq}


def sources(tables, num_partitions: int = 1):
    return make_sources(tables, {"perf": PERF_SCHEMA,
                                 "acq": ACQ_SCHEMA}, num_partitions)


def etl_plan(t):
    """The mortgage feature pipeline as one plan tree (reference
    Mortgage.scala `createDelinquency` + final feature join)."""
    ever = CpuAggregate(
        [col("loan_id")],
        [Max(col("current_loan_delinquency_status")).alias("ever_delinq"),
         Min(col("current_actual_upb")).alias("min_upb"),
         Sum(CaseWhen(
             (((col("current_loan_delinquency_status") >= lit(1)),
               lit(1)),), lit(0))).alias("delinq_months"),
         Count(None).alias("reporting_months")],
        CpuProject([col("loan_id"),
                    col("current_loan_delinquency_status"),
                    col("current_actual_upb")], t["perf"]))
    j = CpuHashJoin(JoinType.INNER, [col("loan_id")], [col("loan_id_a")],
                    ever,
                    CpuProject(
                        [col("loan_id").alias("loan_id_a"),
                         col("orig_channel"), col("seller_name"),
                         col("orig_interest_rate"), col("orig_upb"),
                         col("orig_ltv"), col("dti"),
                         col("borrower_credit_score")], t["acq"]))
    features = CpuProject(
        [col("loan_id"), col("orig_channel"), col("seller_name"),
         col("orig_interest_rate"), col("orig_upb"),
         col("orig_ltv"), col("dti"), col("borrower_credit_score"),
         col("ever_delinq"), col("delinq_months"),
         col("reporting_months"), col("min_upb"),
         CaseWhen((((col("ever_delinq") >= lit(1)), lit(1)),),
                  lit(0)).alias("delinquency_12")], j)
    return CpuSort([asc(col("loan_id"))], features)


def summary_plan(t):
    """Post-ETL report: delinquency rate by channel and seller."""
    features = etl_plan(t)
    agg = CpuAggregate(
        [col("orig_channel"), col("seller_name")],
        [Count(None).alias("loans"),
         Sum(col("delinquency_12")).alias("delinquent")], features)
    return CpuSort([asc(col("orig_channel")), asc(col("seller_name"))],
                   agg)


def run_plan(plan_fn, tables: dict, device="cuda",
             conf: Optional[C.RapidsConf] = None,
             num_partitions: int = 2):
    """`plan_fn` (etl_plan or summary_plan) over `tables` (gen_tables'
    frames) through the planner on `device` (device="cuda" without a
    card raises), under BENCH_CONF unless `conf` is given."""
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = conf or C.RapidsConf(dict(BENCH_CONF))
    plan = plan_fn(sources(tables, num_partitions))
    return collect(accelerate(plan, conf, device), conf)
