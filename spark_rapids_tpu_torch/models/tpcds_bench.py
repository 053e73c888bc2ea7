"""TPC-DS through the planner, and its SF1 and SF10 tables (the
counterpart of tpch_bench.py for all 103 queries of
`tpcds_queries.QUERIES`).

`run_query(name, tables)` is
`collect(accelerate(QUERIES[name](sources(tables, 2), run), conf), conf)`
under BENCH_CONF, on the card unless the caller passes device="cpu";
a query's scalar subqueries (q9's) collect through the same `run`.

`sf10_tables(seed)` is `tpcds_data.gen_tables` at SF10's store_sales row
count, 28,800,991, and `sf10_tables(seed, SF1_STORE_SALES)` at SF1's,
2,880,404 (TPC-DS specification v3, Table 3-2).  The generator
keeps its own shapes: its columns, its zipf item popularity, its
holiday and returns correlations, and its dimensions at its own ratios
to store_sales (items scale/20, customers scale/10, stores scale/2000,
inventory ~3.5x), which are not Table 3-2's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.models import tpcds_data
from spark_rapids_tpu_torch.models.tpch_bench import BENCH_CONF

#: store_sales rows at SF10 (TPC-DS specification v3, Table 3-2)
SF10_STORE_SALES = 28_800_991
#: store_sales rows at SF1 (the same table)
SF1_STORE_SALES = 2_880_404
#: planner partitions of the SF10 tables
SF10_PARTITIONS = 16


def run_query(name: str, tables: dict, device="cuda",
              conf: Optional[C.RapidsConf] = None,
              num_partitions: int = 2):
    """TPC-DS query `name` over `tables` (name -> DataFrame) through the
    planner on `device` (device="cuda" without a card raises), under
    BENCH_CONF unless `conf` is given."""
    from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = conf or C.RapidsConf(dict(BENCH_CONF))

    def run(plan):
        return collect(accelerate(plan, conf, device), conf)
    return run(QUERIES[name](tpcds_data.sources(tables, num_partitions),
                             run))


def sf10_tables(seed: int, scale: int = SF10_STORE_SALES) -> dict:
    """The generator's 24 tables at `scale` store_sales rows (SF10 by
    default) from `seed`."""
    return tpcds_data.gen_tables(np.random.default_rng(seed), scale)
