"""TPC-H at scale factor 10 on one card, and the query runner
(port of spark_rapids_tpu/models/tpch_bench.py `run_query`).

`run_query(n, tables)` runs TPC-H query n through the planner:
`collect(accelerate(QUERIES[n](sources(tables), run), conf), conf)`.

SF10 lineitem is 59,986,052 rows (TPC-H spec 4.2.5).  Two layouts of it
are made here from one seed:
  - `sf10_lineitem`: the seven Q1 columns, dictionary-coded, from
    `tpch.gen_lineitem_arrays`, in 8 batches of at most 7,498,257 rows
    at capacity 2^23, which keeps the dictionary lane open (capacity <
    2^24); the stacked Q1 step takes them back to back as capacity 2^26
    with batch_rows 2^23;
  - `sf10_lineitem_frame`: all 16 lineitem columns with
    `tpch_data.SCHEMAS` types, for the planner's Q1 and Q6.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.models import tpch, tpch_data

SF10_ROWS = 59_986_052
N_BATCHES = 8
BATCH_CAP = 1 << 23

#: how the reference runs its TPC suites (spark_rapids_tpu's
#: models/tpch_bench.py): order-sensitive float aggregation allowed
BENCH_CONF = {
    "spark.rapids.sql.variableFloatAgg.enabled": True,
    "spark.rapids.sql.incompatibleOps.enabled": True,
}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sf10_lineitem(seed: int, device) -> tuple[list, list, list]:
    """(rows per batch, numpy columns per batch, ColumnarBatch per batch
    on `device`) of SF10 lineitem from `seed`."""
    rng = np.random.default_rng(seed)
    per = -(-SF10_ROWS // N_BATCHES)
    sizes = [min(per, SF10_ROWS - i * per) for i in range(N_BATCHES)]
    arrays = [tpch.gen_lineitem_arrays(rng, n) for n in sizes]
    batches = [ColumnarBatch.from_numpy(a, tpch.LINEITEM_SCHEMA,
                                        capacity=BATCH_CAP, device=device)
               for a in arrays]
    return sizes, arrays, batches


def stacked_columns(batches, sizes, device) -> tuple[list, torch.Tensor]:
    """The batches' seven Q1 columns laid back to back (capacity
    N_BATCHES * BATCH_CAP) in LINEITEM_SCHEMA order, and the per-batch
    int32 row counts: the inputs of the stacked Q1 step."""
    stacked = [torch.cat([b.column(n).data for b in batches])
               for n in tpch.LINEITEM_SCHEMA.names]
    return stacked, torch.tensor(sizes, dtype=torch.int32, device=device)


def run_query(n: int, tables, device="cuda",
              conf: Optional[C.RapidsConf] = None, num_partitions: int = 2):
    """TPC-H query n over `tables` (name -> DataFrame) through the
    planner, on `device` (device="cuda" without a card raises), under
    BENCH_CONF unless `conf` is given."""
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = conf or C.RapidsConf(dict(BENCH_CONF))

    def run(plan):
        return collect(accelerate(plan, conf, device), conf)
    return run(QUERIES[n](tpch_data.sources(tables, num_partitions), run))


#: planner partitions of SF10 lineitem: 3,749,129 rows at most, so each
#: fits capacity 2^22 and the banded lane (BANDED_MAX_CAP = 2^22) opens
SF10_PARTITIONS = 16
#: dbgen's CURRENTDATE (TPC-H spec 4.2.3): it decides the return flag
#: and the line status
_CURRENT_DATE = tpch_data.days("1995-06-17")


def _categorical(options, codes) -> pd.Categorical:
    return pd.Categorical.from_codes(codes, categories=list(options))


def sf10_lineitem_frame(seed: int, rows: int = SF10_ROWS
                        ) -> tuple[pd.DataFrame, dict]:
    """(frame, numpy columns) of lineitem in dbgen's value ranges (TPC-H
    spec 4.2.3), drawn vectorized from `seed`: all 16 columns with
    `tpch_data.SCHEMAS` types.  Money columns are float64 rounded to
    cents and dates DATE32 days.  String columns are pandas Categoricals
    (dictionary-coded on the host, uploaded as bytes): the flags follow
    dbgen's rules from the dates, ship instruct and mode are uniform
    over their lists, and l_comment picks from `tpch_data._comment`'s
    word pool.  The numpy columns hold the flags as codes (returnflag
    A/N/R = 0/1/2, linestatus F/O = 0/1) for a golden."""
    rng = np.random.default_rng(seed)
    odate = rng.integers(tpch_data.days("1992-01-01"),
                         tpch_data.days("1998-08-02") + 1,
                         rows).astype(np.int32)
    ship = odate + rng.integers(1, 122, rows).astype(np.int32)
    commit = odate + rng.integers(30, 91, rows).astype(np.int32)
    receipt = ship + rng.integers(1, 31, rows).astype(np.int32)
    qty = rng.integers(1, 51, rows).astype(np.float64)
    price = np.round(qty * rng.uniform(900.0, 2099.0, rows), 2)
    late = receipt > _CURRENT_DATE
    flag = np.where(late, 1, np.where(rng.random(rows) < 0.5, 0, 2)
                    ).astype(np.int8)
    status = (ship > _CURRENT_DATE).astype(np.int8)
    colors = len(tpch_data.COLORS)
    pool = [f"{a} {b} requests" for a in tpch_data.COLORS
            for b in tpch_data.COLORS]
    arrays = {
        "l_orderkey": rng.integers(1, 60_000_001, rows, dtype=np.int64),
        "l_partkey": rng.integers(1, 2_000_001, rows, dtype=np.int64),
        "l_suppkey": rng.integers(1, 100_001, rows, dtype=np.int64),
        "l_linenumber": rng.integers(1, 8, rows).astype(np.int32),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": rng.integers(0, 11, rows) / 100.0,
        "l_tax": rng.integers(0, 9, rows) / 100.0,
        "l_returnflag": flag,
        "l_linestatus": status,
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
    }
    frame = pd.DataFrame({
        **{k: v for k, v in arrays.items()
           if k not in ("l_returnflag", "l_linestatus")},
        "l_returnflag": _categorical("ANR", flag),
        "l_linestatus": _categorical("FO", status),
        "l_shipinstruct": _categorical(
            tpch_data.INSTRUCTIONS,
            rng.integers(0, len(tpch_data.INSTRUCTIONS), rows)),
        "l_shipmode": _categorical(
            tpch_data.SHIP_MODES,
            rng.integers(0, len(tpch_data.SHIP_MODES), rows)),
        "l_comment": _categorical(
            pool, rng.integers(0, colors * colors, rows)),
    })[list(tpch_data.SCHEMAS["lineitem"].names)]
    return frame, arrays
