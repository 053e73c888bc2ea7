"""TPC-H Q1 at scale factor 10 on one card: the data, layout and conf that
chip_smoke.py and scripts/profile_torch_q1.py share.

SF10 lineitem is 59,986,052 rows (TPC-H spec 4.2.5), made by
`tpch.gen_lineitem_arrays` from one seed and split into 8 batches of at
most 7,498,257 rows at capacity 2^23, which keeps the dictionary lane open
(capacity < 2^24).  The stacked Q1 step takes the same 8 batches back to
back as capacity 2^26 with batch_rows 2^23.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.models import tpch

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
