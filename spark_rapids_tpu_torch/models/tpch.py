"""TPC-H Q1 (port of spark_rapids_tpu/models/tpch.py).

Q1 (pricing summary report):
  select returnflag, linestatus, sum(qty), sum(extprice),
         sum(extprice*(1-disc)), sum(extprice*(1-disc)*(1+tax)),
         avg(qty), avg(extprice), avg(disc), count(*)
  from lineitem where shipdate <= date '1998-09-02'
  group by returnflag, linestatus

Two entry points: `q1_plan` builds Q1 as an exec tree to `.collect()`;
`build_q1_fused_kernel` returns the stacked Q1 step, one call over many
batches laid back to back.
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.exprs.aggregates import (Average, CountStar,
                                                     Sum)
from spark_rapids_tpu_torch.exprs.base import col, lit

LINEITEM_SCHEMA = T.Schema.of(
    ("l_returnflag", T.INT32),      # dictionary-encoded flag (A/N/R -> 0/1/2)
    ("l_linestatus", T.INT32),      # O/F -> 0/1
    ("l_quantity", T.FLOAT32),
    ("l_extendedprice", T.FLOAT32),
    ("l_discount", T.FLOAT32),
    ("l_tax", T.FLOAT32),
    ("l_shipdate", T.DATE32),
)

Q1_CUTOFF_DAYS = 10471  # 1998-09-02 as days since epoch


def gen_lineitem_arrays(rng: np.random.Generator, rows: int) -> dict:
    """Synthetic lineitem columns in TPC-H value ranges (dbgen-shaped, not
    dbgen bit-exact), as numpy arrays.  The same rng state gives the same
    draws as spark_rapids_tpu's gen_lineitem."""
    return {
        "l_returnflag": rng.integers(0, 3, rows).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, rows).astype(np.int32),
        "l_quantity": rng.integers(1, 51, rows).astype(np.float32),
        "l_extendedprice": np.round(
            rng.uniform(900.0, 105000.0, rows), 2).astype(np.float32),
        "l_discount": np.round(
            rng.uniform(0.0, 0.10, rows), 2).astype(np.float32),
        "l_tax": np.round(
            rng.uniform(0.0, 0.08, rows), 2).astype(np.float32),
        "l_shipdate": rng.integers(8400, 10600, rows).astype(np.int32),
    }


def gen_lineitem(rng: np.random.Generator, rows: int,
                 capacity: int = None, device="cuda") -> ColumnarBatch:
    """One lineitem batch of `rows` rows on `device`."""
    return ColumnarBatch.from_numpy(gen_lineitem_arrays(rng, rows),
                                    LINEITEM_SCHEMA, capacity=capacity,
                                    device=device)


def q1_plan(source):
    """Q1 as a physical plan: Filter -> Project -> HashAggregate -> Sort."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.basic import FilterExec, ProjectExec
    from spark_rapids_tpu_torch.exec.sort import SortExec, asc
    filtered = FilterExec(
        col("l_shipdate") <= lit(Q1_CUTOFF_DAYS, T.DATE32), source)
    # lit(1.0) is a DOUBLE: the projections compute in float64, as Spark's
    projected = ProjectExec([
        col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
        col("l_extendedprice"), col("l_discount"),
        (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
         ).alias("disc_price"),
        (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
         * (lit(1.0) + col("l_tax"))).alias("charge"),
    ], filtered)
    agg = HashAggregateExec(
        [col("l_returnflag"), col("l_linestatus")],
        [Sum(col("l_quantity")).alias("sum_qty"),
         Sum(col("l_extendedprice")).alias("sum_base_price"),
         Sum(col("disc_price")).alias("sum_disc_price"),
         Sum(col("charge")).alias("sum_charge"),
         Average(col("l_quantity")).alias("avg_qty"),
         Average(col("l_extendedprice")).alias("avg_price"),
         Average(col("l_discount")).alias("avg_disc"),
         CountStar().alias("count_order")],
        projected)
    return SortExec([asc(col("l_returnflag")), asc(col("l_linestatus"))],
                    agg)


def _on_device(step, dev: torch.device):
    """Wrap a Q1 step so it refuses inputs that are not on `dev`."""
    def checked(*cols):
        for x in cols:
            if isinstance(x, torch.Tensor) and x.device.type != dev.type:
                raise ValueError(f"Q1 step built for {dev}, got an input "
                                 f"on {x.device}")
        return step(*cols)
    return checked


def build_q1_fused_kernel(capacity: int, batch_rows: int, device="cuda"):
    """STACKED Q1 step: one call aggregates capacity // batch_rows batches
    laid back to back (num_rows becomes a per-batch vector) and returns
    the (8, 6) float64 table of `ops.kernels.q1_fused`.  By default
    (spark.rapids.tpu.pallas.q1Fused.enabled) that is one q1_fused kernel
    launch; off, each batch runs the plain torch step."""
    dev = resolve_device(device)
    if C.get_active_conf()[C.PALLAS_Q1_FUSED_ENABLED]:
        from spark_rapids_tpu_torch.ops.kernels import q1_fused

        def step(flag, status, qty, extprice, disc, tax, shipdate, nums):
            return q1_fused(flag, status, qty, extprice, disc, tax,
                            shipdate, nums, capacity=capacity,
                            cutoff=Q1_CUTOFF_DAYS, batch_rows=batch_rows)
        return _on_device(step, dev)
    b = capacity // batch_rows
    base = build_q1_kernel(batch_rows, device=dev)

    def step(flag, status, qty, extprice, disc, tax, shipdate, nums):
        cols = [x.reshape(b, batch_rows)
                for x in (flag, status, qty, extprice, disc, tax,
                          shipdate)]
        outs = [base(*(c[i] for c in cols), nums[i]) for i in range(b)]
        return torch.stack(
            [sum(o[2 + j] for o in outs) for j in range(5)]
            + [sum(o[7] for o in outs).to(torch.float64)], dim=1)
    return _on_device(step, dev)


def q1_reference_pandas(df):
    """Golden CPU implementation for parity checks."""
    f = df[df["l_shipdate"] <= Q1_CUTOFF_DAYS].copy()
    f["disc_price"] = f["l_extendedprice"] * (1 - f["l_discount"])
    f["charge"] = f["disc_price"] * (1 + f["l_tax"])
    return f.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"),
    ).reset_index().sort_values(["l_returnflag", "l_linestatus"])


def build_q1_kernel(capacity: int, device="cuda"):
    """Q1 compute as ONE function over column tensors:
       fn(flag, status, qty, extprice, disc, tax, shipdate, num_rows)
         -> (flag8, status8, sums..., counts)
    over a fixed 8-slot group table (3 flags x 2 statuses padded to 8).
    Plain torch ops by default; with spark.rapids.tpu.pallas.q1.enabled
    the q1_fused kernel backs it instead (same contract)."""
    dev = resolve_device(device)
    if C.get_active_conf()[C.PALLAS_Q1_ENABLED]:
        from spark_rapids_tpu_torch.ops.kernels import build_q1_kernel_fused
        return _on_device(build_q1_kernel_fused(capacity, Q1_CUTOFF_DAYS),
                          dev)
    chunk = min(capacity, 65536)

    def q1_step(flag, status, qty, extprice, disc, tax, shipdate,
                num_rows):
        row_mask = torch.arange(capacity, device=flag.device) < num_rows
        keep = row_mask & (shipdate <= Q1_CUTOFF_DAYS)
        disc_price = extprice * (1.0 - disc)
        charge = disc_price * (1.0 + tax)
        gid = torch.where(keep, flag * 2 + status, 7)
        onehot = (gid[:, None] == torch.arange(8, device=flag.device)
                  ).to(torch.float32)
        # a select, not a multiply: NaN in a filtered row must not reach
        # the sums.  f32 products in 64K-row chunks, combined in float64
        vals = torch.where(
            keep[:, None],
            torch.stack([qty, extprice, disc_price, charge, disc,
                         torch.ones_like(qty)], dim=1), 0.0)
        table = torch.einsum(
            "cbm,cbg->cmg", vals.reshape(-1, chunk, 6),
            onehot.reshape(-1, chunk, 8)).to(torch.float64).sum(dim=0)
        g = torch.arange(8, device=flag.device)
        cnt = table[5].to(torch.int32)
        return (g // 2, g % 2, table[0], table[1], table[2], table[3],
                table[4], cnt)

    return _on_device(q1_step, dev)
