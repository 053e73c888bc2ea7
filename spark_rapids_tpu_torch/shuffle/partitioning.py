"""Partitioners (port of spark_rapids_tpu/shuffle/partitioning.py: hash,
round-robin, single and range partitioning).

Each partitioner computes a target partition id per row on the device,
then `_split` stably reorders the rows by partition id and cuts one
slice per partition, the analog of a murmur3 partition kernel followed
by cuDF's `Table.contiguousSplit`.  The split reads the per-partition
counts back to the host once per input batch and cuts tight slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches)
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    bucket_capacity)
from spark_rapids_tpu_torch.exec.base import make_eval_context
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.ops.murmur3 import partition_ids
from spark_rapids_tpu_torch.utils import checks as CK
from spark_rapids_tpu_torch.utils import kernelprof as KP


class TpuPartitioning:
    num_partitions: int

    def bind(self, schema: T.Schema) -> "TpuPartitioning":
        return self

    def partition_batch(self, batch: ColumnarBatch
                        ) -> list[Optional[ColumnarBatch]]:
        """Split a batch into num_partitions batches (None where a
        partition gets no rows)."""
        raise NotImplementedError


def _eval_ctx(batch: ColumnarBatch):
    return make_eval_context(batch.columns, batch.capacity,
                             batch.num_rows_i32, batch.sparse)


def _kp_watch(label: str, n: int, batch: ColumnarBatch):
    """The kernel-attribution entry of one partitioning step (the shared
    null context while attribution is off)."""
    if not KP.enabled():
        return KP.NULL_WATCH
    return KP.watch((("partitioning",), (label, n, batch.capacity)),
                    {"label": f"partition-{label}"}, batch.device)


def _split(batch: ColumnarBatch, pids: torch.Tensor, n: int
           ) -> list[Optional[ColumnarBatch]]:
    """Cut `batch` by per-row partition ids: live rows sorted stably by
    id (padding and filtered rows last), then one gather per partition
    at its tight bucketed capacity.  Works on sparse batches as they
    are: the row mask decides which rows are live.  The sort and the
    cut are the reference's two partitioning kernel-cache sites (kernel
    attribution keys them "split" and "cut")."""
    with _kp_watch("split", n, batch) as kw:
        pids = torch.where(batch.row_mask(), pids.to(torch.int64), n)
        order = torch.sort(pids, stable=True).indices
        counts_t = torch.bincount(pids, minlength=n + 1)[:n]
        if kw.wants_cost():
            kw.cost(pids, order, counts_t)
    CK.note_host_sync("partition.cut", nbytes=8 * n)
    counts = counts_t.cpu().tolist()
    out: list = []
    off = 0
    with _kp_watch("cut", n, batch) as kw:
        for cnt in counts:
            if cnt == 0:
                out.append(None)
                continue
            cap = bucket_capacity(cnt)
            i = torch.arange(cap, device=pids.device)
            valid = i < cnt
            idx = order[(i + off).clamp(max=order.shape[0] - 1)]
            out.append(ColumnarBatch(
                batch.schema, [c.gather(idx, valid) for c in batch.columns],
                cnt, batch.checks))
            off += cnt
        if kw.wants_cost():
            kw.cost(batch, out)
    return out


@dataclasses.dataclass
class HashPartitioning(TpuPartitioning):
    """murmur3(keys) pmod n: bit-identical to Spark's HashPartitioning."""
    exprs: Sequence[Expression]
    num_partitions: int

    def bind(self, schema):
        return HashPartitioning([e.bind(schema) for e in self.exprs],
                                self.num_partitions)

    def partition_batch(self, batch):
        ctx = _eval_ctx(batch)
        pids = partition_ids([e.eval(ctx) for e in self.exprs],
                             self.num_partitions)
        return _split(batch, pids, self.num_partitions)


@dataclasses.dataclass
class RoundRobinPartitioning(TpuPartitioning):
    """Row i of a batch goes to partition (i + start) mod n, the start
    drawn at random per batch (the user's repartition(n))."""
    num_partitions: int

    def partition_batch(self, batch):
        n = self.num_partitions
        start = np.random.randint(0, n)
        pids = torch.remainder(
            torch.arange(batch.capacity, device=batch.device) + start, n)
        return _split(batch, pids, n)


@dataclasses.dataclass
class SinglePartitioning(TpuPartitioning):
    num_partitions: int = 1

    def partition_batch(self, batch):
        return [batch]


@dataclasses.dataclass
class RangePartitioning(TpuPartitioning):
    """Sampled bounds plus a per-row compare against each bound: a row
    goes to the first partition whose upper bound it does not pass.
    `bounds` (num_partitions - 1 rows of the sort keys' input columns)
    come from `compute_bounds` over a sample of the child's rows."""
    order: Sequence  # list[SortOrder]
    num_partitions: int
    bounds: Optional[ColumnarBatch] = None

    def bind(self, schema):
        from spark_rapids_tpu_torch.exec.sort import SortOrder
        return RangePartitioning(
            [SortOrder(o.expr.bind(schema), o.ascending, o.nulls_first)
             for o in self.order], self.num_partitions, self.bounds)

    @staticmethod
    def compute_bounds(sample: ColumnarBatch, order, num_partitions: int
                       ) -> ColumnarBatch:
        """Sort the sample and take evenly spaced split points."""
        from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
        from spark_rapids_tpu_torch.exec.sort import SortExec
        srt = SortExec(order, LocalBatchSource(
            [[sample]], sample.schema, device=sample.device)).collect()
        n = srt.num_rows
        k = num_partitions - 1
        if n == 0 or k <= 0:
            return srt.slice(0, 0)
        idx = [min(n - 1, max(0, int(round((i + 1) * n / num_partitions))))
               for i in range(k)]
        return concat_batches([srt.slice(i, 1) for i in idx])

    def partition_batch(self, batch):
        if self.bounds is None:
            raise ValueError("RangePartitioning needs compute_bounds first")
        ctx = _eval_ctx(batch)
        keys = [o.expr.eval(ctx) for o in self.order]
        bctx = _eval_ctx(self.bounds)
        bcols = [o.expr.eval(bctx) for o in self.order]
        pid = torch.zeros(batch.capacity, dtype=torch.int32,
                          device=batch.device)
        for bi in range(self.bounds.num_rows):
            le = _row_less_than_bound(keys, bcols, bi, self.order)
            # a row past bound bi belongs at least to partition bi + 1
            pid = torch.where(le, pid, bi + 1)
        return _split(batch, pid, self.num_partitions)


def _row_less_than_bound(keys, bcols, bi: int, order) -> torch.Tensor:
    """row <= bound bi under the sort order, null ordering included."""
    from spark_rapids_tpu_torch.exprs.predicates import _compare
    cap = keys[0].capacity
    dev = keys[0].device
    lt_all = torch.zeros(cap, dtype=torch.bool, device=dev)
    eq_all = torch.ones(cap, dtype=torch.bool, device=dev)
    for key_col, o, bcol in zip(keys, order, bcols):
        bv = _broadcast_row(bcol, bi, cap)
        lt, eq = _compare(key_col, bv)
        if not o.ascending:
            lt = ~(lt | eq)
        knull, bnull = ~key_col.validity, ~bv.validity
        nf = o.resolved_nulls_first
        lt = torch.where(knull & ~bnull, nf, lt)
        lt = torch.where(~knull & bnull, not nf, lt)
        eqv = torch.where(knull | bnull, knull & bnull, eq)
        lt_all = lt_all | (eq_all & lt)
        eq_all = eq_all & eqv
    return lt_all | eq_all


def _broadcast_row(col: ColumnVector, row: int, cap: int) -> ColumnVector:
    return col._map(lambda x: x[row:row + 1].expand(
        (cap,) + tuple(x.shape[1:])))
