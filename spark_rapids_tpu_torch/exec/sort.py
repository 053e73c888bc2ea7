"""Sort operators (port of spark_rapids_tpu/exec/sort.py: SortExec and
SortedTopNExec).

A global sort is one output partition: every child batch, partition by
partition, is concatenated into one, which is sorted by its encoded keys
and gathered.  Over a range exchange the partitions arrive in key order,
so the result is totally ordered.  A local sort sorts each partition on
its own.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches)
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import (CoalesceGoal,
                                              RequireSingleBatch,
                                              SchemaOnlyExec, TpuExec,
                                              UnaryExecBase,
                                              make_eval_context)
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.ops.sort_encode import multi_key_argsort


@dataclasses.dataclass(frozen=True)
class SortOrder:
    """Spark SortOrder: ascending -> nulls first, descending -> nulls
    last, unless given."""
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None

    @property
    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first


def asc(e: Expression) -> SortOrder:
    return SortOrder(e, True)


def desc(e: Expression) -> SortOrder:
    return SortOrder(e, False)


class SortExec(UnaryExecBase):
    def __init__(self, order: Sequence[SortOrder], child: TpuExec,
                 global_sort: bool = True):
        super().__init__(child)
        self.order = list(order)
        self.global_sort = global_sort
        self._schema = child.output_schema()
        self._bound = [o.expr.bind(self._schema) for o in self.order]

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        dirs = ",".join(f"{o.expr!r} {'ASC' if o.ascending else 'DESC'}"
                        for o in self.order)
        return f"SortExec({dirs}, global={self.global_sort})"

    def children_coalesce_goal(self) -> list[Optional[CoalesceGoal]]:
        return [RequireSingleBatch() if self.global_sort else None]

    def output_partition_count(self) -> int:
        if not self.global_sort:
            return self.child.output_partition_count()
        return 1

    def execute_partitions(self):
        if not self.global_sort:
            return super().execute_partitions()

        def chain():
            for it in self.child.execute_partitions():
                yield from it
        return [self.process_partition(chain())]

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        batches = list(batches)
        if not batches:
            return
        yield self._sort_one(concat_batches(batches, sparse_ok=True))

    def _sort_one(self, batch: ColumnarBatch) -> ColumnarBatch:
        cap = batch.capacity
        ctx = make_eval_context(batch.columns, cap, batch.num_rows_i32,
                                batch.sparse)
        keys = [e.eval(ctx) for e in self._bound]
        perm = multi_key_argsort(
            [(k, o.ascending, o.resolved_nulls_first)
             for k, o in zip(keys, self.order)], ctx.row_mask)
        # selected rows sort FIRST, so a sparse input compacts for free
        valid = torch.arange(cap, device=batch.device) < batch.num_rows_i32
        return ColumnarBatch(self._schema,
                             [c.gather(perm, valid) for c in batch.columns],
                             batch._rows, batch.checks)


class SortedTopNExec(TpuExec):
    """ORDER BY + LIMIT n (Spark's TakeOrderedAndProject): each batch is
    pruned to its n best rows, and the merged candidates are sorted again
    exactly and cut to n.  One output partition."""

    #: the single-key top-k branch serves up to this many rows
    TOPK_MAX_N = 128

    def __init__(self, n: int, order: Sequence[SortOrder], child: TpuExec):
        super().__init__(child)
        self.n = n
        self.order = list(order)
        self._schema = child.output_schema()
        self._sorter = SortExec(self.order, SchemaOnlyExec(self._schema),
                                global_sort=False)

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        return f"SortedTopNExec({self.n})"

    def output_partition_count(self) -> int:
        return 1

    def execute_partitions(self):
        return [self.execute_columnar()]

    def _topk_applicable(self) -> bool:
        if len(self.order) != 1 or self.n > self.TOPK_MAX_N:
            return False
        return not self._sorter._bound[0].data_type(self._schema).is_string

    def _prune_one(self, batch: ColumnarBatch) -> ColumnarBatch:
        if not self._topk_applicable():
            return self._sorter._sort_one(batch).take_head(self.n)
        return self._topk(batch)

    def _topk(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The n best rows of a batch by one numeric key, through
        torch.topk over an exact float64 score: ascending order negates
        the value, NaN (largest in Spark) and nulls take sentinels past
        every value, and rows outside the batch score -inf.  Values the
        sentinels or float64 cannot hold exactly (NaN-adjacent
        magnitudes, integers past 2^53) take the sort instead.  Tied
        candidates keep their row order, and the merge re-sorts them
        exactly."""
        o = self.order[0]
        cap = batch.capacity
        ctx = make_eval_context(batch.columns, cap, batch.num_rows_i32,
                                batch.sparse)
        k = self._sorter._bound[0].eval(ctx)
        dt = k.dtype
        d = k.data.to(torch.float64)
        valid = k.validity & ctx.row_mask
        kk = min(self.n, cap)
        if dt.is_floating:
            special = valid & (torch.isnan(d) | (d.abs() >= 1e290))
        else:
            special = valid & (d.abs() >= float(2 ** 53))
        big, nbig = 4e300, 2e300
        if bool(special.any()):
            idx = multi_key_argsort([(k, o.ascending,
                                      o.resolved_nulls_first)],
                                    ctx.row_mask)[:kk]
        else:
            score = -d if o.ascending else d
            if dt.is_floating:
                score = torch.where(torch.isnan(d),
                                    -nbig if o.ascending else nbig, score)
            score = torch.where(k.validity, score,
                                big if o.resolved_nulls_first else -big)
            score = torch.where(ctx.row_mask, score, float("-inf"))
            cand = torch.topk(score, kk).indices.sort().values
            idx = cand[torch.sort(score[cand], descending=True,
                                  stable=True).indices]
        count = torch.clamp(batch.num_rows_i32, max=kk)
        out_cap = bucket_capacity(kk)
        pad = torch.zeros(out_cap, dtype=torch.int64, device=batch.device)
        pad[:kk] = idx
        valid_out = torch.arange(out_cap, device=batch.device) < count
        return ColumnarBatch(self._schema,
                             [c.gather(pad, valid_out)
                              for c in batch.columns], count, batch.checks)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        pruned = []
        for part in self.child.execute_partitions():
            for batch in part:
                top = self._prune_one(batch)
                if top.maybe_nonempty():
                    pruned.append(top)
        if not pruned:
            return
        yield self._sorter._sort_one(concat_batches(pruned)).take_head(
            self.n)
