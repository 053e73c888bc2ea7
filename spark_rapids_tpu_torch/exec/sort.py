"""Sort operator (port of spark_rapids_tpu/exec/sort.py).

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
from spark_rapids_tpu_torch.exec.base import (CoalesceGoal,
                                              RequireSingleBatch, TpuExec,
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
