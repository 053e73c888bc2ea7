"""Basic physical operators: Project, Filter, LocalBatchSource (port of
spark_rapids_tpu/exec/basic.py).

Filter defers compaction: its output is a SPARSE batch whose mask selects
the kept rows, and sparse-aware consumers (project, aggregate, sort) fold
the mask into their own row masking.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.exec.base import (TpuExec, UnaryExecBase,
                                              bind_exprs, make_eval_context)
from spark_rapids_tpu_torch.exprs.base import (EvalContext, Expression,
                                               output_name)


def _register_ansi(ctx: EvalContext) -> tuple:
    """The ANSI expression checks an evaluation raised (`ctx.
    pending_checks`), registered as fatal deferred checks."""
    from spark_rapids_tpu_torch.utils import checks as CK
    return tuple(
        CK.register(CK.BatchCheck(
            flag, label,
            error=lambda label=label: ArithmeticError(
                f"{label} (spark.sql.ansi.enabled semantics)")))
        for label, flag in ctx.pending_checks)


class ProjectExec(UnaryExecBase):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        self.exprs = list(exprs)
        child_schema = child.output_schema()
        self._bound = bind_exprs(self.exprs, child_schema)
        self._schema = T.Schema(tuple(
            T.Field(output_name(e, i), b.data_type(child_schema))
            for i, (e, b) in enumerate(zip(self.exprs, self._bound))))

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        return f"ProjectExec({', '.join(map(repr, self.exprs))})"

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        for batch in batches:
            ctx = make_eval_context(batch.columns, batch.capacity,
                                    batch.num_rows_i32, batch.sparse)
            out_cols = [e.eval(ctx) for e in self._bound]
            yield ColumnarBatch(self._schema, out_cols, batch._rows,
                                batch.checks + _register_ansi(ctx),
                                batch.sparse)


class FilterExec(UnaryExecBase):
    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child)
        self.condition = condition
        self._bound = condition.bind(child.output_schema())
        self._schema = child.output_schema()

    def output_schema(self) -> T.Schema:
        return self._schema

    @property
    def coalesce_after(self) -> bool:
        return True  # filtering shrinks batches

    def describe(self):
        return f"FilterExec({self.condition!r})"

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        for batch in batches:
            ctx = make_eval_context(batch.columns, batch.capacity,
                                    batch.num_rows_i32, batch.sparse)
            pred = self._bound.eval(ctx)
            keep = pred.validity & pred.data.to(torch.bool) & ctx.row_mask
            yield ColumnarBatch(self._schema, batch.columns,
                                keep.sum().to(torch.int32),
                                batch.checks + _register_ansi(ctx),
                                sparse=keep)


class LocalBatchSource(TpuExec):
    """Source over in-memory batches (one partition per list), all on
    `device`: a batch that lies elsewhere is refused, and device="cuda"
    without a card raises."""

    def __init__(self, partitions: list[list[ColumnarBatch]],
                 schema: Optional[T.Schema] = None, device="cuda"):
        super().__init__()
        self._device = resolve_device(device)
        for p in partitions:
            for b in p:
                if b.device.type != self._device.type:
                    raise ValueError(f"batch on {b.device}, source on "
                                     f"{self._device}")
        self.partitions = partitions
        first = next((b for p in partitions for b in p), None)
        self._schema = schema or (first.schema if first else T.Schema(()))

    def output_schema(self) -> T.Schema:
        return self._schema

    def device(self) -> torch.device:
        return self._device

    def output_partition_count(self) -> int:
        return max(1, len(self.partitions))

    def execute_partitions(self):
        return [iter(p) for p in self.partitions]
