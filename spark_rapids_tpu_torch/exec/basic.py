"""Basic physical operators: Project, Filter, LocalBatchSource, Range,
Union and CoalescePartitions (port of spark_rapids_tpu/exec/basic.py).

Filter defers compaction: its output is a SPARSE batch whose mask selects
the kept rows, and sparse-aware consumers (project, aggregate, sort) fold
the mask into their own row masking.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    bucket_capacity,
                                                    resolve_device)
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
            with self.kp_step("project", batch.capacity,
                              device=batch.device) as kw:
                ctx = make_eval_context(batch.columns, batch.capacity,
                                        batch.num_rows_i32, batch.sparse)
                out_cols = [e.eval(ctx) for e in self._bound]
                out = ColumnarBatch(self._schema, out_cols, batch._rows,
                                    batch.checks + _register_ansi(ctx),
                                    batch.sparse)
                if kw.wants_cost():
                    kw.cost(batch, out_cols)
            self.update_output_metrics(out)
            yield out


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
            with self.kp_step("filter", batch.capacity,
                              device=batch.device) as kw:
                ctx = make_eval_context(batch.columns, batch.capacity,
                                        batch.num_rows_i32, batch.sparse)
                pred = self._bound.eval(ctx)
                keep = (pred.validity & pred.data.to(torch.bool)
                        & ctx.row_mask)
                out = ColumnarBatch(self._schema, batch.columns,
                                    keep.sum().to(torch.int32),
                                    batch.checks + _register_ansi(ctx),
                                    sparse=keep)
                if kw.wants_cost():
                    kw.cost(batch, keep)
            self.update_output_metrics(out)
            yield out


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


class RangeExec(TpuExec):
    """[start, end) by step in chunks of at most `target_rows` rows, made
    on `device` by arange (Spark's RangeExec)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1, target_rows: int = 1 << 20,
                 name: str = "id", device="cuda"):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)
        self.target_rows = target_rows
        self._device = resolve_device(device)
        self._schema = T.Schema.of((name, T.INT64, False))

    def output_partition_count(self) -> int:
        return self.num_partitions

    def output_schema(self) -> T.Schema:
        return self._schema

    def device(self) -> torch.device:
        return self._device

    def _partition_bounds(self):
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self.num_partitions)
        for p in range(self.num_partitions):
            yield min(p * per, total), min((p + 1) * per, total)

    def _gen(self, lo: int, hi: int) -> Iterator[ColumnarBatch]:
        i = lo
        while i < hi:
            n = min(self.target_rows, hi - i)
            iota = torch.arange(bucket_capacity(n), dtype=torch.int64,
                                device=self._device)
            col = ColumnVector(T.INT64, self.start + (iota + i) * self.step,
                               iota < n)
            yield ColumnarBatch(self._schema, [col], n)
            i += n

    def execute_partitions(self):
        return [self._gen(lo, hi) for lo, hi in self._partition_bounds()]


class UnionExec(TpuExec):
    """UNION ALL: the children's partitions, one after another, under the
    first child's schema.  Children may give a string column different
    char capacities; `concat_batches` pads them to the widest where their
    batches meet."""

    def __init__(self, *children: TpuExec):
        super().__init__(*children)
        self._schema = children[0].output_schema()

    def output_schema(self) -> T.Schema:
        return self._schema

    def output_partition_count(self) -> int:
        return sum(c.output_partition_count() for c in self.children)

    def _renamed(self, it) -> Iterator[ColumnarBatch]:
        for b in it:
            yield ColumnarBatch(self._schema, b.columns, b._rows, b.checks,
                                b.sparse)

    def execute_partitions(self):
        return [self._renamed(it) for c in self.children
                for it in c.execute_partitions()]


class CoalescePartitionsExec(UnaryExecBase):
    """Fewer partitions by chaining the child's partitions round-robin
    (Spark's CoalesceExec: partitions, not batches)."""

    def __init__(self, num_partitions: int, child: TpuExec):
        super().__init__(child)
        self.num_partitions = max(1, num_partitions)

    def output_partition_count(self) -> int:
        return min(self.num_partitions, self.child.output_partition_count())

    def output_schema(self) -> T.Schema:
        return self.child.output_schema()

    def execute_partitions(self):
        kids = self.child.execute_partitions()
        groups: list[list] = [[] for _ in range(
            min(self.num_partitions, max(1, len(kids))))]
        for i, it in enumerate(kids):
            groups[i % len(groups)].append(it)

        def chain(its):
            for it in its:
                yield from it
        return [chain(g) for g in groups]
