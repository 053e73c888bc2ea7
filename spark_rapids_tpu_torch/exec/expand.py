"""Expand and Generate operators (port of spark_rapids_tpu/exec/expand.py).

ExpandExec: each input row emits one output row per projection list, the
building block of grouping sets, ROLLUP and CUBE.  Every projection
evaluates over the same input batch, and the results interleave so that
output row r*nproj + p is projection p of input row r; the output
capacity is capacity * nproj, and its live rows stay a prefix.

GenerateExec: explode over an inline array of expressions
(`explode(array(e1..eN))`), planned as an N-projection expand.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import ColumnVector, _pad_chars
from spark_rapids_tpu_torch.exec.base import (TpuExec, UnaryExecBase,
                                              make_eval_context, kp_site)
from spark_rapids_tpu_torch.exprs.base import (AttributeReference,
                                               Expression, Literal, promote)
from spark_rapids_tpu_torch.plan.nodes import _common_types


def _interleave(parts: list) -> torch.Tensor:
    """[cap, ...] tensors of nproj projections -> [cap * nproj, ...] with
    row r*nproj + p taken from parts[p][r]."""
    stacked = torch.stack(parts, dim=1)
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


class ExpandExec(UnaryExecBase):
    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: TpuExec):
        super().__init__(child)
        child_schema = child.output_schema()
        self.projections = [list(p) for p in projections]
        self._bound = [[e.bind(child_schema) for e in p]
                       for p in self.projections]
        dts = _common_types(child_schema, self.projections)
        self._schema = T.Schema(tuple(
            T.Field(n, dt) for n, dt in zip(names, dts)))

    @property
    def coalesce_after(self) -> bool:
        return True

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        return f"ExpandExec({len(self.projections)} projections)"

    @kp_site("expand")
    def expand_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        nproj = len(self._bound)
        ctx = make_eval_context(batch.columns, batch.capacity,
                                batch.num_rows_i32)
        per_proj = []
        for p in self._bound:
            cols = []
            for e, f in zip(p, self._schema.fields):
                v = e.eval(ctx)
                if not f.dtype.is_string and v.dtype != f.dtype:
                    v = promote(v, f.dtype)
                cols.append(v)
            per_proj.append(cols)
        out_cols = []
        for ci, f in enumerate(self._schema.fields):
            vs = [per_proj[p][ci] for p in range(nproj)]
            valid = _interleave([v.validity & ctx.row_mask for v in vs])
            if f.dtype.is_string:
                cc = max(v.char_cap for v in vs)
                vs = [_pad_chars(v, cc) for v in vs]
                lens = _interleave([torch.where(ctx.row_mask, v.lengths, 0)
                                    for v in vs])
                out_cols.append(ColumnVector(
                    f.dtype, _interleave([v.data for v in vs]), valid,
                    lengths=lens))
            else:
                out_cols.append(ColumnVector(
                    f.dtype, _interleave([v.data for v in vs]), valid))
        rows = (batch.num_rows * nproj if batch.num_rows_known
                else batch.num_rows_i32 * nproj)
        return ColumnarBatch(self._schema, out_cols, rows, batch.checks)

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        for batch in batches:
            out = self.expand_batch(batch.dense())
            self.update_output_metrics(out)
            yield out


class GenerateExec(UnaryExecBase):
    """explode(array(e1..eN)) [+ posexplode]: each row emits N rows with
    (pos?, value)."""

    def __init__(self, element_exprs: Sequence[Expression],
                 child: TpuExec, include_pos: bool = False,
                 value_name: str = "col", retained: Sequence[str] = None):
        super().__init__(child)
        child_schema = child.output_schema()
        self.include_pos = include_pos
        self.element_exprs = list(element_exprs)
        (dt,) = _common_types(child_schema,
                              [[e] for e in self.element_exprs])
        self.retained = list(retained) if retained is not None else \
            list(child_schema.names)
        fields = [child_schema.field(n) for n in self.retained]
        if include_pos:
            fields.append(T.Field("pos", T.INT32))
        fields.append(T.Field(value_name, dt))
        self._schema = T.Schema(tuple(fields))
        # as an N-projection expand: projection p = retained + [p, e_p]
        projections = []
        for p, e in enumerate(self.element_exprs):
            proj = [AttributeReference(n) for n in self.retained]
            if include_pos:
                proj.append(Literal(p, T.INT32))
            proj.append(e)
            projections.append(proj)
        self._expand = ExpandExec(projections, [f.name for f in fields],
                                  child)

    @property
    def coalesce_after(self) -> bool:
        return True

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        return (f"GenerateExec(explode[{len(self.element_exprs)}], "
                f"pos={self.include_pos})")

    def process_partition(self, batches):
        return self._expand.process_partition(batches)
