"""Batch coalescing (port of spark_rapids_tpu/exec/coalesce.py):
concatenate small batches up to a CoalesceGoal, TargetSize(bytes) or
RequireSingleBatch, and re-bucket the capacity of a batch that a filter
left over-padded.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches,
                                                   empty_batch)
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import (CoalesceGoal,
                                              RequireSingleBatch, TargetSize,
                                              TpuExec, UnaryExecBase)
from spark_rapids_tpu_torch.utils import metrics as M

#: a lazy batch (row count still on the device) within this multiple of
#: the row cap passes through whole: its memory is already allocated, and
#: slicing it would first read its count back
LAZY_PASS_MULT = 8


def coalesce_iterator(batches: Iterator[ColumnarBatch], goal: CoalesceGoal,
                      schema: T.Schema, device: torch.device,
                      max_rows: Optional[int] = None
                      ) -> Iterator[ColumnarBatch]:
    """Concatenate `batches` toward `goal`.  For TargetSize, `max_rows`
    also caps the rows of each emitted batch; a larger dense batch is
    sliced, and lazy batches are sized by their capacity."""
    if isinstance(goal, RequireSingleBatch):
        got = [b for b in batches if b.maybe_nonempty()]
        if not got:
            yield empty_batch(schema, device)
            return
        yield concat_batches(got) if len(got) > 1 else _rebucket(got[0])
        return
    target = goal.bytes if isinstance(goal, TargetSize) else 1 << 31
    if max_rows is None:
        max_rows = C.get_active_conf()[C.MAX_BATCH_ROWS]
    pending: list[ColumnarBatch] = []
    pending_bytes = pending_rows = 0
    for big in batches:
        if not big.maybe_nonempty():
            continue
        lazy_bounded = (not big.num_rows_known
                        and big.capacity <= LAZY_PASS_MULT * max_rows)
        if lazy_bounded or big.num_rows <= max_rows:
            pieces = (big,)
        else:
            dense = big.dense()
            pieces = (dense.slice(lo, min(max_rows, dense.num_rows - lo))
                      for lo in range(0, dense.num_rows, max_rows))
        for b in pieces:
            rows = b.num_rows if b.num_rows_known else b.capacity
            est = _row_bytes(b) * rows
            if pending and (pending_bytes + est > target
                            or pending_rows + rows > max_rows):
                yield _emit(pending)
                pending, pending_bytes, pending_rows = [], 0, 0
            pending.append(b)
            pending_bytes += est
            pending_rows += rows
    if pending:
        yield _emit(pending)


def _row_bytes(b: ColumnarBatch) -> int:
    total = 0
    for f, c in zip(b.schema.fields, b.columns):
        total += (c.char_cap + 5 if f.dtype.is_string
                  else f.dtype.storage_dtype.itemsize + 1)
    return max(total, 1)


def _rebucket(b: ColumnarBatch) -> ColumnarBatch:
    """Shrink an over-padded batch into its tight bucket (after a
    selective filter); a lazy count is not read back for it."""
    if not b.num_rows_known:
        return b
    tight = bucket_capacity(b.num_rows)
    return b.with_capacity(tight) if tight < b.capacity else b


def _emit(pending: list[ColumnarBatch]) -> ColumnarBatch:
    return (concat_batches(pending, sparse_ok=True) if len(pending) > 1
            else _rebucket(pending[0]))


class CoalesceBatchesExec(UnaryExecBase):
    """Inserted by the transition pass per each operator's
    children_coalesce_goal."""

    def __init__(self, goal: CoalesceGoal, child: TpuExec,
                 max_rows: Optional[int] = None):
        super().__init__(child)
        self.goal = goal
        self._max_rows = (max_rows if max_rows is not None
                          else C.get_active_conf()[C.MAX_BATCH_ROWS])

    def output_schema(self) -> T.Schema:
        return self.child.output_schema()

    def describe(self):
        return f"CoalesceBatchesExec({self.goal})"

    def process_partition(self, batches):
        # the reference prefetches here; the port prefetches only at the
        # file scan (exec/pipeline.py says why)
        def counted(it):
            for b in it:
                self.metrics.add(M.NUM_INPUT_BATCHES, 1)
                self.metrics.add(M.NUM_INPUT_ROWS, b._rows)
                yield b
        for out in coalesce_iterator(counted(batches), self.goal,
                                     self.output_schema(), self.device(),
                                     max_rows=self._max_rows):
            self.update_output_metrics(out)
            yield out
