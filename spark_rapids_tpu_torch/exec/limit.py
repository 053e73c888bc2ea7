"""Limit operators (port of spark_rapids_tpu/exec/limit.py: LocalLimitExec,
GlobalLimitExec and CollectLimitExec)."""
from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec, UnaryExecBase


def _limited(batches, n: int) -> Iterator[ColumnarBatch]:
    """At most n rows.  A lazy row count is read back only when another
    batch follows."""
    remaining = n
    it = iter(batches)
    prev = next(it, None)
    while prev is not None and remaining > 0:
        nxt = next(it, None)
        out = (prev if prev.num_rows_known and prev.num_rows <= remaining
               else prev.take_head(remaining))
        remaining = remaining - out.num_rows if nxt is not None else 0
        yield out
        prev = nxt


class LocalLimitExec(UnaryExecBase):
    """Per-partition limit."""

    def __init__(self, n: int, child: TpuExec):
        super().__init__(child)
        self.n = n

    def output_schema(self) -> T.Schema:
        return self.child.output_schema()

    def describe(self):
        return f"LocalLimitExec({self.n})"

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        yield from _limited(batches, self.n)


class GlobalLimitExec(UnaryExecBase):
    """Whole-query limit over the child's partitions in order; one
    output partition."""

    def __init__(self, n: int, child: TpuExec):
        super().__init__(child)
        self.n = n

    def output_schema(self) -> T.Schema:
        return self.child.output_schema()

    def describe(self):
        return f"GlobalLimitExec({self.n})"

    def output_partition_count(self) -> int:
        return 1

    def execute_partitions(self):
        return [_limited((b for part in self.child.execute_partitions()
                          for b in part), self.n)]


def CollectLimitExec(n: int, child: TpuExec) -> GlobalLimitExec:
    """Spark's CollectLimitExec: a limit collected into one partition."""
    return GlobalLimitExec(n, child)
