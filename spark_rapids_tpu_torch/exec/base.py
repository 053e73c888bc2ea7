"""Physical operator base (port of spark_rapids_tpu/exec/base.py).

A `TpuExec` produces an iterator of ColumnarBatch; Python orchestrates
batch flow while the per-batch work runs as torch ops and CUDA kernels on
the batch's device.  PyTorch runs eagerly, so the reference's compile
cache has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches,
                                                   empty_batch)
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression
from spark_rapids_tpu_torch.utils import checks as CK


# -- coalesce goals ----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CoalesceGoal:
    pass


@dataclasses.dataclass(frozen=True)
class TargetSize(CoalesceGoal):
    bytes: int


@dataclasses.dataclass(frozen=True)
class RequireSingleBatch(CoalesceGoal):
    pass


def max_goal(a: Optional[CoalesceGoal], b: Optional[CoalesceGoal]
             ) -> Optional[CoalesceGoal]:
    if isinstance(a, RequireSingleBatch) or isinstance(b, RequireSingleBatch):
        return RequireSingleBatch()
    if isinstance(a, TargetSize) and isinstance(b, TargetSize):
        return TargetSize(max(a.bytes, b.bytes))
    return a or b


def make_eval_context(columns: list[ColumnVector], capacity: int,
                      num_rows, mask=None) -> EvalContext:
    """`mask` (a sparse selection vector) overrides the prefix row mask."""
    if mask is None:
        dev = columns[0].device
        mask = torch.arange(capacity, device=dev) < num_rows
    return EvalContext(columns, capacity, num_rows, mask)


_EXEC_IDS = itertools.count()

#: the execution a plan is in: "epoch" grows with every attempt of an
#: outermost collect (CommonSubplanExec caches are valid for one), and
#: "depth" counts nested collects (a range exchange's sample sort)
_EXECUTION = {"epoch": 0, "depth": 0}


def new_execution() -> None:
    """Start a new execution: shared-subplan caches of earlier ones stop
    being valid."""
    _EXECUTION["epoch"] += 1


class TpuExec:
    """Base physical operator."""

    def __init__(self, *children: "TpuExec"):
        self._children = list(children)
        self.exec_id = next(_EXEC_IDS)

    @property
    def children(self) -> list["TpuExec"]:
        return self._children

    @property
    def child(self) -> "TpuExec":
        return self._children[0]

    def output_schema(self) -> T.Schema:
        raise NotImplementedError

    def device(self) -> torch.device:
        """The device this plan runs on (its leaf's)."""
        return self.child.device()

    def output_partition_count(self) -> int:
        """Planning-time partition count; executes nothing."""
        if not self._children:
            return 1
        return self._children[0].output_partition_count()

    @property
    def coalesce_after(self) -> bool:
        """True when this exec shrinks batches, so a coalesce above it
        pays off."""
        return False

    def children_coalesce_goal(self) -> list[Optional[CoalesceGoal]]:
        return [None] * len(self._children)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        for it in self.execute_partitions():
            yield from it

    def execute_partitions(self) -> list[Iterator[ColumnarBatch]]:
        raise NotImplementedError

    #: bounded deopt attempts: intermediate retries may take fast paths
    #: with escalated parameters and fail again; only the LAST runs with
    #: every fast path forced off (is_retrying) for a guaranteed-valid
    #: result
    MAX_DEOPT_RETRIES = 3

    def collect(self) -> ColumnarBatch:
        """Materialize to one batch: the sync boundary where deferred
        fast-path checks resolve.  On FastPathInvalid, disable or escalate
        the fast paths at fault and re-execute (plans are pure), up to
        MAX_DEOPT_RETRIES times."""
        outermost = _EXECUTION["depth"] == 0
        _EXECUTION["depth"] += 1
        try:
            return self._collect_attempts(outermost)
        finally:
            _EXECUTION["depth"] -= 1
            if outermost:
                self.release_execution_state()

    def _collect_attempts(self, outermost: bool) -> ColumnarBatch:
        mark = CK.snapshot()
        for attempt in range(self.MAX_DEOPT_RETRIES + 1):
            final = attempt == self.MAX_DEOPT_RETRIES
            if attempt:
                CK.set_retrying(final)
            if outermost:
                new_execution()
            try:
                out = self._collect_once().dense()
                checks = list(out.checks) + CK.drain_since(mark)
                # the lazy row count rides the same readback as the flags
                if out.num_rows_known:
                    CK.verify(checks)
                else:
                    (rows,) = CK.verify(checks, scalars=[out.num_rows_i32])
                    out.num_rows = int(rows)
                return out
            except CK.FastPathInvalid as e:
                if final:
                    raise
                e.recover_all()
                CK.drain_since(mark)  # discard this attempt's rest
            finally:
                if attempt:
                    CK.set_retrying(False)
        raise AssertionError("unreachable")

    def _collect_once(self) -> ColumnarBatch:
        batches = list(self.execute_columnar())
        if not batches:
            return empty_batch(self.output_schema(), self.device())
        return concat_batches(batches, sparse_ok=True)

    def release_execution_state(self) -> None:
        """Drop what an execution cached (CommonSubplanExec batches), so
        a finished query holds no device memory through its plan."""
        for c in self._children:
            c.release_execution_state()

    def to_pandas(self):
        return self.collect().to_pandas()

    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name()

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self._children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    def __repr__(self):
        return self.tree_string()


class SchemaOnlyExec(TpuExec):
    """Placeholder child carrying just a schema, for internal helper
    execs (merge nodes)."""

    def __init__(self, schema: T.Schema):
        super().__init__()
        self._schema = schema

    def output_schema(self) -> T.Schema:
        return self._schema


class CommonSubplanExec(TpuExec):
    """Execute-once wrapper of a subtree that several parents share: the
    first consumer in an execution runs it and keeps its batches, the
    others read them back (the role of Spark's ReusedExchangeExec)."""

    def __init__(self, child: TpuExec):
        super().__init__(child)
        self._epoch = -1
        self._cached = None

    def output_schema(self):
        return self.child.output_schema()

    @property
    def coalesce_after(self) -> bool:
        # transparent for coalesce insertion
        return self.child.coalesce_after

    def execute_partitions(self):
        epoch = _EXECUTION["epoch"]
        if self._epoch != epoch:
            self._cached = [list(it)
                            for it in self.child.execute_partitions()]
            self._epoch = epoch
        return [iter(p) for p in self._cached]

    def release_execution_state(self) -> None:
        self._cached = None
        self._epoch = -1
        super().release_execution_state()


class UnaryExecBase(TpuExec):
    """Partition-local single-child operator: processes one child batch
    iterator into an output iterator."""

    def process_partition(self, batches: Iterator[ColumnarBatch]
                          ) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute_partitions(self):
        return [self.process_partition(it)
                for it in self.child.execute_partitions()]


def bind_exprs(exprs: Sequence[Expression], schema: T.Schema
               ) -> list[Expression]:
    return [e.bind(schema) for e in exprs]
