"""Pandas UDF execs (port of spark_rapids_tpu/pyudf/exec.py; reference
`GpuArrowEvalPythonExec.scala`, `GpuMapInPandasExec.scala` and the
grouped variants).

`ArrowEvalPythonExec` evaluates vectorized (Series -> Series) UDFs: a
batch leaves the card once, the UDF runs under the worker semaphore, and
the appended result columns are uploaded again under the task semaphore.
`MapInPandasExec` maps whole DataFrames to DataFrames of a declared
schema.  The grouped execs gather their child to one host frame and
group it there.

With spark.rapids.python.daemon.enabled the vectorized UDFs run in the
daemon's worker processes: the executor evaluates the argument
expressions, ships the argument columns, and reads back the result
columns, so a worker runs the user's function and nothing of the
port's.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable, Iterator, Sequence

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec, UnaryExecBase
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.plan.nodes import CpuNode, empty_df, normalize_df
from spark_rapids_tpu_torch.pyudf.semaphore import PythonWorkerSemaphore


def pandas_udf(return_type: T.DataType):
    """Vectorized UDF decorator: fn receives pandas Series (Spark's
    scalar pandas_udf)."""

    def wrap(fn: Callable):
        fn.return_type = return_type
        fn.is_pandas_udf = True
        return fn
    return wrap


@dataclasses.dataclass
class PandasUdfSpec:
    name: str
    fn: Callable
    return_type: T.DataType
    args: tuple  # Expression args


def _eval_udfs(df: pd.DataFrame, udfs: Sequence[PandasUdfSpec],
               input_schema: T.Schema) -> pd.DataFrame:
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval, nullable_dtype
    sem = PythonWorkerSemaphore.get()
    if C.get_active_conf()[C.PYTHON_DAEMON_ENABLED]:
        return _eval_udfs_daemon(df, udfs, input_schema, sem)
    out = df.copy()
    for u in udfs:
        args = [cpu_eval(a, df, input_schema) for a in u.args]
        with sem.held():
            res = u.fn(*args)
        if not isinstance(res, pd.Series):
            res = pd.Series(res, index=df.index)
        out[u.name] = res.astype(nullable_dtype(u.return_type))
    return out


def _bare_function(fn: Callable) -> Callable:
    """`fn` without its attribute dict (pandas_udf's return_type is a
    port type, which would import torch in the worker); a plain copy is
    also pickled by value, so the worker never imports the module that
    defined it."""
    if not isinstance(fn, types.FunctionType):
        return fn
    bare = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, fn.__closure__)
    bare.__kwdefaults__ = fn.__kwdefaults__
    bare.__qualname__ = fn.__qualname__
    return bare


def _eval_udfs_daemon(df: pd.DataFrame, udfs: Sequence[PandasUdfSpec],
                      input_schema: T.Schema, sem) -> pd.DataFrame:
    """All UDFs in one round trip to a worker (pyudf/daemon.py): the
    worker gets the argument columns and computes only the result
    columns, which the executor merges."""
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval, nullable_dtype
    from spark_rapids_tpu_torch.pyudf.daemon import PythonWorkerPool
    from spark_rapids_tpu_torch.pyudf.worker import ApplyUdfs
    shipped = {}
    specs = []
    for i, u in enumerate(udfs):
        cols = []
        for j, a in enumerate(u.args):
            name = f"_a{i}_{j}"
            shipped[name] = cpu_eval(a, df, input_schema)
            cols.append(name)
        specs.append((u.name, _bare_function(u.fn), tuple(cols)))
    if not shipped:
        # no arguments at all: a 0-column frame loses its row count over
        # Arrow IPC, so ship a 1-byte carrier
        shipped["__rows__"] = np.zeros(len(df), np.int8)
    pool = PythonWorkerPool.get()
    with sem.held():
        res = pool.run_udf(ApplyUdfs(specs),
                           pd.DataFrame(shipped, index=df.index))
    out = df.copy()
    for u in udfs:
        out[u.name] = pd.Series(res[u.name].values, index=df.index).astype(
            nullable_dtype(u.return_type))
    return out


def _output_schema(child_schema: T.Schema,
                   udfs: Sequence[PandasUdfSpec]) -> T.Schema:
    return T.Schema(tuple(child_schema.fields) + tuple(
        T.Field(u.name, u.return_type) for u in udfs))


def _upload(exec_: TpuExec, out: pd.DataFrame, schema: T.Schema):
    """The result frame back on the card under the task semaphore."""
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    TpuSemaphore.get().acquire_if_necessary()
    nb = batch_from_df(normalize_df(out, schema), schema, exec_.device())
    exec_.update_output_metrics(nb)
    return nb


class CpuArrowEvalPython(CpuNode):
    """Planner node (Spark's ArrowEvalPythonExec): appends one column
    per UDF to the child's output."""

    def __init__(self, udfs: Sequence[PandasUdfSpec], child: CpuNode):
        super().__init__(child)
        self.udfs = list(udfs)
        self._schema = _output_schema(child.output_schema(), self.udfs)

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self) -> str:
        return f"CpuArrowEvalPython({[u.name for u in self.udfs]})"

    def execute(self):
        cs = self.child.output_schema()

        def run(it):
            for df in it:
                yield normalize_df(_eval_udfs(df, self.udfs, cs),
                                   self._schema)
        return [run(it) for it in self.child.execute()]


class ArrowEvalPythonExec(UnaryExecBase):
    """One card -> host -> card round trip per batch, the worker
    semaphore around the UDF, the task semaphore around the upload
    (reference GpuArrowEvalPythonExec.doExecuteColumnar)."""

    def __init__(self, udfs: Sequence[PandasUdfSpec], child: TpuExec):
        super().__init__(child)
        self.udfs = list(udfs)
        self._schema = _output_schema(child.output_schema(), self.udfs)

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self) -> str:
        return f"ArrowEvalPythonExec({[u.name for u in self.udfs]})"

    def process_partition(self, batches: Iterator[ColumnarBatch]
                          ) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.plan.transitions import df_from_batch
        cs = self.child.output_schema()
        for batch in batches:
            df = df_from_batch(batch)
            with self.metrics.timed():
                out = _eval_udfs(df, self.udfs, cs)
            yield _upload(self, out, self._schema)


class CpuMapInPandas(CpuNode):
    """mapInPandas: fn maps an iterator of DataFrames to an iterator of
    DataFrames of a declared schema."""

    def __init__(self, fn: Callable, schema: T.Schema, child: CpuNode):
        super().__init__(child)
        self.fn = fn
        self._schema = schema

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self) -> str:
        return f"CpuMapInPandas({getattr(self.fn, '__name__', 'fn')})"

    def execute(self):
        def run(it):
            sem = PythonWorkerSemaphore.get()
            gen = self.fn(iter(it))
            while True:
                with sem.held():
                    try:
                        out = next(gen)
                    except StopIteration:
                        break
                yield normalize_df(out, self._schema)
        return [run(it) for it in self.child.execute()]


class MapInPandasExec(UnaryExecBase):
    def __init__(self, node: CpuMapInPandas, child: TpuExec):
        super().__init__(child)
        self.node = node

    def output_schema(self) -> T.Schema:
        return self.node.output_schema()

    def describe(self) -> str:
        return f"MapInPandasExec({getattr(self.node.fn, '__name__', 'fn')})"

    def process_partition(self, batches: Iterator[ColumnarBatch]
                          ) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.plan.transitions import df_from_batch
        schema = self.node.output_schema()
        sem = PythonWorkerSemaphore.get()
        gen = self.node.fn(df_from_batch(b) for b in batches)
        # hold the worker slot only while Python code runs (each next()),
        # not across the device work downstream of the yielded batch
        while True:
            with sem.held():
                try:
                    out = next(gen)
                except StopIteration:
                    break
            yield _upload(self, out, schema)


# ---------------------------------------------------------------------------
# The grouped variants (reference GpuFlatMapGroupsInPandasExec,
# GpuAggregateInPandasExec, GpuWindowInPandasExec,
# GpuFlatMapCoGroupsInPandasExec; all off by default).  Grouping
# collapses to one partition and groups on the host, the complete-mode
# simplification CpuAggregate uses: Spark plans the key exchange that
# makes this correct, and these operators are host round trips by
# nature.

def _group_frames(df: pd.DataFrame, keys: Sequence[str]):
    """(key tuple, group frame) in key order, the null keys grouped
    together as Spark groups them; a categorical key yields only the
    categories present."""
    if not len(df):
        return
    for key, g in df.groupby(list(keys), dropna=False, sort=True,
                             observed=True):
        yield (key if isinstance(key, tuple) else (key,)), g


def _flat_map_groups(df: pd.DataFrame, keys: Sequence[str], fn,
                     schema: T.Schema) -> pd.DataFrame:
    sem = PythonWorkerSemaphore.get()
    outs = []
    for _, g in _group_frames(df, keys):
        with sem.held():
            outs.append(fn(g.reset_index(drop=True)))
    if not outs:
        return empty_df(schema)
    return pd.concat(outs, ignore_index=True)


def _aggregate_in_pandas(df: pd.DataFrame, keys: Sequence[str],
                         udfs: Sequence[PandasUdfSpec],
                         input_schema: T.Schema,
                         out_schema: T.Schema) -> pd.DataFrame:
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
    sem = PythonWorkerSemaphore.get()
    rows = []
    for key, g in _group_frames(df, keys):
        g = g.reset_index(drop=True)
        row = dict(zip(keys, key))
        for u in udfs:
            args = [cpu_eval(a, g, input_schema) for a in u.args]
            with sem.held():
                row[u.name] = u.fn(*args)
        rows.append(row)
    if not rows:
        return empty_df(out_schema)
    return pd.DataFrame(rows)


def _window_in_pandas(df: pd.DataFrame, part_keys: Sequence[str],
                      udfs: Sequence[PandasUdfSpec],
                      input_schema: T.Schema) -> pd.DataFrame:
    """Window UDFs over an unbounded partition frame (the frame the
    reference's GpuWindowInPandas supports): each UDF reduces its
    partition to a scalar given to every row of the partition."""
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval, nullable_dtype
    sem = PythonWorkerSemaphore.get()
    vals = {u.name: np.full(len(df), None, dtype=object) for u in udfs}
    for _, g in _group_frames(df, part_keys):
        rows = df.index.get_indexer(g.index)
        for u in udfs:
            args = [cpu_eval(a, g.reset_index(drop=True), input_schema)
                    for a in u.args]
            with sem.held():
                vals[u.name][rows] = u.fn(*args)
    out = df.copy()
    for u in udfs:
        out[u.name] = pd.Series(vals[u.name], index=df.index).astype(
            nullable_dtype(u.return_type))
    return out


def _cogroup_apply(ldf: pd.DataFrame, rdf: pd.DataFrame,
                   lkeys: Sequence[str], rkeys: Sequence[str], fn,
                   schema: T.Schema) -> pd.DataFrame:
    """flatMapCoGroupsInPandas: fn(left group, right group) for each
    distinct key of either side (a missing side is an empty frame)."""
    sem = PythonWorkerSemaphore.get()

    def _canon(key: tuple) -> tuple:
        # null keys pair across the sides: NaN != NaN, and None vs pd.NA
        # would split one null group in two
        return tuple(None if pd.isna(v) else v for v in key)

    lgroups = {_canon(k): g.reset_index(drop=True)
               for k, g in _group_frames(ldf, lkeys)}
    rgroups = {_canon(k): g.reset_index(drop=True)
               for k, g in _group_frames(rdf, rkeys)}
    all_keys = sorted(set(lgroups) | set(rgroups),
                      key=lambda t: tuple((v is None, v) for v in t))
    outs = []
    for k in all_keys:
        lg = lgroups.get(k)
        rg = rgroups.get(k)
        if lg is None:
            lg = ldf.iloc[0:0].reset_index(drop=True)
        if rg is None:
            rg = rdf.iloc[0:0].reset_index(drop=True)
        with sem.held():
            outs.append(fn(lg, rg))
    if not outs:
        return empty_df(schema)
    return pd.concat(outs, ignore_index=True)


def _gather_cpu(node: CpuNode) -> pd.DataFrame:
    """Every partition of a CPU child in one frame (the grouped execs
    collapse to one partition, as CpuAggregate does)."""
    parts = [df for it in node.execute() for df in it]
    if not parts:
        return empty_df(node.output_schema())
    return pd.concat(parts, ignore_index=True)


def _single_partition(out: pd.DataFrame, schema: T.Schema) -> list:
    return [iter([normalize_df(out, schema)])]


class _GroupedCpuNode(CpuNode):
    """A grouped pandas node: one output partition."""

    def output_schema(self) -> T.Schema:
        return self._schema

    def output_partition_count(self) -> int:
        return 1


class CpuFlatMapGroupsInPandas(_GroupedCpuNode):
    """groupby(keys).applyInPandas(fn, schema)."""

    def __init__(self, keys: Sequence[str], fn: Callable,
                 schema: T.Schema, child: CpuNode):
        super().__init__(child)
        self.keys = list(keys)
        self.fn = fn
        self._schema = schema

    def describe(self) -> str:
        return f"CpuFlatMapGroupsInPandas(keys={self.keys})"

    def execute(self):
        out = _flat_map_groups(_gather_cpu(self.child), self.keys,
                               self.fn, self._schema)
        return _single_partition(out, self._schema)


class CpuAggregateInPandas(_GroupedCpuNode):
    """groupby(keys).agg(pandas_udf): one output row per group."""

    def __init__(self, keys: Sequence[str],
                 udfs: Sequence[PandasUdfSpec], child: CpuNode):
        super().__init__(child)
        self.keys = list(keys)
        self.udfs = list(udfs)
        cs = child.output_schema()
        fields = [cs.field(k) for k in self.keys]
        fields += [T.Field(u.name, u.return_type) for u in self.udfs]
        self._schema = T.Schema(tuple(fields))

    def describe(self) -> str:
        return (f"CpuAggregateInPandas(keys={self.keys}, "
                f"udfs={[u.name for u in self.udfs]})")

    def execute(self):
        out = _aggregate_in_pandas(_gather_cpu(self.child), self.keys,
                                   self.udfs, self.child.output_schema(),
                                   self._schema)
        return _single_partition(out, self._schema)


class CpuWindowInPandas(_GroupedCpuNode):
    """Window pandas UDFs over an unbounded partition frame: the child's
    columns and one column per UDF."""

    def __init__(self, part_keys: Sequence[str],
                 udfs: Sequence[PandasUdfSpec], child: CpuNode):
        super().__init__(child)
        self.part_keys = list(part_keys)
        self.udfs = list(udfs)
        self._schema = _output_schema(child.output_schema(), self.udfs)

    def describe(self) -> str:
        return f"CpuWindowInPandas(partitionBy={self.part_keys})"

    def execute(self):
        out = _window_in_pandas(_gather_cpu(self.child), self.part_keys,
                                self.udfs, self.child.output_schema())
        return _single_partition(out, self._schema)


class CpuFlatMapCoGroupsInPandas(_GroupedCpuNode):
    """cogroup(left, right).applyInPandas(fn, schema)."""

    def __init__(self, left_keys: Sequence[str],
                 right_keys: Sequence[str], fn: Callable,
                 schema: T.Schema, left: CpuNode, right: CpuNode):
        super().__init__(left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self._schema = schema

    def describe(self) -> str:
        return (f"CpuFlatMapCoGroupsInPandas({self.left_keys} | "
                f"{self.right_keys})")

    def execute(self):
        out = _cogroup_apply(
            _gather_cpu(self.children[0]), _gather_cpu(self.children[1]),
            self.left_keys, self.right_keys, self.fn, self._schema)
        return _single_partition(out, self._schema)


class _GatherAllPythonExec(TpuExec):
    """Base of the grouped execs: gathers the child partitions to one
    host frame (the key exchange is planned upstream), applies a host
    transform, and uploads the result under the task semaphore."""

    def __init__(self, node, *children: TpuExec):
        super().__init__(*children)
        self.node = node

    def output_schema(self) -> T.Schema:
        return self.node.output_schema()

    def output_partition_count(self) -> int:
        return 1

    def execute_partitions(self):
        return [self._run()]

    def _gather(self, child: TpuExec) -> pd.DataFrame:
        from spark_rapids_tpu_torch.plan.transitions import df_from_batch
        frames = [df_from_batch(b) for it in child.execute_partitions()
                  for b in it]
        if not frames:
            return empty_df(child.output_schema())
        return pd.concat(frames, ignore_index=True)

    def _run(self) -> Iterator[ColumnarBatch]:
        frames = [self._gather(c) for c in self.children]
        with self.metrics.timed():
            out = self.transform(*frames)
        yield _upload(self, out, self.output_schema())

    def transform(self, *frames: pd.DataFrame) -> pd.DataFrame:
        raise NotImplementedError


class FlatMapGroupsInPandasExec(_GatherAllPythonExec):
    def describe(self) -> str:
        return f"FlatMapGroupsInPandasExec(keys={self.node.keys})"

    def transform(self, df):
        return _flat_map_groups(df, self.node.keys, self.node.fn,
                                self.output_schema())


class AggregateInPandasExec(_GatherAllPythonExec):
    def describe(self) -> str:
        return f"AggregateInPandasExec(keys={self.node.keys})"

    def transform(self, df):
        return _aggregate_in_pandas(df, self.node.keys, self.node.udfs,
                                    self.child.output_schema(),
                                    self.output_schema())


class WindowInPandasExec(_GatherAllPythonExec):
    def describe(self) -> str:
        return f"WindowInPandasExec(partitionBy={self.node.part_keys})"

    def transform(self, df):
        return _window_in_pandas(df, self.node.part_keys, self.node.udfs,
                                 self.child.output_schema())


class FlatMapCoGroupsInPandasExec(_GatherAllPythonExec):
    def describe(self) -> str:
        return (f"FlatMapCoGroupsInPandasExec({self.node.left_keys} | "
                f"{self.node.right_keys})")

    def transform(self, ldf, rdf):
        return _cogroup_apply(ldf, rdf, self.node.left_keys,
                              self.node.right_keys, self.node.fn,
                              self.output_schema())
