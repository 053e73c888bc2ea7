"""Device-neutral physical plan nodes with real CPU (pandas) execution
(port of spark_rapids_tpu/plan/nodes.py: source, project, filter, limit,
sort, aggregate, sort aggregate, hash, sort-merge and nested-loop join,
cartesian product, cached columnar data and the user's repartition).

These play the role of Spark's own row-based operators: the input of the
plan rewrite (`plan/overrides.py`), and the engine a node runs on when it
is tagged off the GPU.  Each node carries `Expression` trees, which both
engines understand (device: torch columnar evaluation; CPU:
`plan/cpu_eval.py`).  `execute() -> list[Iterator[pd.DataFrame]]` yields
partitions of row chunks.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Iterator, Optional, Sequence

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.aggregates import AggAlias
from spark_rapids_tpu_torch.exprs.base import Expression, output_name
from spark_rapids_tpu_torch.plan.cpu_eval import (cpu_eval,
                                                  nested_loop_join,
                                                  nullable_dtype)


class CpuNode:
    """Base physical node: `output_schema()` and `children`."""

    def __init__(self, *children: "CpuNode"):
        self.children = list(children)

    @property
    def child(self) -> "CpuNode":
        return self.children[0]

    def output_schema(self) -> T.Schema:
        raise NotImplementedError

    def output_partition_count(self) -> int:
        """Planning-time partition count; executes nothing."""
        if not self.children:
            return 1
        return self.children[0].output_partition_count()

    def execute(self) -> list[Iterator[pd.DataFrame]]:
        raise NotImplementedError

    def collect(self) -> pd.DataFrame:
        parts = [df for it in self.execute() for df in it]
        if not parts:
            return empty_df(self.output_schema())
        return pd.concat(parts, ignore_index=True)

    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name()

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self.children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    def __repr__(self):
        return self.tree_string()


def empty_df(schema: T.Schema) -> pd.DataFrame:
    return pd.DataFrame({
        f.name: pd.Series([], dtype=nullable_dtype(f.dtype))
        for f in schema.fields})


def normalize_df(df: pd.DataFrame, schema: T.Schema) -> pd.DataFrame:
    """Coerce columns to the schema's nullable dtypes.  Date columns of
    python `datetime.date` objects become int32 days since the epoch."""
    out = {}
    for f in schema.fields:
        s = df[f.name]
        if f.dtype.id == T.TypeId.DATE32 and s.dtype == object:
            epoch = _dt.date(1970, 1, 1)
            out[f.name] = pd.Series(pd.array(
                [None if pd.isna(v) else (v - epoch).days for v in s],
                "Int32"), index=df.index)
            continue
        want = nullable_dtype(f.dtype)
        if str(s.dtype) != want:
            try:
                s = s.astype(want)
            except (TypeError, ValueError):
                pass
        out[f.name] = s
    return pd.DataFrame(out)


def schema_of_df(df: pd.DataFrame) -> T.Schema:
    """Engine schema of a frame's dtypes; datetime64 columns are
    TIMESTAMP_US, object columns of dates DATE32, other object columns
    STRING."""
    named = {"Int8": T.INT8, "Int16": T.INT16, "Int32": T.INT32,
             "Int64": T.INT64, "Float32": T.FLOAT32, "Float64": T.FLOAT64,
             "boolean": T.BOOL}
    fields = []
    for name in df.columns:
        s = df[name]
        sd = str(s.dtype)
        kind = getattr(s.dtype, "kind", "O")
        if sd in named:
            dt = named[sd]
        elif kind in ("b", "i", "f", "M"):
            dt = T.from_numpy_dtype(s.dtype)
        else:
            try:
                dates = pd.api.types.infer_dtype(s, skipna=True) == "date"
            except (TypeError, ValueError):
                dates = False
            dt = T.DATE32 if dates and s.notna().any() else T.STRING
        fields.append(T.Field(name, dt))
    return T.Schema(tuple(fields))


# ---------------------------------------------------------------------------
class CpuSource(CpuNode):
    """In-memory partitioned source (LocalBatchSource's CPU twin)."""

    def __init__(self, partitions: list[pd.DataFrame], schema: T.Schema):
        super().__init__()
        self.partitions = partitions
        self._schema = schema

    @staticmethod
    def from_pandas(df: pd.DataFrame, num_partitions: int = 1) -> "CpuSource":
        """A source of `df` in its own dtypes' schema, cut into
        `num_partitions` row ranges."""
        schema = schema_of_df(df)
        if num_partitions <= 1 or not len(df):
            return CpuSource([df], schema)
        bounds = np.linspace(0, len(df), num_partitions + 1).astype(int)
        return CpuSource([df.iloc[bounds[i]:bounds[i + 1]].reset_index(
            drop=True) for i in range(num_partitions)], schema)

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return max(1, len(self.partitions))

    def execute(self):
        return [iter([p]) for p in self.partitions]


class CpuProject(CpuNode):
    def __init__(self, exprs: Sequence[Expression], child: CpuNode):
        super().__init__(child)
        self.exprs = list(exprs)
        cs = child.output_schema()
        self._schema = T.Schema(tuple(
            T.Field(output_name(e, i), e.data_type(cs))
            for i, e in enumerate(self.exprs)))

    def output_schema(self):
        return self._schema

    def describe(self):
        return f"CpuProject({', '.join(map(repr, self.exprs))})"

    def execute(self):
        cs = self.child.output_schema()

        def run(it):
            for df in it:
                yield pd.DataFrame(
                    {output_name(e, i): cpu_eval(e, df, cs)
                     for i, e in enumerate(self.exprs)}, index=df.index)
        return [run(it) for it in self.child.execute()]


class CpuFilter(CpuNode):
    def __init__(self, condition: Expression, child: CpuNode):
        super().__init__(child)
        self.condition = condition
        self._schema = child.output_schema()

    def output_schema(self):
        return self._schema

    def describe(self):
        return f"CpuFilter({self.condition!r})"

    def execute(self):
        cs = self._schema

        def run(it):
            for df in it:
                mask = cpu_eval(self.condition, df, cs)
                mask = mask.astype("boolean").fillna(False).astype(bool)
                yield df[mask.to_numpy()].reset_index(drop=True)
        return [run(it) for it in self.child.execute()]


class CpuLimit(CpuNode):
    def __init__(self, n: int, child: CpuNode, global_limit: bool = True):
        super().__init__(child)
        self.n = n
        self.global_limit = global_limit
        self._schema = child.output_schema()

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return 1 if self.global_limit else \
            self.child.output_partition_count()

    def describe(self):
        return f"CpuLimit({self.n}, global={self.global_limit})"

    def execute(self):
        def head(frames):
            remaining = self.n
            for df in frames:
                if remaining <= 0:
                    return
                out = df.iloc[:remaining]
                remaining -= len(out)
                yield out
        if self.global_limit:
            return [head(df for it in self.child.execute() for df in it)]
        return [head(it) for it in self.child.execute()]


class CpuSort(CpuNode):
    def __init__(self, order: Sequence[SortOrder], child: CpuNode,
                 global_sort: bool = True):
        super().__init__(child)
        self.order = list(order)
        self.global_sort = global_sort
        self._schema = child.output_schema()

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return 1 if self.global_sort else \
            self.child.output_partition_count()

    def describe(self):
        return f"CpuSort(global={self.global_sort})"

    def _sort_df(self, df: pd.DataFrame) -> pd.DataFrame:
        cs = self._schema
        tmp = df.copy()
        # pandas applies one na_position to all keys: per-key null
        # ordering rides a null-rank companion key per sort column
        by, asc = [], []
        for i, o in enumerate(self.order):
            key = cpu_eval(o.expr, df, cs)
            rank = np.where(key.isna(), 0 if o.resolved_nulls_first else 1,
                            0 if not o.resolved_nulls_first else 1)
            if not o.ascending:  # sort_values flips every key alike
                rank = -rank
            tmp[f"__sk{i}"] = key
            tmp[f"__sk{i}_n"] = rank
            by.extend([f"__sk{i}_n", f"__sk{i}"])
            asc.extend([o.ascending, o.ascending])
        tmp = tmp.sort_values(by, ascending=asc, kind="stable",
                              na_position="last")
        return tmp[list(df.columns)].reset_index(drop=True)

    def execute(self):
        if self.global_sort:
            parts = [df for it in self.child.execute() for df in it]
            if not parts:
                return [iter([])]
            return [iter([self._sort_df(pd.concat(parts,
                                                  ignore_index=True))])]

        def run(it):
            chunk = list(it)
            if chunk:
                yield self._sort_df(pd.concat(chunk, ignore_index=True))
        return [run(it) for it in self.child.execute()]


#: pandas groupby op of each aggregate function the port has
_AGG_PANDAS = {"Sum": "sum", "Average": "mean", "Count": "count",
               "Min": "min", "Max": "max", "First": "first", "Last": "last",
               "StddevSamp": "std", "VarianceSamp": "var"}


def _raw_first_last(func) -> bool:
    """First/Last without ignore_nulls take the group's raw first or
    last row, null or not (Spark's default; pandas' first/last skip
    nulls)."""
    return type(func).__name__ in ("First", "Last") and \
        not getattr(func, "ignore_nulls", False)


def _spark_minmax(s: pd.Series, is_min: bool):
    """Min or max of a group's non-null values with Spark's NaN rule (NaN
    is the largest value); None for a group without one."""
    s = s.dropna()
    if not len(s):
        return None
    if s.dtype.kind == "f" or str(s.dtype) in ("Float32", "Float64"):
        vals = s.to_numpy(np.float64)
        nan = np.isnan(vals)
        if nan.all() or (nan.any() and not is_min):
            return float("nan")
        vals = vals[~nan]
        return vals.min() if is_min else vals.max()
    return s.min() if is_min else s.max()


def _agg_op(func):
    """pandas groupby op for an AggregateFunction; Spark's SUM of only
    nulls is NULL (pandas' default min_count=0 would give 0)."""
    fname = type(func).__name__
    if _raw_first_last(func):
        idx = 0 if fname == "First" else -1
        return lambda s: s.iloc[idx] if len(s) else None
    if fname == "Sum":
        return lambda s: s.sum(min_count=1)
    if fname in ("Min", "Max"):
        return lambda s: _spark_minmax(s, fname == "Min")
    return _AGG_PANDAS[fname]


def _reduce(s: pd.Series, func):
    fname = type(func).__name__
    if fname == "Count":
        return int(s.notna().sum())
    if fname in ("Min", "Max"):
        return _spark_minmax(s, fname == "Min")
    if _raw_first_last(func):
        if not len(s):
            return None
        v = s.iloc[0 if fname == "First" else -1]
        return None if v is pd.NA else v
    s2 = s.dropna()
    if not len(s2):
        return None
    return {"Sum": s2.sum, "Average": s2.mean, "First": lambda: s2.iloc[0],
            "Last": lambda: s2.iloc[-1], "StddevSamp": s2.std,
            "VarianceSamp": s2.var}[fname]()


class CpuAggregate(CpuNode):
    """Hash aggregation over pandas groupby (complete mode: the CPU side
    runs only when a whole aggregate fell back)."""

    def __init__(self, group_exprs: Sequence[Expression],
                 aggregates: Sequence, child: CpuNode):
        super().__init__(child)
        self.group_exprs = list(group_exprs)
        self.aggregates = [a if isinstance(a, AggAlias)
                           else AggAlias(a, f"agg{i}")
                           for i, a in enumerate(aggregates)]
        cs = child.output_schema()
        fields = [T.Field(output_name(e, i), e.data_type(cs))
                  for i, e in enumerate(self.group_exprs)]
        fields += [T.Field(a.name, a.func.result_type(cs))
                   for a in self.aggregates]
        self._schema = T.Schema(tuple(fields))

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return 1

    def describe(self):
        return (f"CpuAggregate(keys={len(self.group_exprs)}, "
                f"aggs={[a.name for a in self.aggregates]})")

    def execute(self):
        cs = self.child.output_schema()
        parts = [df for it in self.child.execute() for df in it]
        df = pd.concat(parts, ignore_index=True) if parts else empty_df(cs)
        key_names = [output_name(e, i)
                     for i, e in enumerate(self.group_exprs)]
        work = pd.DataFrame(index=df.index)
        for kn, e in zip(key_names, self.group_exprs):
            work[kn] = cpu_eval(e, df, cs)
        for a in self.aggregates:
            if a.func.child is None:  # Count(*)
                work[a.name] = pd.Series(np.ones(len(df), np.int64),
                                         index=df.index)
            else:
                work[a.name] = cpu_eval(a.func.child, df, cs)
        if not key_names:  # reduction
            row = {a.name: _reduce(work[a.name], a.func)
                   for a in self.aggregates}
            out = pd.DataFrame([row])
            for a in self._float_minmax():
                out[a.name] = _keep_nan(out[a.name], [row[a.name] is None])
            return [iter([normalize_df(out, self._schema)])]
        grouped = work.groupby(key_names, dropna=False, sort=False)
        cols = {a.name: grouped[a.name].agg(_agg_op(a.func))
                for a in self.aggregates}
        for a in self._float_minmax():
            cols[a.name] = _keep_nan(cols[a.name],
                                     grouped[a.name].count() == 0)
        out = pd.DataFrame(cols).reset_index()
        return [iter([normalize_df(out, self._schema)])]

    def _float_minmax(self) -> list:
        """The Min/Max aggregates of floating type, whose NaN results
        must not turn into nulls on the way out."""
        return [a for a in self.aggregates
                if type(a.func).__name__ in ("Min", "Max")
                and self._schema.field(a.name).dtype.is_floating]


class CpuSortAggregate(CpuAggregate):
    """Spark's SortAggregateExec, planned for aggregates hash aggregation
    cannot buffer.  Its CPU evaluation is the grouped one with the groups
    in key order; on the GPU it becomes the same HashAggregateExec as a
    hash aggregate, which promises no output order (a consumer that
    needs sorted groups keeps its own sort)."""

    def describe(self):
        return (f"CpuSortAggregate(keys={len(self.group_exprs)}, "
                f"aggs={[a.name for a in self.aggregates]})")

    def execute(self):
        parts = super().execute()
        key_names = [output_name(e, i)
                     for i, e in enumerate(self.group_exprs)]
        if not key_names:
            return parts
        out = pd.concat(list(parts[0]), ignore_index=True)
        return [iter([out.sort_values(key_names, ignore_index=True,
                                      kind="stable")])]


def _keep_nan(values: pd.Series, missing) -> pd.Series:
    """A nullable float column of `values` that is null exactly where
    `missing` says and keeps NaN elsewhere (pandas would read a float
    NaN as a null)."""
    return pd.Series(pd.arrays.FloatingArray(
        values.to_numpy(np.float64, na_value=np.nan),
        np.asarray(missing, bool)), index=values.index)


class CpuHashJoin(CpuNode):
    """Equi-join over pandas merges (HashJoinExec's CPU twin): null keys
    never match, and a residual condition applies during matching."""

    def __init__(self, join_type: JoinType,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 left: CpuNode, right: CpuNode,
                 condition: Optional[Expression] = None,
                 broadcast: bool = False):
        super().__init__(left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self.broadcast = broadcast
        ls, rs = left.output_schema(), right.output_schema()
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            self._schema = ls
        else:
            self._schema = T.Schema(tuple(ls.fields) + tuple(rs.fields))

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return 1

    def describe(self):
        return f"CpuHashJoin({self.join_type.value})"

    def execute(self):
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()
        lparts = [df for it in self.children[0].execute() for df in it]
        rparts = [df for it in self.children[1].execute() for df in it]
        ldf = (pd.concat(lparts, ignore_index=True) if lparts
               else empty_df(ls))
        rdf = (pd.concat(rparts, ignore_index=True) if rparts
               else empty_df(rs))
        lk = pd.DataFrame({f"__k{i}": cpu_eval(e, ldf, ls)
                           for i, e in enumerate(self.left_keys)})
        rk = pd.DataFrame({f"__k{i}": cpu_eval(e, rdf, rs)
                           for i, e in enumerate(self.right_keys)})
        # Spark joins never match null keys
        lvalid = ~lk.isna().any(axis=1)
        rvalid = ~rk.isna().any(axis=1)
        laug = pd.concat(
            [ldf, lk, pd.Series(np.arange(len(ldf)), name="__lrow")],
            axis=1)
        raug = pd.concat(
            [rdf.add_prefix("__r_"), rk,
             pd.Series(np.arange(len(rdf)), name="__rrow")], axis=1)
        keys = [f"__k{i}" for i in range(len(self.left_keys))]
        jt = self.join_type
        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            if self.condition is None:
                matched = laug[lvalid].merge(
                    raug[rvalid][keys].drop_duplicates(),
                    on=keys, how="inner")["__lrow"]
            else:
                # EXISTS semantics: a left row matches if ANY key-equal
                # right row also passes the residual condition
                inner = laug[lvalid].merge(raug[rvalid], on=keys,
                                           how="inner")
                inner = inner[self._condition_mask(inner, ldf, rdf)]
                matched = inner["__lrow"]
            mask = np.zeros(len(ldf), bool)
            mask[matched.to_numpy()] = True
            if jt == JoinType.LEFT_ANTI:
                mask = ~mask
            out = ldf[mask]
            return [iter([out.reset_index(drop=True)])]
        if self.condition is not None and jt in (
                JoinType.LEFT_OUTER, JoinType.RIGHT_OUTER,
                JoinType.FULL_OUTER):
            # Spark applies the residual condition DURING matching: rows
            # whose every match fails the condition are still emitted as
            # unmatched (null-padded), never dropped
            inner = laug[lvalid].merge(raug[rvalid], on=keys, how="inner")
            inner = inner[self._condition_mask(inner, ldf, rdf)]
            parts = [inner]
            if jt in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER):
                matched = set(inner["__lrow"])
                parts.append(laug[~laug["__lrow"].isin(matched)])
            if jt in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
                matched = set(inner["__rrow"])
                parts.append(raug[~raug["__rrow"].isin(matched)])
            merged = pd.concat(parts, ignore_index=True)
        else:
            how = {JoinType.INNER: "inner", JoinType.LEFT_OUTER: "left",
                   JoinType.RIGHT_OUTER: "right",
                   JoinType.FULL_OUTER: "outer"}[jt]
            if how == "inner":
                merged = laug[lvalid].merge(raug[rvalid], on=keys,
                                            how="inner")
            elif how == "left":
                merged = laug.merge(raug[rvalid], on=keys, how="left")
            elif how == "right":
                merged = laug[lvalid].merge(raug, on=keys, how="right")
            else:
                # full outer: null keys never match (pandas would match
                # NA==NA), so join valid keys, append null-key rows unmatched
                merged = laug[lvalid].merge(raug[rvalid], on=keys,
                                            how="outer")
                merged = pd.concat(
                    [merged, laug[~lvalid], raug[~rvalid]],
                    ignore_index=True)
            if self.condition is not None:
                merged = merged[self._condition_mask(merged, ldf, rdf)]
        out = pd.concat([
            merged[[c for c in ldf.columns]].reset_index(drop=True),
            merged[[f"__r_{c}" for c in rdf.columns]]
            .rename(columns=lambda c: c[4:]).reset_index(drop=True)],
            axis=1)
        return [iter([normalize_df(out, self._schema)])]

    def _condition_mask(self, merged: pd.DataFrame, ldf: pd.DataFrame,
                        rdf: pd.DataFrame) -> np.ndarray:
        comb = pd.concat([
            merged[[c for c in ldf.columns]].reset_index(drop=True),
            merged[[f"__r_{c}" for c in rdf.columns]]
            .rename(columns=lambda c: c[4:]).reset_index(drop=True)],
            axis=1)
        # conditions see both sides even when the join's OUTPUT schema is
        # left-only (semi/anti)
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()
        both = T.Schema(tuple(ls.fields) + tuple(rs.fields))
        m = cpu_eval(self.condition, comb, both)
        return m.astype("boolean").fillna(False).astype(bool).to_numpy()


class CpuSortMergeJoin(CpuHashJoin):
    """Spark's SortMergeJoinExec.  The CPU engine evaluates it as a hash
    join (same rows; merge order is no part of the result); the planner
    replaces it with a shuffled HashJoinExec and drops the input sorts
    that only fed the merge, under
    spark.rapids.sql.replaceSortMergeJoin.enabled."""

    def describe(self):
        return f"CpuSortMergeJoin({self.join_type.value})"


class CpuNestedLoopJoin(CpuNode):
    """Brute-force join with NO equi keys (Spark
    BroadcastNestedLoopJoinExec).  The reference registers its rule
    disabled by default ('large joins can cause out of memory errors',
    `GpuOverrides.scala:1770-1774`), and supports inner-like join types
    only (`GpuBroadcastNestedLoopJoinExec.scala:49-53`); both hold here.
    The planner's way to a non-equi join condition."""

    def __init__(self, join_type: JoinType, left: CpuNode, right: CpuNode,
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        if join_type not in (JoinType.INNER, JoinType.CROSS):
            # refused at construction: the CPU evaluation computes inner
            # and cross semantics only
            raise ValueError(
                f"nested loop join supports inner/cross only, "
                f"got {join_type}")
        self.join_type = join_type
        self.condition = condition
        ls, rs = left.output_schema(), right.output_schema()
        self._schema = T.Schema(tuple(ls.fields) + tuple(rs.fields))

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return 1

    def describe(self):
        cond = "" if self.condition is None else ", condition"
        return f"{type(self).__name__}({self.join_type.value}{cond})"

    def execute(self):
        frames = []
        for child in self.children:
            parts = [df for it in child.execute() for df in it]
            frames.append(pd.concat(parts, ignore_index=True) if parts
                          else empty_df(child.output_schema()))
        out = nested_loop_join(frames[0], frames[1], self.condition,
                               self._schema)
        return [iter([normalize_df(out, self._schema)])]


class CpuCartesianProduct(CpuNestedLoopJoin):
    """Spark's CartesianProductExec: a CROSS join of two sides, with an
    optional condition.  A class of its own so its per-op enable key is
    the reference's separate `exec[CartesianProductExec]` rule
    (`GpuOverrides.scala:1774-1789`, also disabled by default)."""

    def __init__(self, left: CpuNode, right: CpuNode,
                 condition: Optional[Expression] = None):
        super().__init__(JoinType.CROSS, left, right, condition)


class CpuCachedColumnar(CpuNode):
    """Host-columnar cached data (Spark's InMemoryTableScan): partitions
    of pyarrow tables.  On the GPU it becomes HostColumnarToDeviceExec,
    which uploads the column buffers with no pivot through rows."""

    def __init__(self, partitions, schema: T.Schema):
        super().__init__()
        self.partitions = list(partitions)  # list[pyarrow.Table]
        self._schema = schema

    @staticmethod
    def from_pandas(df, num_partitions: int = 1) -> "CpuCachedColumnar":
        import pyarrow as pa
        src = CpuSource.from_pandas(df, num_partitions=num_partitions)
        tables = [pa.Table.from_pandas(p, preserve_index=False)
                  for p in src.partitions]
        return CpuCachedColumnar(tables, src.output_schema())

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return max(1, len(self.partitions))

    def describe(self):
        return f"CpuCachedColumnar({len(self.partitions)} partitions)"

    def execute(self):
        def run(table):
            yield normalize_df(table.to_pandas(), self._schema)
        return [run(t) for t in self.partitions]


@dataclasses.dataclass(frozen=True)
class PartitioningSpec:
    """Device-neutral partitioning; the planner turns it into a GPU
    partitioner."""
    kind: str  # hash | range | roundrobin | single
    num_partitions: int
    exprs: tuple = ()
    order: tuple = ()


class CpuShuffleExchange(CpuNode):
    """The user's repartition(): an exchange written into the plan (the
    planner's own exchanges are built as GPU execs directly), so it
    keeps its partition count."""
    user_specified = True

    def __init__(self, spec: PartitioningSpec, child: CpuNode):
        super().__init__(child)
        self.spec = spec
        self._schema = child.output_schema()

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return self.spec.num_partitions

    def describe(self):
        return (f"CpuShuffleExchange({self.spec.kind}, "
                f"{self.spec.num_partitions})")

    def execute(self):
        cs = self._schema
        parts = [df for it in self.child.execute() for df in it]
        df = (pd.concat(parts, ignore_index=True) if parts
              else empty_df(cs))
        n = self.spec.num_partitions
        if self.spec.kind == "single" or n == 1:
            return [iter([df])]
        if self.spec.kind == "hash":
            keys = pd.DataFrame({
                f"k{i}": cpu_eval(e, df, cs)
                for i, e in enumerate(self.spec.exprs)})
            codes = pd.util.hash_pandas_object(keys, index=False)
            pid = (codes % n).to_numpy().astype(int)
        elif self.spec.kind == "roundrobin":
            pid = np.arange(len(df)) % n
        else:  # range
            df = CpuSort(list(self.spec.order), CpuSource([df], cs)
                         ).collect()
            pid = np.arange(len(df)) * n // max(1, len(df))
        return [iter([df[pid == p].reset_index(drop=True)])
                for p in range(n)]


class CpuRange(CpuNode):
    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self._schema = T.Schema.of(("id", T.INT64, False))

    def output_partition_count(self) -> int:
        return self.num_partitions

    def output_schema(self):
        return self._schema

    def execute(self):
        vals = np.arange(self.start, self.end, self.step, np.int64)
        bounds = np.linspace(0, len(vals),
                             self.num_partitions + 1).astype(int)
        return [iter([pd.DataFrame(
            {"id": pd.array(vals[bounds[i]:bounds[i + 1]], "Int64")})])
            for i in range(self.num_partitions)]


class CpuUnion(CpuNode):
    """UNION ALL under the first child's schema; the other children's
    frames take its column names by position."""

    def __init__(self, *children: CpuNode):
        super().__init__(*children)
        self._schema = children[0].output_schema()

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return sum(c.output_partition_count() for c in self.children)

    def execute(self):
        names = list(self._schema.names)

        def renamed(it):
            for df in it:
                yield df.set_axis(names, axis=1)
        return [renamed(it) for c in self.children for it in c.execute()]


def _common_types(cs: T.Schema, projections) -> list:
    """Per output column, the common type of what every projection
    puts there."""
    dts = [e.data_type(cs) for e in projections[0]]
    for p in projections[1:]:
        for i, e in enumerate(p):
            dt = e.data_type(cs)
            if dt != dts[i]:
                dts[i] = T.common_type(dts[i], dt)
    return dts


class CpuExpand(CpuNode):
    """Every input row emits one output row per projection list (Spark's
    ExpandExec: the building block of grouping sets, ROLLUP and CUBE).
    Device conversion: exec/expand.py ExpandExec."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: CpuNode):
        super().__init__(child)
        self.projections = [list(p) for p in projections]
        self.names = list(names)
        dts = _common_types(child.output_schema(), self.projections)
        self._schema = T.Schema(tuple(
            T.Field(n, dt) for n, dt in zip(self.names, dts)))

    def output_schema(self):
        return self._schema

    def describe(self):
        return f"CpuExpand({len(self.projections)} projections)"

    def _expand_df(self, df: pd.DataFrame) -> pd.DataFrame:
        cs = self.child.output_schema()
        frames = []
        for p_i, proj in enumerate(self.projections):
            cols = {}
            for n, e in zip(self.names, proj):
                v = cpu_eval(e, df, cs)
                cols[n] = (v.reset_index(drop=True)
                           if isinstance(v, pd.Series) else v)
            f = pd.DataFrame(cols, index=pd.RangeIndex(len(df)))
            f["__row"] = np.arange(len(df))
            f["__proj"] = p_i
            frames.append(f)
        out = pd.concat(frames, ignore_index=True).sort_values(
            ["__row", "__proj"], kind="stable", ignore_index=True)
        return normalize_df(out.drop(columns=["__row", "__proj"]),
                            self._schema)

    def execute(self):
        def run(it):
            for df in it:
                yield self._expand_df(df)
        return [run(it) for it in self.child.execute()]


class CpuGenerate(CpuNode):
    """explode/posexplode of an inline array of expressions (Spark's
    GenerateExec with the generator shape the reference accelerates).
    Device conversion: exec/expand.py GenerateExec."""

    def __init__(self, element_exprs: Sequence[Expression], child: CpuNode,
                 include_pos: bool = False, value_name: str = "col",
                 retained: Optional[Sequence[str]] = None):
        super().__init__(child)
        self.element_exprs = list(element_exprs)
        self.include_pos = include_pos
        self.value_name = value_name
        cs = child.output_schema()
        self.retained = (list(retained) if retained is not None
                         else list(cs.names))
        (dt,) = _common_types(cs, [[e] for e in self.element_exprs])
        fields = [cs.field(n) for n in self.retained]
        if include_pos:
            fields.append(T.Field("pos", T.INT32))
        fields.append(T.Field(value_name, dt))
        self._schema = T.Schema(tuple(fields))

    def output_schema(self):
        return self._schema

    def describe(self):
        return (f"CpuGenerate(explode[{len(self.element_exprs)}], "
                f"pos={self.include_pos})")

    def _as_expand(self) -> CpuExpand:
        from spark_rapids_tpu_torch.exprs.base import (AttributeReference,
                                                       Literal)
        projections = []
        for p, e in enumerate(self.element_exprs):
            proj = [AttributeReference(n) for n in self.retained]
            if self.include_pos:
                proj.append(Literal(p, T.INT32))
            proj.append(e)
            projections.append(proj)
        return CpuExpand(projections, [f.name for f in self._schema.fields],
                         self.child)

    def execute(self):
        return self._as_expand().execute()
