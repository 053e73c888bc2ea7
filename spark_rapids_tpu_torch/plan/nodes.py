"""Device-neutral physical plan nodes with real CPU (pandas) execution
(port of spark_rapids_tpu/plan/nodes.py: source, project, filter, limit,
sort, aggregate and hash join).

These play the role of Spark's own row-based operators: the input of the
plan rewrite (`plan/overrides.py`), and the engine a node runs on when it
is tagged off the GPU.  Each node carries `Expression` trees, which both
engines understand (device: torch columnar evaluation; CPU:
`plan/cpu_eval.py`).  `execute() -> list[Iterator[pd.DataFrame]]` yields
partitions of row chunks.
"""
from __future__ import annotations

import datetime as _dt
from typing import Iterator, Optional, Sequence

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.aggregates import AggAlias
from spark_rapids_tpu_torch.exprs.base import Expression, output_name
from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval, nullable_dtype


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
    """Engine schema of a frame's dtypes; object columns of dates are
    DATE32, other object columns STRING."""
    named = {"Int32": T.INT32, "Int64": T.INT64, "Float32": T.FLOAT32,
             "Float64": T.FLOAT64, "boolean": T.BOOL}
    fields = []
    for name in df.columns:
        s = df[name]
        sd = str(s.dtype)
        kind = getattr(s.dtype, "kind", "O")
        if sd in named:
            dt = named[sd]
        elif kind in ("b", "i", "f"):
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
_AGG_PANDAS = {"Sum": "sum", "Average": "mean", "Count": "count"}


def _agg_op(func):
    """pandas groupby op for an AggregateFunction; Spark's SUM of only
    nulls is NULL (pandas' default min_count=0 would give 0)."""
    if type(func).__name__ == "Sum":
        return lambda s: s.sum(min_count=1)
    return _AGG_PANDAS[type(func).__name__]


def _reduce(s: pd.Series, func):
    fname = type(func).__name__
    if fname == "Count":
        return int(s.notna().sum())
    s2 = s.dropna()
    if not len(s2):
        return None
    return {"Sum": s2.sum, "Average": s2.mean}[fname]()


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
            out = pd.DataFrame([{a.name: _reduce(work[a.name], a.func)
                                 for a in self.aggregates}])
            return [iter([normalize_df(out, self._schema)])]
        grouped = work.groupby(key_names, dropna=False, sort=False)
        out = pd.DataFrame({a.name: grouped[a.name].agg(_agg_op(a.func))
                            for a in self.aggregates}).reset_index()
        return [iter([normalize_df(out, self._schema)])]


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
