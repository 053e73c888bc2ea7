"""User-defined functions (port of spark_rapids_tpu/udf/): the `tpu_udf`
decorator, the `PythonUDF` expression, and the plan rewrite that
compiles UDF bytecode into the port's expressions.

Reference: `udf-compiler/` (`Plugin.scala:28-94`): a logical-plan rule
finds each UDF, tries to compile its bytecode and keeps the original
UDF on any unsupported construct.  Here `rewrite_udfs` runs at the head
of `accelerate()` under spark.rapids.sql.udfCompiler.enabled; a
`PythonUDF` that does not compile stays in the plan, has no device rule,
and so its node runs on the CPU engine, which row-applies the original
function (spark.rapids.sql.test.enabled names such a node).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import Expression, _lit
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.udf.compiler import compile_udf


@dataclasses.dataclass(eq=False)
class PythonUDF(Expression):
    """An uncompiled user function over child expressions.  It has no
    device rule, so its node falls back to the CPU."""
    fn: Callable
    return_type: T.DataType
    args: tuple

    def data_type(self, schema) -> T.DataType:
        return self.return_type

    def children(self) -> Sequence[Expression]:
        return self.args

    def with_children(self, kids):
        return PythonUDF(self.fn, self.return_type, tuple(kids))

    def eval(self, ctx):
        raise RuntimeError(
            "PythonUDF must be compiled or run on the CPU engine")

    def __repr__(self):
        name = getattr(self.fn, "__name__", "udf")
        return f"{name}({', '.join(map(repr, self.args))})"


def tpu_udf(return_type: T.DataType):
    """Decorator: `@tpu_udf(T.INT64)` makes `fn(col("a"), ...)` build a
    PythonUDF expression (Spark's `udf(...)`)."""

    def wrap(fn: Callable):
        def build(*args) -> PythonUDF:
            return PythonUDF(fn, return_type, tuple(_lit(a) for a in args))
        build.fn = fn
        build.return_type = return_type
        build.__name__ = getattr(fn, "__name__", "udf")
        return build
    return wrap


def compile_expression(e: Expression) -> Expression:
    """Replace every PythonUDF that compiles.  The compiled body is
    simplified (a bytecode `find(x) >= 0` becomes Contains or
    StartsWith, a presence test that needs no character positions) and
    cast to the declared return type, so the plan's schema is the
    fallback's."""
    e = e.map_children(compile_expression)
    if isinstance(e, PythonUDF):
        compiled = compile_udf(e.fn, list(e.args))
        if compiled is not None:
            from spark_rapids_tpu_torch.exprs.simplify import simplify
            return Cast(simplify(compiled), e.return_type)
    return e


def _compile_all(exprs: list) -> list:
    return [compile_expression(x) for x in exprs]


def _changed(new: list, old: list) -> bool:
    return any(a is not b for a, b in zip(new, old))


def rewrite_udfs(node):
    """The plan-wide UDF compilation pass (reference
    LogicalPlanRules.apply).  Returns a new tree; the input is never
    mutated."""
    from spark_rapids_tpu_torch.exprs.aggregates import AggAlias
    from spark_rapids_tpu_torch.plan import nodes as N
    new_children = [rewrite_udfs(c) for c in node.children]
    changed = _changed(new_children, node.children)
    rewrites = {}
    if isinstance(node, N.CpuProject):
        new = _compile_all(node.exprs)
        if _changed(new, node.exprs):
            rewrites["exprs"] = new
    elif isinstance(node, N.CpuFilter):
        ne = compile_expression(node.condition)
        if ne is not node.condition:
            rewrites["condition"] = ne
    elif isinstance(node, N.CpuAggregate):
        ng = _compile_all(node.group_exprs)
        if _changed(ng, node.group_exprs):
            rewrites["group_exprs"] = ng
        na = []
        for a in node.aggregates:
            if a.func.child is not None:
                nc = compile_expression(a.func.child)
                if nc is not a.func.child:
                    f = copy.copy(a.func)
                    f.child = nc
                    a = AggAlias(f, a.name)
            na.append(a)
        if _changed(na, node.aggregates):
            rewrites["aggregates"] = na
    elif isinstance(node, N.CpuHashJoin):
        nl = _compile_all(node.left_keys)
        nr = _compile_all(node.right_keys)
        if _changed(nl + nr, node.left_keys + node.right_keys):
            rewrites["left_keys"] = nl
            rewrites["right_keys"] = nr
        if node.condition is not None:
            ncond = compile_expression(node.condition)
            if ncond is not node.condition:
                rewrites["condition"] = ncond
    if not changed and not rewrites:
        return node
    out = copy.copy(node)
    out.children = new_children
    for k, v in rewrites.items():
        setattr(out, k, v)
    return out
