"""Host (CPU) expression interpreter over pandas (port of
spark_rapids_tpu/plan/cpu_eval.py, cut to the expression kinds the port
has).

It evaluates the same `Expression` trees with pandas and numpy under
Spark semantics (null propagation, Kleene and/or).  It is both the
engine of a node the planner leaves on the CPU and the golden for the
CPU tests.  Column storage matches the device model: DATE32 is int32
days.  Nulls ride pandas nullable dtypes (Int64/Float64/boolean, object
for strings).
"""
from __future__ import annotations

import pandas as pd

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as E

_NULLABLE = {
    T.TypeId.BOOL: "boolean",
    T.TypeId.INT32: "Int32",
    T.TypeId.INT64: "Int64",
    T.TypeId.FLOAT32: "Float32",
    T.TypeId.FLOAT64: "Float64",
    T.TypeId.DATE32: "Int32",
}


def nullable_dtype(dt: T.DataType) -> str:
    return "object" if dt.is_string else _NULLABLE[dt.id]


class CpuEvalError(NotImplementedError):
    """The expression has no CPU implementation."""


def cpu_eval(expr: E.Expression, df: pd.DataFrame,
             schema: T.Schema) -> pd.Series:
    """Evaluate `expr` over `df`; returns a nullable Series aligned to
    df."""
    fn = _DISPATCH.get(type(expr).__name__)
    if fn is None:
        raise CpuEvalError(f"no CPU implementation for expression "
                           f"{type(expr).__name__}")
    return fn(expr, df, schema)


def _ev(e, df, schema):
    return cpu_eval(e, df, schema)


# -- leaves -----------------------------------------------------------------
def _attr(e, df, schema):
    return df[e.name]


def _bound(e, df, schema):
    return df.iloc[:, e.ordinal]


def _literal(e, df, schema):
    n = len(df)
    if e.value is None:
        return pd.Series([None] * n, index=df.index).astype(
            nullable_dtype(e.dtype))
    if e.dtype.is_string:
        return pd.Series([str(e.value)] * n, index=df.index, dtype=object)
    return pd.Series([e.value] * n, index=df.index).astype(
        nullable_dtype(e.dtype))


def _alias(e, df, schema):
    return _ev(e.child, df, schema)


# -- arithmetic -------------------------------------------------------------
def _num(s: pd.Series) -> pd.Series:
    return s.astype("Float64") if s.dtype == object else s


def _arith(op):
    def f(e, df, schema):
        l, r = _num(_ev(e.left, df, schema)), _num(_ev(e.right, df, schema))
        res = {"add": lambda: l + r, "sub": lambda: l - r,
               "mul": lambda: l * r}[op]()
        return res.astype(nullable_dtype(e.data_type(schema)))
    return f


# -- predicates -------------------------------------------------------------
def _op_str(a, b, op):
    if a is None or b is None or a is pd.NA or b is pd.NA:
        return None
    return {"eq": a == b, "lt": a < b, "le": a <= b,
            "gt": a > b, "ge": a >= b}[op]


def _cmp(op):
    def f(e, df, schema):
        l, r = _ev(e.left, df, schema), _ev(e.right, df, schema)
        if l.dtype == object or r.dtype == object:
            # string compare with null propagation
            res = pd.Series([_op_str(a, b, op) for a, b in zip(l, r)],
                            index=l.index, dtype="boolean")
            res[l.isna() | r.isna()] = pd.NA
            return res
        res = {"eq": l == r, "lt": l < r, "le": l <= r,
               "gt": l > r, "ge": l >= r}[op]
        return res.astype("boolean")
    return f


def _and(e, df, schema):
    return (_ev(e.left, df, schema).astype("boolean")
            & _ev(e.right, df, schema).astype("boolean"))


def _or(e, df, schema):
    return (_ev(e.left, df, schema).astype("boolean")
            | _ev(e.right, df, schema).astype("boolean"))


def _not(e, df, schema):
    return ~_ev(e.child, df, schema).astype("boolean")


_DISPATCH = {
    "AttributeReference": _attr,
    "BoundReference": _bound,
    "Literal": _literal,
    "Alias": _alias,
    "Add": _arith("add"),
    "Subtract": _arith("sub"),
    "Multiply": _arith("mul"),
    "EqualTo": _cmp("eq"),
    "LessThan": _cmp("lt"),
    "LessThanOrEqual": _cmp("le"),
    "GreaterThan": _cmp("gt"),
    "GreaterThanOrEqual": _cmp("ge"),
    "And": _and,
    "Or": _or,
    "Not": _not,
}

