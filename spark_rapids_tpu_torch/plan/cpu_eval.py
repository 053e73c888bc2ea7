"""Host (CPU) expression interpreter over pandas (port of
spark_rapids_tpu/plan/cpu_eval.py, cut to the expression kinds the port
has).

It evaluates the same `Expression` trees with pandas and numpy under
Spark semantics (null propagation, Kleene and/or, x / 0 is null).  It is both the
engine of a node the planner leaves on the CPU and the golden for the
CPU tests.  Column storage matches the device model: DATE32 is int32
days.  Nulls ride pandas nullable dtypes (Int64/Float64/boolean, object
for strings).
"""
from __future__ import annotations

import numpy as np
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
        out_dt = e.data_type(schema)
        if op == "div":
            lf, rf = l.astype("Float64"), r.astype("Float64")
            res = lf / rf
            res[rf == 0] = pd.NA  # Spark: x / 0 is null
            return res
        if op == "mod":
            # truncated modulo, the sign follows the dividend (Java), not
            # Python's floored modulo
            lf, rf = l.astype("Float64"), r.astype("Float64")
            res = np.fmod(lf, rf)
            res[rf == 0] = pd.NA
            return res.astype(nullable_dtype(out_dt))
        res = {"add": lambda: l + r, "sub": lambda: l - r,
               "mul": lambda: l * r}[op]()
        return res.astype(nullable_dtype(out_dt))
    return f


def _unary_minus(e, df, schema):
    return -_ev(e.child, df, schema)


def _abs(e, df, schema):
    return _ev(e.child, df, schema).abs()


def _pmod(e, df, schema):
    """fmod, then the divisor added where the signs differ: the device's
    arithmetic, so float results agree to the bit."""
    l, r = _num(_ev(e.left, df, schema)), _num(_ev(e.right, df, schema))
    rem = np.fmod(l, r)
    res = rem.where(~((rem != 0) & ((rem < 0) != (r < 0))), rem + r)
    res[r == 0] = pd.NA
    return res.astype(nullable_dtype(e.data_type(schema)))


# -- predicates -------------------------------------------------------------
def _missing(x) -> bool:
    """A null string value: None, pd.NA or the float NaN pandas gives a
    missing entry of a str column."""
    return not isinstance(x, str)


def _op_str(a, b, op):
    if _missing(a) or _missing(b):
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


def _eq_null_safe(e, df, schema):
    l, r = _ev(e.left, df, schema), _ev(e.right, df, schema)
    ln, rn = l.isna(), r.isna()
    if l.dtype == object or r.dtype == object:
        eq = pd.Series([_op_str(a, b, "eq") for a, b in zip(l, r)],
                       index=l.index, dtype="boolean")
    else:
        eq = (l == r).astype("boolean")
    return (eq.fillna(False) | (ln & rn)).astype("boolean")


def _isnull(e, df, schema):
    return _ev(e.child, df, schema).isna().astype("boolean")


def _isnotnull(e, df, schema):
    return (~_ev(e.child, df, schema).isna()).astype("boolean")


def _isnan(e, df, schema):
    """Not nullable, as on the device: a null input gives false."""
    v = _ev(e.child, df, schema)
    vals = v.astype("Float64").to_numpy(np.float64, na_value=0.0)
    return pd.Series(np.isnan(vals), index=v.index, dtype="boolean")


def _inset(e, df, schema):
    """Spark's IN: null for a null input, and for an input matching
    nothing when the list holds a null."""
    v = _ev(e.child, df, schema)
    vals = [x for x in e.values if x is not None]
    if v.dtype == object:
        want = {str(x) for x in vals}
        hit = v.map(lambda x: not _missing(x) and x in want)
    else:
        hit = v.isin(vals).fillna(False)
    res = hit.astype("boolean")
    if len(vals) < len(e.values):
        res[~hit.astype(bool)] = pd.NA
    res[v.isna()] = pd.NA
    return res


def _cast(e, df, schema):
    """The pairs exprs/cast.py evaluates: numeric, boolean and date;
    casts to and from strings are not ported."""
    from spark_rapids_tpu_torch.exprs.cast import _INT_BOUNDS, Cast
    v = _ev(e.child, df, schema)
    src, dst = e.child.data_type(schema), e.to
    if src == dst:
        return v
    if not Cast.supported(src, dst, e.ansi):
        raise CpuEvalError(f"cast {src} -> {dst} is not ported")
    if dst.id == T.TypeId.BOOL:
        return (v != 0).astype("boolean")
    if src.is_floating and dst.is_integral:
        # Java: truncate toward zero, NaN -> 0, saturate at the bounds
        lo, hi = _INT_BOUNDS.get(dst.id, _INT_BOUNDS[T.TypeId.INT64])

        x = v.astype("Float64").to_numpy(np.float64, na_value=0.0)
        t = np.trunc(np.where(np.isnan(x), 0.0, x))
        over, under = t >= float(hi), t <= float(lo)
        safe = np.where(over | under, 0.0, t).astype(np.int64)
        data = np.where(over, np.int64(hi), np.where(under, np.int64(lo),
                                                     safe))
        # an INT64-bounded value in a narrower type (DATE32) wraps
        out = pd.Series(data.astype(dst.storage_dtype), index=v.index
                        ).astype(nullable_dtype(dst))
        out[v.isna()] = pd.NA
        return out
    if src.is_integral and dst.is_integral:
        vals = v.to_numpy(np.int64, na_value=0).astype(dst.storage_dtype)
        out = pd.Series(vals, index=v.index).astype(nullable_dtype(dst))
        out[v.isna()] = pd.NA
        return out
    return v.astype(nullable_dtype(dst))


def _and(e, df, schema):
    return (_ev(e.left, df, schema).astype("boolean")
            & _ev(e.right, df, schema).astype("boolean"))


def _or(e, df, schema):
    return (_ev(e.left, df, schema).astype("boolean")
            | _ev(e.right, df, schema).astype("boolean"))


def _not(e, df, schema):
    return ~_ev(e.child, df, schema).astype("boolean")


# -- conditional ------------------------------------------------------------
def _branch(e, df, schema, out_dt):
    """A branch's values in the conditional's result type (INT branches
    widen to a DOUBLE result as on the device)."""
    return _ev(e, df, schema).astype(nullable_dtype(out_dt))


def _holds(pred, df, schema):
    return _ev(pred, df, schema).astype("boolean").fillna(False).astype(
        bool)


def _if(e, df, schema):
    dt = e.data_type(schema)
    return _branch(e.true_value, df, schema, dt).where(
        _holds(e.predicate, df, schema),
        _branch(e.false_value, df, schema, dt))


def _casewhen(e, df, schema):
    dt = e.data_type(schema)
    result = (_branch(e.else_value, df, schema, dt)
              if e.else_value is not None
              else pd.Series([None] * len(df), index=df.index).astype(
                  nullable_dtype(dt)))
    for pred, val in reversed(list(e.branches)):
        result = _branch(val, df, schema, dt).where(
            _holds(pred, df, schema), result)
    return result


def _coalesce(e, df, schema):
    dt = e.data_type(schema)
    out = _branch(e.children()[0], df, schema, dt)
    for c in e.children()[1:]:
        out = out.where(~out.isna(), _branch(c, df, schema, dt))
    return out


# -- strings ----------------------------------------------------------------
def _length(e, df, schema):
    return _ev(e.child, df, schema).map(
        lambda x: None if _missing(x) else len(x)).astype("Int32")


def _substring(e, df, schema):
    v = _ev(e.child, df, schema)
    pos = _ev(e.pos, df, schema)
    if e.length is None:
        ln = pd.Series([2 ** 31 - 1] * len(df), index=df.index)
    else:
        ln = _ev(e.length, df, schema)

    def sub(x, p, l):
        if _missing(x) or pd.isna(p) or pd.isna(l):
            return None
        p, l = int(p), int(l)
        if l < 0:
            return ""
        if p > 0:
            start = p - 1
        elif p == 0:
            start = 0
        else:
            # Spark: the window starts at len + p even before the string,
            # which shrinks the result (substring('abc', -5, 3) = 'a')
            start = len(x) + p
        end = start + l
        if end <= 0:
            return ""
        return x[max(0, start):end]
    return pd.Series([sub(x, p, l) for x, p, l in zip(v, pos, ln)],
                     index=v.index, dtype=object)


def _literal_pattern(e):
    """A pattern must be a literal on both engines; any other expression
    raises rather than reading as a null pattern."""
    if not isinstance(e.pattern, E.Literal):
        raise TypeError(f"{type(e).__name__} requires a literal pattern")
    return e.pattern.value


def _str_pred(test):
    """Boolean string predicate with Spark's nulls (a null input or a
    null pattern gives null)."""
    def f(e, df, schema):
        v = _ev(e.child, df, schema)
        pat = _literal_pattern(e)
        if pat is None:
            return pd.Series([pd.NA] * len(df), index=df.index,
                             dtype="boolean")
        pat = str(pat)
        return v.map(lambda x: None if _missing(x)
                     else test(x, pat)).astype("boolean")
    return f


def _like_to_regex(pat: str) -> str:
    import re
    out, i = [], 0
    while i < len(pat):
        ch = pat[i]
        if ch == "\\" and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + r"\Z"  # $ would accept a trailing newline


def _like(e, df, schema):
    import re
    v = _ev(e.child, df, schema)
    pat = _literal_pattern(e)
    if pat is None:
        return pd.Series([pd.NA] * len(df), index=df.index,
                         dtype="boolean")
    rx = re.compile(_like_to_regex(str(pat)), re.DOTALL)
    return v.map(lambda x: None if _missing(x)
                 else rx.match(x) is not None).astype("boolean")


# -- dates (DATE32 storage: int32 days) ---------------------------------------
def _datefield(attr):
    def f(e, df, schema):
        v = _ev(e.child, df, schema)
        mask = v.isna()
        days = v.fillna(0).astype("int64").to_numpy()
        dts = pd.to_datetime(days, unit="D")
        out = pd.Series(getattr(dts, attr), index=v.index).astype("Int32")
        out[mask] = pd.NA
        return out
    return f


_DISPATCH = {
    "AttributeReference": _attr,
    "BoundReference": _bound,
    "Literal": _literal,
    "Alias": _alias,
    "Add": _arith("add"),
    "Subtract": _arith("sub"),
    "Multiply": _arith("mul"),
    "Divide": _arith("div"),
    "Remainder": _arith("mod"),
    "Pmod": _pmod,
    "UnaryMinus": _unary_minus,
    "Abs": _abs,
    "EqualTo": _cmp("eq"),
    "LessThan": _cmp("lt"),
    "LessThanOrEqual": _cmp("le"),
    "GreaterThan": _cmp("gt"),
    "GreaterThanOrEqual": _cmp("ge"),
    "EqualNullSafe": _eq_null_safe,
    "IsNull": _isnull,
    "IsNotNull": _isnotnull,
    "IsNaN": _isnan,
    "InSet": _inset,
    "Cast": _cast,
    "And": _and,
    "Or": _or,
    "Not": _not,
    "If": _if,
    "CaseWhen": _casewhen,
    "Coalesce": _coalesce,
    "Length": _length,
    "Substring": _substring,
    "Like": _like,
    "Contains": _str_pred(lambda x, p: p in x),
    "StartsWith": _str_pred(lambda x, p: x.startswith(p)),
    "EndsWith": _str_pred(lambda x, p: x.endswith(p)),
    "Year": _datefield("year"),
    "Month": _datefield("month"),
    "DayOfMonth": _datefield("day"),
}

