"""Host (CPU) expression interpreter over pandas (port of
spark_rapids_tpu/plan/cpu_eval.py).

It evaluates the same `Expression` trees with pandas and numpy under
Spark semantics (null propagation, Kleene and/or, x / 0 is null).  It is both the
engine of a node the planner leaves on the CPU and the golden for the
CPU tests.  Column storage matches the device model: DATE32 is int32
days, TIMESTAMP_US int64 microseconds.  Nulls ride pandas nullable
dtypes (Int64/Float64/boolean, object for strings).

An expression without an entry of its own here (the timestamp fields,
the math and bitwise functions, the rest of the string functions) runs
as the reference's do: its columnar implementation over the frame's
columns as CPU tensors (`_columnar_on_host`), so the CPU engine takes
every expression the planner does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import base as E

_NULLABLE = {
    T.TypeId.BOOL: "boolean",
    T.TypeId.INT8: "Int8",
    T.TypeId.INT16: "Int16",
    T.TypeId.INT32: "Int32",
    T.TypeId.INT64: "Int64",
    T.TypeId.FLOAT32: "Float32",
    T.TypeId.FLOAT64: "Float64",
    T.TypeId.DATE32: "Int32",
    T.TypeId.TIMESTAMP_US: "Int64",
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
        return _columnar_on_host(expr, df, schema)
    return fn(expr, df, schema)


def _columnar_on_host(expr, df, schema) -> pd.Series:
    """`expr`'s columnar implementation over the frame, as CPU tensors.
    An ANSI check it raises fails here as it would at the collect
    boundary."""
    from spark_rapids_tpu_torch.exec.base import make_eval_context
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    if type(expr).eval is E.Expression.eval:
        raise CpuEvalError(f"no CPU implementation for expression "
                           f"{type(expr).__name__}")
    batch = batch_from_df(df.reset_index(drop=True), schema, device="cpu")
    ctx = make_eval_context(batch.columns, batch.capacity,
                            batch.num_rows_i32)
    out = expr.bind(schema).eval(ctx)
    for label, flag in ctx.pending_checks:
        if bool(flag):
            raise ArithmeticError(
                f"{label} (spark.sql.ansi.enabled semantics)")
    vals, valid = out.to_numpy(batch.num_rows)
    if out.dtype.is_string:
        return pd.Series(list(vals), index=df.index, dtype=object)
    if out.dtype.is_floating:  # NaN is a value, not a null
        return pd.Series(pd.arrays.FloatingArray(vals, ~valid),
                         index=df.index)
    res = pd.Series(vals, index=df.index).astype(nullable_dtype(out.dtype))
    res[~valid] = pd.NA
    return res


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


_TRUE_STRINGS = {"t", "true", "y", "yes", "1"}
_FALSE_STRINGS = {"f", "false", "n", "no", "0"}
#: what Spark's UTF8String.trimAll strips: every byte <= 0x20
_TRIM_ALL = "".join(map(chr, range(0x21)))


def _java_float_str(x, f32: bool = False) -> str:
    """Java's Double/Float.toString notation of the shortest round-trip
    digits: plain for 1e-3 <= |x| < 1e7, 'd.dddEexp' outside; a FLOAT
    takes its shortest digits as a float32."""
    import math
    from decimal import Decimal
    x = float(np.float32(x)) if f32 else float(x)
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    neg = "-" if math.copysign(1.0, x) < 0 else ""
    if x == 0.0:
        return neg + "0.0"
    d = Decimal(str(np.float32(abs(x))) if f32 else repr(abs(x)))
    _, digits, _ = d.as_tuple()
    adj = d.adjusted()
    ds = "".join(map(str, digits)).rstrip("0") or "0"
    if -3 <= adj < 7:
        if adj >= 0:
            ip = ds[:adj + 1].ljust(adj + 1, "0")
            fp = ds[adj + 1:] or "0"
        else:
            ip, fp = "0", "0" * (-adj - 1) + ds
        return f"{neg}{ip}.{fp}"
    return f"{neg}{ds[0]}.{ds[1:] or '0'}E{adj}"


def _date_str(days: int) -> str:
    """'yyyy-MM-dd' of days since the epoch, by the civil-date algorithm
    of the device, so that years outside 1-9999 print as the device's
    four digits (each digit of the year floored, as there)."""
    z = days + 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    y = yoe + era * 400 + (m <= 2)
    year = "".join(str((y // p) % 10) for p in (1000, 100, 10, 1))
    return f"{year}-{m:02d}-{d:02d}"


def _timestamp_str(micros: int) -> str:
    """'yyyy-MM-dd HH:mm:ss[.ffffff]', the fraction's trailing zeros
    trimmed."""
    days, rem = divmod(micros, 86_400_000_000)
    secs, us = divmod(rem, 1_000_000)
    h, rs = divmod(secs, 3600)
    mi, sec = divmod(rs, 60)
    out = f"{_date_str(days)} {h:02d}:{mi:02d}:{sec:02d}"
    if us:
        out += ("." + f"{us:06d}").rstrip("0")
    return out


def _parse_date(s: str):
    import datetime as _dt
    import re
    m = re.fullmatch(r"([0-9]{4})-([0-9]{2})-([0-9]{2})", s)
    if not m:
        return None
    try:
        d = _dt.date(*map(int, m.groups()))
    except ValueError:
        return None
    return (d - _dt.date(1970, 1, 1)).days


def _spark_parse_string(x: str, dt: T.DataType):
    """Spark's cast of a string: the integral parse trims spaces, the
    date parse takes 'yyyy-MM-dd' as it is, the others trim every byte
    <= 0x20; anything invalid is None."""
    import re
    from spark_rapids_tpu_torch.exprs.cast import _bounds
    if dt.is_integral and dt.id not in (T.TypeId.DATE32,
                                        T.TypeId.TIMESTAMP_US):
        s = x.strip(" ")
        if not re.fullmatch(r"[+-]?[0-9]+", s):
            return None
        lo, hi = _bounds(dt)
        val = int(s)
        return val if lo <= val <= hi else None
    if dt.id == T.TypeId.DATE32:
        return _parse_date(x)
    s = x.strip(_TRIM_ALL)
    if dt.id == T.TypeId.BOOL:
        low = s.lower()
        return True if low in _TRUE_STRINGS else \
            False if low in _FALSE_STRINGS else None
    if dt.is_floating:
        if not s or "_" in s:
            return None
        try:
            return float(s)
        except ValueError:
            return None
    if dt.id == T.TypeId.TIMESTAMP_US:
        m = re.fullmatch(r"([0-9]{4}-[0-9]{2}-[0-9]{2})"
                         r"(?: ([0-9]{2}):([0-9]{2}):([0-9]{2})"
                         r"(?:\.([0-9]{1,6}))?)?", s)
        if not m:
            return None
        days = _parse_date(m.group(1))
        if days is None:
            return None
        h, mi, sec = (int(g or 0) for g in m.groups()[1:4])
        if h > 23 or mi > 59 or sec > 59:
            return None
        us = int((m.group(5) or "0").ljust(6, "0"))
        return (days * 86400 + h * 3600 + mi * 60 + sec) * 1_000_000 + us
    return None


def _host_map(v: pd.Series, fn, dtype) -> pd.Series:
    """fn over the non-null values (None maps to null; a NaN of a
    nullable float column is a value)."""
    null = v.isna().to_numpy()
    out = pd.Series([None if n else fn(x) for x, n in zip(v, null)],
                    index=v.index, dtype=object)
    return out if dtype == "object" else out.astype(dtype)


def _cast(e, df, schema):
    """Every pair exprs/cast.py evaluates, with the device's semantics:
    Java's saturation and wrapping, timestamps in micros (seconds as
    numbers), Java's strings, Spark's parses; an ANSI overflow
    raises."""
    from spark_rapids_tpu_torch.exprs.cast import _INT_BOUNDS, _bounds
    v = _ev(e.child, df, schema)
    src, dst = e.child.data_type(schema), e.to
    if src == dst:
        return v
    I = T.TypeId
    if dst.is_string:
        if src.is_floating:
            f32 = src.id == I.FLOAT32
            return _host_map(v, lambda x: _java_float_str(x, f32), "object")
        if src.id == I.DATE32:
            return _host_map(v, lambda x: _date_str(int(x)), "object")
        if src.id == I.TIMESTAMP_US:
            return _host_map(v, lambda x: _timestamp_str(int(x)), "object")
        if src.id == I.BOOL:
            return _host_map(v, lambda x: "true" if x else "false",
                             "object")
        return _host_map(v, lambda x: str(int(x)), "object")
    if src.is_string:
        if dst.is_floating:  # a parsed "NaN" is a value, not a null
            vals = _host_map(v, lambda x: _spark_parse_string(str(x), dst),
                             "object")
            null = vals.isna().to_numpy() & ~vals.map(
                lambda x: isinstance(x, float)).to_numpy()
            data = np.array([0.0 if n else x for x, n in zip(vals, null)],
                            dtype=dst.storage_dtype)
            return pd.Series(pd.arrays.FloatingArray(data, null),
                             index=v.index)
        return _host_map(v, lambda x: _spark_parse_string(str(x), dst),
                         nullable_dtype(dst))
    if dst.id == I.BOOL:
        return (v != 0).astype("boolean")
    if src.id == I.BOOL:
        return v.astype("Int64").astype(nullable_dtype(dst))
    if src.is_floating and dst.is_integral:
        # Java: truncate toward zero, NaN -> 0, saturate at the bounds
        lo, hi = _bounds(dst)
        x = v.astype("Float64").to_numpy(np.float64, na_value=0.0)
        t = np.trunc(np.where(np.isnan(x), 0.0, x))
        if e.ansi:
            _ansi_raise(src, dst, (np.isnan(x) | (t < float(lo))
                                   | (t > float(hi))) & v.notna().to_numpy())
        over, under = t >= float(hi), t <= float(lo)
        safe = np.where(over | under, 0.0, t).astype(np.int64)
        data = np.where(over, np.int64(hi), np.where(under, np.int64(lo),
                                                     safe))
        # an INT64-bounded value in a narrower type (DATE32) wraps
        return _with_nulls(data.astype(dst.storage_dtype), v, dst)
    if src.id == I.TIMESTAMP_US and dst.id == I.DATE32:
        micros = v.to_numpy(np.int64, na_value=0)
        return _with_nulls(np.floor_divide(micros, 86_400_000_000)
                           .astype(np.int32), v, dst)
    if src.id == I.DATE32 and dst.id == I.TIMESTAMP_US:
        days = v.to_numpy(np.int64, na_value=0)
        return _with_nulls(days * 86_400_000_000, v, dst)
    if src.id == I.TIMESTAMP_US and dst.is_numeric:
        micros = v.to_numpy(np.int64, na_value=0)
        secs = micros / 1e6 if dst.is_floating else \
            np.floor_divide(micros, 1_000_000)
        return _with_nulls(secs.astype(dst.storage_dtype), v, dst)
    if dst.id == I.TIMESTAMP_US and src.is_numeric:
        if src.is_floating:
            x = v.astype("Float64").to_numpy(np.float64, na_value=0.0)
            bad = ~np.isfinite(x)
            us = np.where(bad, 0.0, x) * 1e6
            # past +-2^63 the bound, as the device's convert
            over, under = us >= 2.0 ** 63, us < -(2.0 ** 63)
            data = np.where(over, np.int64(2 ** 63 - 1), np.where(
                under, np.int64(-(2 ** 63)),
                np.where(over | under, 0.0, us).astype(np.int64)))
            out = _with_nulls(data, v, dst)
            out[bad] = pd.NA
            return out
        return _with_nulls(v.to_numpy(np.int64, na_value=0) * 1_000_000,
                           v, dst)
    if src.is_integral and dst.is_integral:
        vals = v.to_numpy(np.int64, na_value=0)
        if e.ansi and dst.id in _INT_BOUNDS:
            lo, hi = _INT_BOUNDS[dst.id]
            _ansi_raise(src, dst, ((vals < lo) | (vals > hi))
                        & v.notna().to_numpy())
        return _with_nulls(vals.astype(dst.storage_dtype), v, dst)
    return v.astype(nullable_dtype(dst))


def _with_nulls(data: np.ndarray, like: pd.Series, dst) -> pd.Series:
    out = pd.Series(data, index=like.index).astype(nullable_dtype(dst))
    out[like.isna().to_numpy()] = pd.NA
    return out


def _ansi_raise(src, dst, bad: np.ndarray) -> None:
    if bad.any():
        raise ArithmeticError(f"ANSI cast {src} -> {dst} overflow "
                              f"(spark.sql.ansi.enabled semantics)")


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


_ASCII_UPPER = str.maketrans("abcdefghijklmnopqrstuvwxyz",
                             "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_ASCII_LOWER = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                             "abcdefghijklmnopqrstuvwxyz")


def _strmap(fn):
    def f(e, df, schema):
        return _host_map(_ev(e.child, df, schema), fn, "object")
    return f


def _concat(e, df, schema):
    parts = [_ev(c, df, schema) for c in e.children()]
    return pd.Series([None if any(_missing(x) for x in vals)
                      else "".join(vals) for vals in zip(*parts)],
                     index=df.index, dtype=object)


def _get_array_item(e, df, schema):
    """split(s, d)[i] by Java's split (the pattern as a regex, as Spark
    runs it) and array(...)[i] by a per-row select."""
    import re
    from spark_rapids_tpu_torch.exprs.complex import CreateArray
    from spark_rapids_tpu_torch.exprs.string_fns import StringSplit
    n = _ev(e.ordinal, df, schema)
    ch = e.child
    if isinstance(ch, StringSplit):
        if not isinstance(ch.pattern, E.Literal) or ch.pattern.value is None:
            raise TypeError("split pattern must be a literal")
        limit = ch.literal_limit()
        if limit is None:
            raise TypeError("split limit must be a literal")
        rx = re.compile(str(ch.pattern.value))
        s = _ev(ch.child, df, schema)

        def part(x, i):
            if _missing(x) or pd.isna(i):
                return None
            # Java: limit <= 0 keeps every split (0 also drops the
            # trailing empties)
            parts = rx.split(x, maxsplit=0 if limit <= 0 else limit - 1)
            if limit == 0:
                while parts and parts[-1] == "":
                    parts.pop()
            i = int(i)
            return parts[i] if 0 <= i < len(parts) else None
        return pd.Series([part(x, i) for x, i in zip(s, n)],
                         index=df.index, dtype=object)
    if isinstance(ch, CreateArray):
        dt = ch.element_type(schema)
        cols = [_branch(el, df, schema, dt) for el in ch.elements]

        def pick(i, row):
            if pd.isna(i) or not 0 <= int(i) < len(cols):
                return None
            x = cols[int(i)].iloc[row]
            return None if pd.isna(x) else x
        out = pd.Series([pick(i, r) for r, i in enumerate(n)],
                        index=df.index, dtype=object)
        return out if dt.is_string else out.astype(nullable_dtype(dt))
    raise TypeError(f"GetArrayItem over {type(ch).__name__}")


def _get_map_value(e, df, schema):
    from spark_rapids_tpu_torch.exprs.complex import CreateMap
    ch = e.child
    if not isinstance(ch, CreateMap):
        raise TypeError(f"GetMapValue over {type(ch).__name__}")
    dt = ch.value_type(schema)
    key = _ev(e.key, df, schema)
    keys = [_ev(k, df, schema) for k in ch.entries[0::2]]
    vals = [_branch(v, df, schema, dt) for v in ch.entries[1::2]]

    def pick(row):
        kq = key.iloc[row]
        if pd.isna(kq):
            return None
        for kc, vc in zip(keys, vals):
            kv = kc.iloc[row]
            if not pd.isna(kv) and kv == kq:
                x = vc.iloc[row]
                return None if pd.isna(x) else x
        return None
    out = pd.Series([pick(r) for r in range(len(df))], index=df.index,
                    dtype=object)
    return out if dt.is_string else out.astype(nullable_dtype(dt))


# -- dates (DATE32 storage: int32 days) ---------------------------------------
def _datefield(attr):
    def f(e, df, schema):
        v = _ev(e.child, df, schema)
        mask = v.isna()
        days = v.fillna(0).astype("int64").to_numpy()
        if e.child.data_type(schema).id == T.TypeId.TIMESTAMP_US:
            days = np.floor_divide(days, 86_400_000_000)  # micros
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
    # the ASCII folds of the device (Python's own upper() is Unicode's)
    "Upper": _strmap(lambda x: x.translate(_ASCII_UPPER)),
    "Lower": _strmap(lambda x: x.translate(_ASCII_LOWER)),
    "ConcatStrings": _concat,
    "GetArrayItem": _get_array_item,
    "GetMapValue": _get_map_value,
}


def _python_udf(e, df, schema):
    """Row-apply of an uncompiled UDF (udf/__init__.py PythonUDF): the
    CPU engine runs the Python original.  Nulls reach the function as
    None; a body that is not null-safe raises on them, which gives null
    (as the compiled expression propagates it), while an error on
    non-null values surfaces."""
    def values(a: pd.Series) -> list:
        return [None if v is pd.NA or (isinstance(v, float) and v != v)
                else v for v in a.tolist()]
    cols = [values(_ev(a, df, schema)) for a in e.args]
    out = []
    for vals in zip(*cols) if cols else [()] * len(df):
        if None in vals:
            try:
                out.append(e.fn(*vals))
            except (TypeError, AttributeError):
                out.append(None)
        else:
            out.append(e.fn(*vals))
    s = pd.Series(out, index=df.index, dtype=object)
    return s.astype(nullable_dtype(e.return_type))


_DISPATCH["PythonUDF"] = _python_udf


def nested_loop_join(ldf: pd.DataFrame, rdf: pd.DataFrame,
                     condition: Optional[E.Expression],
                     schema: T.Schema) -> pd.DataFrame:
    """The brute-force join on the CPU: every (left, right) row pair,
    left-major, kept where `condition` (over both sides' columns, in
    `schema`) is true."""
    merged = ldf.merge(rdf.add_prefix("__r_"), how="cross")

    def reassemble(frame):
        return pd.concat([
            frame[list(ldf.columns)].reset_index(drop=True),
            frame[[f"__r_{c}" for c in rdf.columns]]
            .rename(columns=lambda c: c[4:]).reset_index(drop=True)],
            axis=1)

    out = reassemble(merged)
    if condition is not None and len(out):
        m = cpu_eval(condition, out, schema)
        out = out[m.astype("boolean").fillna(False).astype(bool)
                  .to_numpy()].reset_index(drop=True)
    return out

