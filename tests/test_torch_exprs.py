"""The date, conditional, arithmetic and string expressions of
spark_rapids_tpu_torch against their spark_rapids_tpu classes, on the
CPU: the same seeded inputs (with nulls) go through both, and values,
strings and null masks must match exactly.  The port's CPU evaluator
(plan/cpu_eval.py) is held to the same answers where it has the
expression.

Edge cases: dates before 1970, leap days and the century years 1900,
2000 and 2100; division by zero; CASE WHEN over strings of different
char capacities and without an else; empty, multi-byte and null
patterns; LIKE's %, _ and escapes; substrings from negative and
out-of-range positions.
"""
import types

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.exec.base import make_eval_context as r_context
from spark_rapids_tpu.exprs import arithmetic as RA
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.exprs import conditional as RC
from spark_rapids_tpu.exprs import datetime_exprs as RDT
from spark_rapids_tpu.exprs import predicates as RP
from spark_rapids_tpu.exprs import string_fns as RS
from spark_rapids_tpu.plan.transitions import batch_from_df as r_batch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import make_eval_context
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.exprs import conditional as C
from spark_rapids_tpu_torch.exprs import datetime_exprs as DT
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs import string_fns as S
from spark_rapids_tpu_torch.plan.cpu_eval import _DISPATCH, cpu_eval
from spark_rapids_tpu_torch.plan.nodes import normalize_df
from spark_rapids_tpu_torch.plan.transitions import batch_from_df

N = 2000


def _ns(types_mod, mods, base):
    ns = types.SimpleNamespace(T=types_mod, col=base.col,
                               Literal=base.Literal, lit=base.lit)
    for m in mods:
        for k, v in vars(m).items():
            if isinstance(v, type) or k == "Nvl":
                setattr(ns, k, v)
    return ns


#: each package's classes under one set of names
PORT = _ns(T, (A, C, DT, P, S), E)
REF = _ns(RT, (RA, RC, RDT, RP, RS), RE)

_SPECIAL_DATES = ["1899-12-31", "1900-01-01", "1900-02-28",
                  "1900-03-01", "1968-02-29", "1969-12-31", "1970-01-01",
                  "1999-12-31", "2000-01-01", "2000-02-29", "2000-03-01",
                  "2000-12-31", "2004-12-27", "2008-12-29", "2010-01-03",
                  "2099-12-31", "2100-01-01", "2100-02-28", "2100-03-01",
                  "2100-12-31"]
_STRINGS = ["", "a", "ab", "abc", "abcabc", "green", "dark green ivory",
            "é", "café", "naïve café", "日本", "日本語テキスト", "a_c", "a%c",
            "50%", "x_y", "\\", "green\\", "\U0001F600 smile", "ivory gre",
            "reen", "abc" * 9]


def _frame(seed: int = 5) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    epoch = np.datetime64("1970-01-01", "D")
    special = np.array([(np.datetime64(d) - epoch).astype(int)
                        for d in _SPECIAL_DATES])
    days = rng.integers(-80_000, 70_000, N)
    days[: len(special)] = special
    days[len(special): 2 * len(special)] = special + 1

    def nulls(values, dtype, share=0.1):
        s = pd.Series(values).astype(dtype)
        s[rng.random(N) < share] = pd.NA
        return s

    def strings(pool):
        out = np.array(pool, dtype=object)[rng.integers(0, len(pool), N)]
        out[rng.random(N) < 0.1] = None
        return out

    b = rng.integers(-4, 5, N).astype(float) * rng.uniform(0.5, 2.0, N)
    b[rng.random(N) < 0.2] = 0.0
    i = rng.integers(-50, 50, N)
    j = rng.integers(-6, 7, N)
    return pd.DataFrame({
        "d": nulls(days, "Int32"),
        "d2": nulls(rng.integers(-30_000, 30_000, N), "Int32"),
        "n": nulls(rng.integers(-1000, 1000, N), "Int32"),
        "m": nulls(rng.integers(-30, 31, N), "Int32"),
        "x": nulls(rng.uniform(-1e4, 1e4, N).round(2), "Float64"),
        "y": nulls(b, "Float64"),
        "i": nulls(i, "Int64"),
        "j": nulls(j, "Int64"),
        "k": nulls(j.astype(np.int32), "Int32"),
        "s": strings(_STRINGS),
        "t": strings(["", "zz", "q", "xyz"]),
        "p": nulls(rng.integers(-12, 13, N), "Int32"),
    })


SCHEMA = [("d", "DATE32"), ("d2", "DATE32"), ("n", "INT32"),
          ("m", "INT32"), ("x", "FLOAT64"), ("y", "FLOAT64"),
          ("i", "INT64"), ("j", "INT64"), ("k", "INT32"), ("s", "STRING"),
          ("t", "STRING"), ("p", "INT32")]


def _schema(types_mod):
    return types_mod.Schema.of(*[(n, getattr(types_mod, t))
                                 for n, t in SCHEMA])


@pytest.fixture(scope="module")
def frame():
    return _frame()


@pytest.fixture(scope="module")
def port_batch(frame):
    return batch_from_df(frame, _schema(T), device="cpu")


@pytest.fixture(scope="module")
def ref_batch(frame):
    return r_batch(frame, _schema(RT))


def _run_port(build, batch):
    expr = build(PORT).bind(_schema(T))
    ctx = make_eval_context(batch.columns, batch.capacity,
                            torch.tensor(N, dtype=torch.int32))
    return expr.eval(ctx).to_numpy(N)


def _run_ref(build, batch):
    import jax.numpy as jnp
    expr = build(REF).bind(_schema(RT))
    ctx = r_context(batch.columns, batch.capacity, jnp.int32(N))
    return expr.eval(ctx).to_numpy(N)


def _assert_same(got, want, what):
    (gv, gok), (wv, wok) = got, want
    np.testing.assert_array_equal(np.asarray(gok, bool),
                                  np.asarray(wok, bool),
                                  err_msg=f"{what}: null masks")
    ok = np.asarray(wok, bool)
    gv, wv = np.asarray(gv)[ok], np.asarray(wv)[ok]
    if wv.dtype == object:
        assert list(gv) == list(wv), what
    else:
        assert gv.dtype == wv.dtype or (gv.dtype.kind == wv.dtype.kind
                                        and gv.itemsize == wv.itemsize), \
            f"{what}: {gv.dtype} vs {wv.dtype}"
        np.testing.assert_array_equal(gv, wv, err_msg=what)


def _check(build, port_batch, ref_batch, frame, name):
    got = _run_port(build, port_batch)
    _assert_same(got, _run_ref(build, ref_batch), name)
    expr = build(PORT)
    if type(expr).__name__ in _DISPATCH:
        cpu = cpu_eval(expr, normalize_df(frame, _schema(T)), _schema(T))
        null = cpu.isna().to_numpy()
        vals = np.array(cpu.astype(object), dtype=object)
        if got[0].dtype != object:
            vals[null] = 0
            vals = vals.astype(got[0].dtype)
        _assert_same(got, (vals, ~null), f"{name} on the CPU evaluator")


DATE_EXPRS = {
    "year": lambda M: M.Year(M.col("d")),
    "month": lambda M: M.Month(M.col("d")),
    "day_of_month": lambda M: M.DayOfMonth(M.col("d")),
    "day_of_week": lambda M: M.DayOfWeek(M.col("d")),
    "day_of_year": lambda M: M.DayOfYear(M.col("d")),
    "quarter": lambda M: M.Quarter(M.col("d")),
    "week_of_year": lambda M: M.WeekOfYear(M.col("d")),
    "last_day": lambda M: M.LastDay(M.col("d")),
    "date_add": lambda M: M.DateAdd(M.col("d"), M.col("n")),
    "date_sub": lambda M: M.DateSub(M.col("d"), M.col("n")),
    "date_diff": lambda M: M.DateDiff(M.col("d"), M.col("d2")),
    "add_months": lambda M: M.AddMonths(M.col("d"), M.col("m")),
}

ARITH_EXPRS = {
    "divide": lambda M: M.Divide(M.col("x"), M.col("y")),
    "divide_ints": lambda M: M.Divide(M.col("i"), M.col("j")),
    "divide_by_zero_literal": lambda M: M.Divide(M.col("x"), M.lit(0)),
    "integral_divide": lambda M: M.IntegralDivide(M.col("i"), M.col("j")),
    "remainder_ints": lambda M: M.Remainder(M.col("i"), M.col("k")),
    "remainder_floats": lambda M: M.Remainder(M.col("x"), M.col("y")),
    "pmod_ints": lambda M: M.Pmod(M.col("i"), M.col("j")),
    "pmod_floats": lambda M: M.Pmod(M.col("x"), M.col("y")),
    "unary_minus": lambda M: M.UnaryMinus(M.col("i")),
    "unary_positive": lambda M: M.UnaryPositive(M.col("x")),
    "abs": lambda M: M.Abs(M.col("x")),
}


def _is_green(M):
    return M.EqualTo(M.col("s"), M.lit("green"))


def _flag(M):
    """A predicate that is null on a tenth of the rows."""
    return M.GreaterThan(M.col("n"), M.lit(0))


COND_EXPRS = {
    "case_when_numbers": lambda M: M.CaseWhen(
        ((_is_green(M), M.col("x")),
         (M.GreaterThan(M.col("i"), M.lit(0)), M.col("y"))), M.lit(0.0)),
    "case_when_strings_of_other_widths": lambda M: M.CaseWhen(
        ((_flag(M), M.col("s")),
         (M.LessThan(M.col("i"), M.lit(0)), M.lit("neg"))), M.col("t")),
    "case_when_without_else": lambda M: M.CaseWhen(
        ((_flag(M), M.col("t")),)),
    "case_when_widening": lambda M: M.CaseWhen(
        ((_flag(M), M.col("k")),), M.col("x")),
    "if": lambda M: M.If(_flag(M), M.col("i"), M.col("j")),
    "if_strings": lambda M: M.If(_flag(M), M.col("t"), M.col("s")),
    "coalesce": lambda M: M.Coalesce((M.col("x"), M.col("y"),
                                      M.lit(-1.0))),
    "coalesce_strings": lambda M: M.Coalesce((M.col("t"), M.col("s"))),
    "nvl": lambda M: M.Nvl(M.col("i"), M.col("j")),
    "null_if": lambda M: M.NullIf(M.col("i"), M.col("j")),
    "nvl2": lambda M: M.Nvl2(M.col("s"), M.col("x"), M.col("y")),
    "at_least_n_non_nulls": lambda M: M.AtLeastNNonNulls(
        2, (M.col("x"), M.col("s"), M.Divide(M.col("x"), M.col("y")))),
    "nan_vl": lambda M: M.NaNvl(M.Divide(M.col("y"), M.col("y")),
                                M.col("x")),
}

_PATTERNS = ["", "a", "é", "日本", "green", "abc", "c", "\\", "café",
             "\U0001F600", None]
_LIKES = ["%", "", "a%", "%c", "%green%", "_b%", "a_c", "a\\_c", "a\\%c",
          "%\\%", "%é%", "日_", "__", "%a%b%c%", "abc", "\\\\", "x\\y%",
          None]


def _pattern(M, pat):
    return M.Literal(pat, M.T.STRING) if pat is None else M.lit(pat)


STRING_EXPRS = {
    "length": lambda M: M.Length(M.col("s")),
    **{f"{kind}[{pat!r}]": (lambda M, kind=kind, pat=pat: getattr(
        M, kind)(M.col("s"), _pattern(M, pat)))
       for kind in ("Contains", "StartsWith", "EndsWith")
       for pat in _PATTERNS},
    **{f"like[{pat!r}]": (lambda M, pat=pat: M.Like(M.col("s"),
                                                    _pattern(M, pat)))
       for pat in _LIKES},
    **{f"substring[{pos},{ln}]": (
        lambda M, pos=pos, ln=ln: M.Substring(
            M.col("s"), M.lit(pos), None if ln is None else M.lit(ln)))
       for pos, ln in [(1, 3), (0, 2), (2, None), (-3, 2), (-5, 3),
                       (-100, 4), (100, 2), (3, -1), (1, 0), (-1, None)]},
    "substring_column_positions": lambda M: M.Substring(
        M.col("s"), M.col("p"), M.col("m")),
}


@pytest.mark.parametrize("name", sorted(DATE_EXPRS))
def test_date_expressions_match_the_reference(name, port_batch, ref_batch,
                                              frame):
    _check(DATE_EXPRS[name], port_batch, ref_batch, frame, name)


@pytest.mark.parametrize("name", sorted(ARITH_EXPRS))
def test_arithmetic_matches_the_reference(name, port_batch, ref_batch,
                                          frame):
    _check(ARITH_EXPRS[name], port_batch, ref_batch, frame, name)


@pytest.mark.parametrize("name", sorted(COND_EXPRS))
def test_conditionals_match_the_reference(name, port_batch, ref_batch,
                                          frame):
    _check(COND_EXPRS[name], port_batch, ref_batch, frame, name)


@pytest.mark.parametrize("name", sorted(STRING_EXPRS))
def test_string_expressions_match_the_reference(name, port_batch,
                                                ref_batch, frame):
    _check(STRING_EXPRS[name], port_batch, ref_batch, frame, name)


def test_dates_hold_the_calendar(frame, port_batch):
    """Year/Month/DayOfMonth/DayOfWeek/DayOfYear against Python's own
    calendar on every live row, the special dates included."""
    import datetime
    got = {n: _run_port(DATE_EXPRS[n], port_batch)[0] for n in (
        "year", "month", "day_of_month", "day_of_week", "day_of_year")}
    for r, v in enumerate(frame["d"]):
        if v is pd.NA:
            continue
        d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
        assert (got["year"][r], got["month"][r], got["day_of_month"][r],
                got["day_of_week"][r], got["day_of_year"][r]) == (
            d.year, d.month, d.day, d.isoweekday() % 7 + 1,
            d.timetuple().tm_yday), d


def test_a_pattern_must_be_a_literal(port_batch):
    for kind in ("Contains", "Like"):
        with pytest.raises(TypeError, match="literal pattern"):
            _run_port(lambda M: getattr(M, kind)(M.col("s"), M.col("t")),
                      port_batch)


def test_integer_division_overflow_is_java_s():
    """MIN / -1 is MIN and MIN % -1 is 0, as Java's long arithmetic
    gives them; no division traps."""
    lo = torch.iinfo(torch.int64).min
    cols = [E.ColumnVector(T.INT64, torch.tensor(v, dtype=torch.int64),
                           torch.ones(2, dtype=torch.bool))
            for v in ([lo, 7], [-1, -1])]
    ctx = make_eval_context(cols, 2, torch.tensor(2, dtype=torch.int32))
    a, b = E.BoundReference(0, T.INT64), E.BoundReference(1, T.INT64)
    assert A.IntegralDivide(a, b).eval(ctx).data.tolist() == [lo, -7]
    assert A.Remainder(a, b).eval(ctx).data.tolist() == [0, 0]
    assert A.Pmod(a, b).eval(ctx).data.tolist() == [0, 0]
