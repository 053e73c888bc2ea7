"""The date, conditional, arithmetic, string, null-test, IN and cast
expressions of spark_rapids_tpu_torch against their spark_rapids_tpu
classes, on the CPU: the same seeded inputs (with nulls) go through both,
and values, strings and null masks must match exactly.  The port's CPU
evaluator (plan/cpu_eval.py) is held to the same answers where it has
the expression.  Min and Max go through both packages' HashAggregateExec
(grouped, with a merge of two batches, and key-less) and the port's CPU
aggregate.

Edge cases: dates before 1970, leap days and the century years 1900,
2000 and 2100; division by zero; CASE WHEN over strings of different
char capacities and without an else; empty, multi-byte and null
patterns; LIKE's %, _ and escapes; substrings from negative and
out-of-range positions; IN lists with a null, empty strings and none at
all; casts of NaN, infinities and floats past the integer range, and
narrowing casts that wrap; Min/Max over NaN, infinities, empty strings
and groups of nulls alone.
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
from spark_rapids_tpu.exprs import cast as RCa
from spark_rapids_tpu.exprs import conditional as RC
from spark_rapids_tpu.exprs import datetime_exprs as RDT
from spark_rapids_tpu.exprs import predicates as RP
from spark_rapids_tpu.exprs import string_fns as RS
from spark_rapids_tpu.plan.transitions import batch_from_df as r_batch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import make_eval_context
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.exprs import cast as Ca
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
            if isinstance(v, type) or k in ("Nvl", "In"):
                setattr(ns, k, v)
    return ns


#: each package's classes under one set of names
PORT = _ns(T, (A, C, Ca, DT, P, S), E)
REF = _ns(RT, (RA, RC, RCa, RDT, RP, RS), RE)

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
    frame = pd.DataFrame({
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
    # drawn after the columns above, which keep their values
    special = np.array(_SPECIAL_FLOATS)[rng.integers(0, len(_SPECIAL_FLOATS),
                                                     N)]
    f = np.where(rng.random(N) < 0.5, special, rng.uniform(-1e12, 1e12, N))
    frame["f"] = pd.arrays.FloatingArray(f, rng.random(N) < 0.1)
    frame["big"] = nulls(rng.integers(-2 ** 40, 2 ** 40, N), "Int64")
    return frame


#: NaN (not null), infinities, the integer types' edges and past them
_SPECIAL_FLOATS = [np.nan, np.inf, -np.inf, 3e20, -3e20, 2.0 ** 63,
                   -2.0 ** 63, 2.0 ** 31 - 0.5, -2.0 ** 31 - 0.5, 2.0 ** 31,
                   -2.0 ** 31 - 1, 0.0, -0.0, 2.5, -2.5, 1e10]


SCHEMA = [("d", "DATE32"), ("d2", "DATE32"), ("n", "INT32"),
          ("m", "INT32"), ("x", "FLOAT64"), ("y", "FLOAT64"),
          ("i", "INT64"), ("j", "INT64"), ("k", "INT32"), ("s", "STRING"),
          ("t", "STRING"), ("p", "INT32"), ("f", "FLOAT64"),
          ("big", "INT64")]


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


PREDICATE_EXPRS = {
    "in_set_ints": lambda M: M.InSet(M.col("n"), (1, 5, -3, 999, 0)),
    "in_set_ints_with_null": lambda M: M.InSet(M.col("k"), (1, 2, None)),
    "in_set_empty": lambda M: M.InSet(M.col("n"), ()),
    "in_set_floats": lambda M: M.InSet(M.col("f"), (2.5, 0.0, 1e10)),
    "in_set_strings": lambda M: M.InSet(
        M.col("s"), ("", "a", "green", "café", "日本", "never there")),
    "in_set_strings_with_null": lambda M: M.InSet(M.col("t"), ("zz", None)),
    "in_set_substring": lambda M: M.InSet(
        M.Substring(M.col("s"), M.lit(1), M.lit(2)), ("ab", "gr", "日本")),
    "in_list": lambda M: M.In(M.col("i"), [3, -7, 11]),
    "equal_null_safe_ints": lambda M: M.EqualNullSafe(M.col("i"),
                                                      M.col("j")),
    "equal_null_safe_floats": lambda M: M.EqualNullSafe(M.col("f"),
                                                        M.col("x")),
    "equal_null_safe_strings": lambda M: M.EqualNullSafe(M.col("s"),
                                                         M.col("t")),
    "is_null_strings": lambda M: M.IsNull(M.col("s")),
    "is_null_floats": lambda M: M.IsNull(M.col("f")),
    "is_not_null": lambda M: M.IsNotNull(M.col("x")),
    "is_not_null_strings": lambda M: M.IsNotNull(M.col("t")),
    "is_nan": lambda M: M.IsNaN(M.col("f")),
}


def _cast(to, src="f"):
    return lambda M: M.Cast(M.col(src), getattr(M.T, to))


CAST_EXPRS = {
    "float_to_int32": _cast("INT32"),
    "float_to_int64": _cast("INT64"),
    "float_to_float32": _cast("FLOAT32"),
    "float_to_bool": _cast("BOOL"),
    "float_to_date": _cast("DATE32"),
    "int64_to_int32_wraps": _cast("INT32", "big"),
    "int64_to_double": _cast("FLOAT64", "big"),
    "int32_to_int64": _cast("INT64", "n"),
    "int32_to_float32": _cast("FLOAT32", "n"),
    "int32_to_bool": _cast("BOOL", "m"),
    "date_to_int32": _cast("INT32", "d"),
    "date_to_double": _cast("FLOAT64", "d"),
    "double_to_int32": _cast("INT32", "x"),
    "bool_to_int64": lambda M: M.Cast(M.GreaterThan(M.col("n"), M.lit(0)),
                                      M.T.INT64),
    "bool_to_double": lambda M: M.Cast(M.IsNull(M.col("s")), M.T.FLOAT64),
    "same_type": _cast("FLOAT64"),
    "sugar": lambda M: M.col("i").cast(M.T.FLOAT64),
}


@pytest.mark.parametrize("name", sorted(PREDICATE_EXPRS))
def test_predicates_match_the_reference(name, port_batch, ref_batch, frame):
    _check(PREDICATE_EXPRS[name], port_batch, ref_batch, frame, name)


@pytest.mark.parametrize("name", sorted(CAST_EXPRS))
def test_casts_match_the_reference(name, port_batch, ref_batch, frame):
    _check(CAST_EXPRS[name], port_batch, ref_batch, frame, name)


def test_casts_saturate_and_wrap_as_java_does(port_batch, frame):
    """float -> int truncates toward zero, NaN -> 0, and saturates;
    long -> int keeps the low 32 bits."""
    got, ok = _run_port(CAST_EXPRS["float_to_int32"], port_batch)
    f = frame["f"].to_numpy(np.float64, na_value=0.0)
    want = np.where(np.isnan(f), 0, np.clip(np.trunc(np.nan_to_num(
        f, nan=0.0, posinf=2.0 ** 31, neginf=-2.0 ** 32)), -2 ** 31,
        2 ** 31 - 1)).astype(np.int64)
    np.testing.assert_array_equal(got[ok], want[ok])
    got, ok = _run_port(CAST_EXPRS["int64_to_int32_wraps"], port_batch)
    big = frame["big"].to_numpy(np.int64, na_value=0)
    np.testing.assert_array_equal(got[ok], big[ok].astype(np.int32))
    assert np.abs(big[ok]).max() > 2 ** 31


def test_unported_casts_refuse_to_evaluate(port_batch, ref_batch, frame):
    """The casts the port refused before it had the string and ANSI
    casts (double -> string, an ANSI double -> int, string -> int) now
    evaluate, as the reference's do (tests/test_torch_cast.py holds the
    rest)."""
    for to, ansi in ((T.STRING, False), (T.INT32, True)):
        _check(lambda M: M.Cast(M.col("x"), getattr(M.T, to.id.name), ansi),
               port_batch, ref_batch, frame, f"x -> {to}")
    _check(lambda M: M.Cast(M.col("s"), M.T.INT32), port_batch, ref_batch,
           frame, "s -> int32")


def _minmax_frame(seed: int = 9) -> pd.DataFrame:
    """Groups of ints, floats (NaN, infinities), dates and strings (empty
    ones too), with nulls; group 7 holds nulls alone, group 8 NaNs
    alone, and the key itself is null on some rows."""
    rng = np.random.default_rng(seed)
    n = 600
    g = rng.integers(0, 7, n)
    f = np.array([1.5, -2.0, np.nan, np.inf, -np.inf, 0.0, 7.25])[
        rng.integers(0, 7, n)]
    f = np.where(rng.random(n) < 0.5, rng.uniform(-1e3, 1e3, n), f)
    tail = np.arange(n - 24, n)
    g[tail[:12]] = 7
    g[tail[12:]] = 8
    f[tail[12:]] = np.nan
    null = rng.random(n) < 0.15
    null[tail[:12]] = True
    strs = np.array(["", "a", "ab", "b", "café", "日本", "zz", "abc"],
                    dtype=object)[rng.integers(0, 8, n)]
    strs[null] = None
    key = pd.array(g, dtype="Int32")
    key[rng.random(n) < 0.03] = pd.NA
    return pd.DataFrame({
        "g": key,
        "i": pd.arrays.IntegerArray(
            rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64), null),
        "k": pd.arrays.IntegerArray(
            rng.integers(-99, 99, n).astype(np.int32), null),
        "f": pd.arrays.FloatingArray(f, null),
        "d": pd.arrays.IntegerArray(
            rng.integers(-9000, 9000, n).astype(np.int32), null),
        "s": strs,
    })


_MINMAX_SCHEMA = [("g", "INT32"), ("i", "INT64"), ("k", "INT32"),
                  ("f", "FLOAT64"), ("d", "DATE32"), ("s", "STRING")]


def _minmax_aggs(mod, colf):
    return [getattr(mod, fn)(colf(c)).alias(f"{fn.lower()}_{c}")
            for c in ("i", "k", "f", "d", "s") for fn in ("Min", "Max")]


def _minmax_port(frame, keys):
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exprs import aggregates as AG
    schema = T.Schema.of(*[(n, getattr(T, t)) for n, t in _MINMAX_SCHEMA])
    half = len(frame) // 2
    batches = [batch_from_df(part.reset_index(drop=True), schema,
                             device="cpu")
               for part in (frame.iloc[:half], frame.iloc[half:])]
    agg = HashAggregateExec([E.col(k) for k in keys],
                            _minmax_aggs(AG, E.col),
                            LocalBatchSource([batches], device="cpu"))
    return agg.collect().to_pandas()


def _minmax_ref(frame, keys):
    from spark_rapids_tpu.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu.exec.basic import LocalBatchSource
    from spark_rapids_tpu.exprs import aggregates as AG
    schema = RT.Schema.of(*[(n, getattr(RT, t)) for n, t in _MINMAX_SCHEMA])
    half = len(frame) // 2
    batches = [r_batch(part.reset_index(drop=True), schema)
               for part in (frame.iloc[:half], frame.iloc[half:])]
    agg = HashAggregateExec([RE.col(k) for k in keys],
                            _minmax_aggs(AG, RE.col),
                            LocalBatchSource([batches]))
    return agg.collect().to_pandas()


def _minmax_cpu(frame, keys):
    from spark_rapids_tpu_torch.exprs import aggregates as AG
    from spark_rapids_tpu_torch.plan.nodes import CpuAggregate, CpuSource
    schema = T.Schema.of(*[(n, getattr(T, t)) for n, t in _MINMAX_SCHEMA])
    src = CpuSource([normalize_df(frame, schema)], schema)
    return CpuAggregate([E.col(k) for k in keys], _minmax_aggs(AG, E.col),
                        src).collect()


def _same_frames(got, want, keys, what):
    got = got.sort_values(keys).reset_index(drop=True) if keys else got
    want = want.sort_values(keys).reset_index(drop=True) if keys else want
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in want.columns:
        # a float NaN in a column of strings is pandas' missing string
        strings = want[c].dtype == object

        def null(x):
            return x is None or x is pd.NA or (strings and x != x)
        g, w = got[c].astype(object), want[c].astype(object)
        gn, wn = g.map(null).to_numpy(), w.map(null).to_numpy()
        np.testing.assert_array_equal(gn, wn, err_msg=f"{what} {c} nulls")
        for a, b in zip(g[~gn], w[~wn]):
            same = (a == b or (isinstance(a, float) and a != a and b != b))
            assert same, f"{what} {c}: {a!r} != {b!r}"


@pytest.mark.parametrize("keys", [["g"], []], ids=["grouped", "key_less"])
def test_min_max_match_the_reference(keys):
    """Min/Max on the sort lane (grouped, two batches merged) and in the
    key-less reduction: Spark's NaN rule (NaN is the largest value, the
    min only of NaNs alone), null for a group of nulls, strings by their
    bytes; against the reference's exec and the port's CPU aggregate."""
    frame = _minmax_frame()
    got = _minmax_port(frame, keys)
    _same_frames(got, _minmax_ref(frame, keys), keys, "vs the reference")
    _same_frames(got, _minmax_cpu(frame, keys), keys, "vs the CPU engine")
    if keys:
        by = got.set_index("g")
        assert by.loc[7].isna().all()
        assert np.isnan(by.loc[8, "min_f"]) and np.isnan(by.loc[8, "max_f"])
        assert (by.drop(index=[7, 8])["max_f"].isna()
                | np.isnan(by.drop(index=[7, 8])["max_f"].astype(float))
                ).all()
    assert "" in set(got["min_s"].dropna())
    assert max(got["max_s"].dropna()) == "日本"


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
