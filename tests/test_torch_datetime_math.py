"""The timestamp, math and bitwise expressions of spark_rapids_tpu_torch
against their spark_rapids_tpu classes, on the CPU, and the twins of
tests/test_string_datetime.py's timestamp, math and ANSI cases (less
those tests/test_torch_exprs.py already twins).

Seeded columns with nulls: timestamps on both sides of the epoch (micros
that are not whole seconds among them), dates, seconds, doubles with 0,
negatives, NaN and infinities, and integers with shift distances past
their widths.  Both packages evaluate each expression, and so does the
port's CPU engine.

Tolerances: integers, dates, timestamps, booleans, null masks and the
exact float functions (floor, ceil, rint, signum, round, months_between,
degrees) exact; sqrt, cbrt and the transcendentals within rtol 1e-14 of
the reference (XLA and torch use different libm polynomials), and
where the reference's own error passes that, within 1e-15 of the true
value (200-bit mpmath).
"""
import datetime as pydt
import types

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.exec.base import make_eval_context as r_context
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.exprs import bitwise as RB
from spark_rapids_tpu.exprs import datetime_exprs as RD
from spark_rapids_tpu.exprs import math_exprs as RM
from spark_rapids_tpu.plan.transitions import batch_from_df as r_batch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec, make_eval_context
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource, ProjectExec
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.exprs import bitwise as B
from spark_rapids_tpu_torch.exprs import cast as Ca
from spark_rapids_tpu_torch.exprs import datetime_exprs as D
from spark_rapids_tpu_torch.exprs import math_exprs as M_
from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
from spark_rapids_tpu_torch.plan.nodes import (CpuProject, CpuSource,
                                               normalize_df)
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
from spark_rapids_tpu_torch.plan.transitions import batch_from_df

N = 1500


def _ns(types_mod, base, mods):
    ns = types.SimpleNamespace(T=types_mod, col=base.col, lit=base.lit,
                               Literal=base.Literal)
    for m in mods:
        for k, v in vars(m).items():
            if isinstance(v, type):
                setattr(ns, k, v)
    return ns


PORT = _ns(T, E, (D, M_, B))
REF = _ns(RT, RE, (RD, RM, RB))

_DAY = 86_400_000_000


def _frame(seed: int = 23) -> pd.DataFrame:
    rng = np.random.default_rng(seed)

    def nulls(values, dtype):
        s = pd.Series(values).astype(dtype)
        s[rng.random(N) < 0.1] = pd.NA
        return s
    ts = rng.integers(-40 * 365 * _DAY, 60 * 365 * _DAY, N)
    ts[:8] = [0, -1, 1, _DAY - 1, -_DAY, -_DAY + 1, 951_782_400_000_000,
              -2_208_988_800_000_001]
    ts[8:N // 2] -= ts[8:N // 2] % 1_000_000  # whole seconds
    days = rng.integers(-30_000, 30_000, N)
    # last days of months and equal days of the month on both sides
    days[:6] = [18_321, 18_382, 18_291, 18_352, -1, 0]
    f = rng.normal(0, 50, N)
    f = np.where(rng.random(N) < 0.15, np.array(
        [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 0.5, 2.5, -2.5,
         1e300])[rng.integers(0, 11, N)], f)
    return pd.DataFrame({
        "ts": nulls(ts, "Int64"),
        "ts2": nulls(ts[::-1] + rng.integers(-_DAY, _DAY, N), "Int64"),
        "d": nulls(days, "Int32"),
        "d2": nulls(days[::-1], "Int32"),
        "secs": nulls(rng.integers(-2 ** 33, 2 ** 33, N), "Int64"),
        "f": pd.arrays.FloatingArray(f, rng.random(N) < 0.1),
        "g": pd.arrays.FloatingArray(rng.uniform(0.01, 3.0, N),
                                     rng.random(N) < 0.1),
        "i": nulls(rng.integers(-2 ** 62, 2 ** 62, N), "Int64"),
        "j": nulls(rng.integers(-2 ** 31, 2 ** 31, N), "Int32"),
        "sh": nulls(rng.integers(-70, 70, N), "Int32"),
        "r": nulls(rng.integers(-10 ** 6, 10 ** 6, N), "Int64"),
    })


SCHEMA = [("ts", "TIMESTAMP_US"), ("ts2", "TIMESTAMP_US"), ("d", "DATE32"),
          ("d2", "DATE32"), ("secs", "INT64"), ("f", "FLOAT64"),
          ("g", "FLOAT64"), ("i", "INT64"), ("j", "INT32"), ("sh", "INT32"),
          ("r", "INT64")]


def _schema(tm):
    return tm.Schema.of(*[(n, getattr(tm, t)) for n, t in SCHEMA])


@pytest.fixture(scope="module")
def frame():
    return _frame()


@pytest.fixture(scope="module")
def port_batch(frame):
    return batch_from_df(frame, _schema(T), device="cpu")


@pytest.fixture(scope="module")
def ref_batch(frame):
    return r_batch(frame, _schema(RT))


def _ts_lit(M, micros):
    return M.Literal(micros, M.T.TIMESTAMP_US)


EXACT = {
    "hour": lambda M: M.Hour(M.col("ts")),
    "minute": lambda M: M.Minute(M.col("ts")),
    "second": lambda M: M.Second(M.col("ts")),
    "year_of_ts": lambda M: M.Year(M.col("ts")),
    "day_of_week_of_ts": lambda M: M.DayOfWeek(M.col("ts")),
    "months_between_ts": lambda M: M.MonthsBetween(M.col("ts"),
                                                   M.col("ts2")),
    "months_between_dates": lambda M: M.MonthsBetween(M.col("d"),
                                                      M.col("d2")),
    "months_between_ts_date": lambda M: M.MonthsBetween(
        M.col("ts"), _ts_lit(M, 694_224_000_000_000)),
    "unix_timestamp_ts": lambda M: M.UnixTimestamp(M.col("ts")),
    "unix_timestamp_date": lambda M: M.UnixTimestamp(M.col("d")),
    "to_unix_timestamp": lambda M: M.ToUnixTimestamp(M.col("ts")),
    "from_unixtime": lambda M: M.FromUnixTime(M.col("secs")),
    "to_date_ts": lambda M: M.ToDate(M.col("ts")),
    "to_date_date": lambda M: M.ToDate(M.col("d")),
    "trunc_year": lambda M: M.TruncDate(M.col("d"), M.lit("YEAR")),
    "trunc_month": lambda M: M.TruncDate(M.col("d"), M.lit("MM")),
    "trunc_week_ts": lambda M: M.TruncDate(M.col("ts"), M.lit("week")),
    "weekday": lambda M: M.WeekDay(M.col("d")),
    "time_add": lambda M: M.TimeAdd(M.col("ts"), M.Literal(3_600_000_000,
                                                           M.T.INT64)),
    "date_diff_ts": lambda M: M.DateDiff(M.col("ts"), M.col("ts2")),
    "add_months_ts": lambda M: M.AddMonths(M.col("ts"), M.lit(13)),
    "floor": lambda M: M.Floor(M.col("f")),
    "ceil": lambda M: M.Ceil(M.col("f")),
    "rint": lambda M: M.Rint(M.col("f")),
    "signum": lambda M: M.Signum(M.col("f")),
    "degrees": lambda M: M.ToDegrees(M.col("f")),
    "radians": lambda M: M.ToRadians(M.col("f")),
    "round_2": lambda M: M.Round(M.col("f"), 2),
    "round_0": lambda M: M.Round(M.col("f"), 0),
    "round_neg": lambda M: M.Round(M.col("f"), -1),
    "round_int_neg": lambda M: M.Round(M.col("r"), -2),
    "round_int_neg_3": lambda M: M.Round(M.col("j"), -3),
    "round_int": lambda M: M.Round(M.col("i"), 2),
    "bit_and": lambda M: M.BitwiseAnd(M.col("i"), M.lit(255)),
    "bit_or": lambda M: M.BitwiseOr(M.col("i"), M.col("j")),
    "bit_xor": lambda M: M.BitwiseXor(M.col("j"), M.col("sh")),
    "bit_not": lambda M: M.BitwiseNot(M.col("i")),
    "shift_left": lambda M: M.ShiftLeft(M.col("i"), M.col("sh")),
    "shift_left_int": lambda M: M.ShiftLeft(M.col("j"), M.col("sh")),
    "shift_right": lambda M: M.ShiftRight(M.col("i"), M.col("sh")),
    "shift_right_int": lambda M: M.ShiftRight(M.col("j"), M.col("sh")),
    "shift_right_unsigned": lambda M: M.ShiftRightUnsigned(M.col("i"),
                                                           M.col("sh")),
    "shift_right_unsigned_int": lambda M: M.ShiftRightUnsigned(
        M.col("j"), M.col("sh")),
    "shift_right_unsigned_3": lambda M: M.ShiftRightUnsigned(M.col("i"),
                                                             M.lit(3)),
}

CLOSE = {
    "sqrt": lambda M: M.Sqrt(M.col("f")),
    "cbrt": lambda M: M.Cbrt(M.col("f")),
    "exp": lambda M: M.Exp(M.col("g")),
    "expm1": lambda M: M.Expm1(M.col("f")),
    "log": lambda M: M.Log(M.col("f")),
    "log1p": lambda M: M.Log1p(M.col("g")),
    "log2": lambda M: M.Log2(M.col("f")),
    "log10": lambda M: M.Log10(M.col("f")),
    "sin": lambda M: M.Sin(M.col("f")),
    "cos": lambda M: M.Cos(M.col("f")),
    "tan": lambda M: M.Tan(M.col("g")),
    "asin": lambda M: M.Asin(M.col("g")),
    "acos": lambda M: M.Acos(M.col("g")),
    "atan": lambda M: M.Atan(M.col("f")),
    "sinh": lambda M: M.Sinh(M.col("g")),
    "cosh": lambda M: M.Cosh(M.col("g")),
    "tanh": lambda M: M.Tanh(M.col("f")),
    "cot": lambda M: M.Cot(M.col("g")),
    "acosh": lambda M: M.Acosh(M.col("g") + M.lit(1.0)),
    "asinh": lambda M: M.Asinh(M.col("f")),
    "atanh": lambda M: M.Atanh(M.col("g") - M.lit(1.5)),
    "pow": lambda M: M.Pow(M.col("g"), M.col("f")),
    "pow_int_exponent": lambda M: M.Pow(M.col("f"), M.lit(3.0)),
    "atan2": lambda M: M.Atan2(M.col("f"), M.col("g")),
    "logarithm": lambda M: M.Logarithm(M.col("g"), M.col("f")),
}


def _run(M, batch, build):
    expr = build(M).bind(_schema(M.T))
    if M is REF:
        import jax.numpy as jnp
        ctx = r_context(batch.columns, batch.capacity, jnp.int32(N))
    else:
        ctx = make_eval_context(batch.columns, batch.capacity,
                                torch.tensor(N, dtype=torch.int32))
    return expr.eval(ctx).to_numpy(N)


def _assert_same(got, want, what, rtol=0.0):
    (gv, gok), (wv, wok) = got, want
    np.testing.assert_array_equal(np.asarray(gok, bool),
                                  np.asarray(wok, bool),
                                  err_msg=f"{what}: null masks")
    ok = np.asarray(wok, bool)
    gv, wv = np.asarray(gv)[ok], np.asarray(wv)[ok]
    assert gv.dtype == wv.dtype, (what, gv.dtype, wv.dtype)
    if rtol:
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(gv, wv, err_msg=what)


def _cpu(build, frame, like):
    out = cpu_eval(build(PORT), normalize_df(frame, _schema(T)), _schema(T))
    null = out.isna().to_numpy()
    vals = out.to_numpy(like.dtype, na_value=0)
    return vals, ~null


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_expressions_match_the_reference(name, port_batch, ref_batch,
                                               frame):
    got = _run(PORT, port_batch, EXACT[name])
    _assert_same(got, _run(REF, ref_batch, EXACT[name]), name)
    _assert_same(got, _cpu(EXACT[name], frame, got[0]),
                 f"{name} on the CPU engine")


def _mp_truth():
    """Each CLOSE function in 200-bit arithmetic, over its frame columns."""
    import mpmath as mp

    def cbrt(x):
        return mp.cbrt(x) if x >= 0 else -mp.cbrt(-x)
    return {
        "sqrt": (mp.sqrt, "f"), "cbrt": (cbrt, "f"), "exp": (mp.exp, "g"),
        "expm1": (mp.expm1, "f"), "log": (mp.log, "f"),
        "log1p": (mp.log1p, "g"), "log2": (lambda x: mp.log(x, 2), "f"),
        "log10": (mp.log10, "f"), "sin": (mp.sin, "f"), "cos": (mp.cos, "f"),
        "tan": (mp.tan, "g"), "asin": (mp.asin, "g"), "acos": (mp.acos, "g"),
        "atan": (mp.atan, "f"), "sinh": (mp.sinh, "g"),
        "cosh": (mp.cosh, "g"), "tanh": (mp.tanh, "f"), "cot": (mp.cot, "g"),
        "acosh": (lambda x: mp.acosh(x + 1), "g"), "asinh": (mp.asinh, "f"),
        "atanh": (lambda x: mp.atanh(x - 1.5), "g"),
        "pow": (mp.power, "g", "f"),
        "pow_int_exponent": (lambda x: mp.power(x, 3), "f"),
        "atan2": (mp.atan2, "f", "g"),
        "logarithm": (lambda b, x: mp.log(x) / mp.log(b), "g", "f")}


@pytest.mark.parametrize("name", sorted(CLOSE))
def test_transcendentals_match_the_reference(name, port_batch, ref_batch,
                                             frame):
    """Within rtol 1e-14 of the reference, except where the reference
    itself is farther than that from the true value (XLA's atanh near
    +-1, its cbrt at huge and tiny magnitudes, its sqrt by an ulp): there
    the port must be within 1e-15 of the true value, computed with 200
    bits."""
    import mpmath
    got = _run(PORT, port_batch, CLOSE[name])
    want = _run(REF, ref_batch, CLOSE[name])
    np.testing.assert_array_equal(got[1], want[1], err_msg=name)
    ok = np.asarray(want[1], bool)
    g, w = got[0], want[0]
    far = ok & ~np.isclose(g, w, rtol=1e-14, atol=0, equal_nan=True)
    fn, *cols = _mp_truth()[name]
    mpmath.mp.prec = 200
    args = [frame[c].to_numpy(np.float64, na_value=np.nan) for c in cols]
    for i in np.nonzero(far)[0]:
        truth = float(fn(*[mpmath.mpf(float(a[i])) for a in args]))
        assert abs(g[i] - truth) <= 1e-15 * abs(truth), (name, i, g[i],
                                                         truth)
        assert abs(w[i] - truth) > 1e-14 * abs(truth), (name, i)
    assert far.sum() <= 0.05 * ok.sum(), name
    _assert_same(got, _cpu(CLOSE[name], frame, got[0]),
                 f"{name} on the CPU engine")


def test_transcendentals_are_incompatible_unless_enabled():
    """The planner keeps Sin on the CPU unless incompatibleOps is on, with
    the reference's reason."""
    df = pd.DataFrame({"x": pd.array([0.5, 1.0, None], "Float64")})

    def plan():
        return CpuProject([M_.Sin(E.col("x")).alias("s")],
                          CpuSource.from_pandas(df))
    off = accelerate(plan(), C.RapidsConf({}), device="cpu")
    assert type(off).__name__ == "CpuProject"
    assert any("floating point results differ in ulp from the JVM" in r
               for r in off._meta.reasons)
    on = accelerate(plan(), C.RapidsConf(
        {C.INCOMPATIBLE_OPS.key: True}), device="cpu")
    assert isinstance(on, TpuExec)
    np.testing.assert_array_equal(
        collect(on)["s"].to_numpy(float, na_value=np.nan),
        collect(off)["s"].to_numpy(float, na_value=np.nan))


# -- the twins of tests/test_string_datetime.py ------------------------------
def _us(dt: pydt.datetime) -> int:
    return (dt - pydt.datetime(1970, 1, 1)) // pydt.timedelta(microseconds=1)


def _days(s: str) -> int:
    return (pydt.date.fromisoformat(s) - pydt.date(1970, 1, 1)).days


def _proj(exprs, columns, schema):
    b = ColumnarBatch.from_numpy(columns, T.Schema.of(*schema),
                                 device="cpu")
    out = ProjectExec([e.alias(f"r{i}") for i, e in enumerate(exprs)],
                      LocalBatchSource([[b]], device="cpu")).collect()
    res = []
    for c in out.columns:
        v, ok = c.to_numpy(out.num_rows)
        res.append([x.item() if hasattr(x, "item") else x if k else None
                    for x, k in zip(v, ok)])
    return res


def test_timestamp_fields():
    us = np.array([_us(pydt.datetime(2020, 6, 15, 13, 45, 30, 123456)),
                   _us(pydt.datetime(1969, 12, 31, 23, 0, 1))], np.int64)
    t = E.col("t")
    assert _proj([D.Hour(t), D.Minute(t), D.Second(t), D.Year(t)],
                 {"t": us}, [("t", T.TIMESTAMP_US)]) == \
        [[13, 23], [45, 0], [30, 1], [2020, 1969]]


def test_timestamp_to_string_cast():
    us = np.array([_us(pydt.datetime(2020, 6, 15, 13, 45, 30, 123456)),
                   _us(pydt.datetime(2001, 1, 1))], np.int64)
    assert _proj([E.col("t").cast(T.STRING)], {"t": us},
                 [("t", T.TIMESTAMP_US)]) == \
        [["2020-06-15 13:45:30.123456", "2001-01-01 00:00:00"]]


def test_trunc_month():
    days = np.array([_days(s) for s in ("2020-02-15", "2021-02-15",
                                        "2024-12-31")], np.int32)
    assert _proj([D.TruncDate(E.col("d"), E.lit("month"))], {"d": days},
                 [("d", T.DATE32)]) == \
        [[_days("2020-02-01"), _days("2021-02-01"), _days("2024-12-01")]]


def test_months_between():
    cols = {"a": np.array([_days("2020-03-31")], np.int32),
            "b": np.array([_days("2020-01-31")], np.int32)}
    assert _proj([D.MonthsBetween(E.col("a"), E.col("b"))], cols,
                 [("a", T.DATE32), ("b", T.DATE32)]) == [[2.0]]


def test_months_between_timestamp_fraction():
    cols = {"a": np.array([_us(pydt.datetime(2020, 3, 15, 12))], np.int64),
            "b": np.array([_us(pydt.datetime(2020, 2, 15))], np.int64)}
    (got,), = _proj([D.MonthsBetween(E.col("a"), E.col("b"))], cols,
                    [("a", T.TIMESTAMP_US), ("b", T.TIMESTAMP_US)])
    assert abs(got - (1 + 0.5 / 31)) < 1e-8


def test_math_parity():
    x = np.array([0.5, 1.0, 2.0, 4.0])
    got = _proj([M_.Sqrt(E.col("x")), M_.Log(E.col("x")),
                 M_.Pow(E.col("x"), E.lit(3.0))], {"x": x},
                [("x", T.FLOAT64)])
    np.testing.assert_allclose(got[0], np.sqrt(x))
    np.testing.assert_allclose(got[1], np.log(x))
    np.testing.assert_allclose(got[2], x ** 3)


def test_math_tail():
    x = np.array([1.5, 2.0, 0.5, 3.0])
    b = np.array([2.0, 10.0, 2.0, 3.0])
    got = _proj([M_.Cot(E.col("x")), M_.Acosh(E.col("x") + E.lit(1.0)),
                 M_.Asinh(E.col("x")), M_.Atanh(E.col("x") - E.lit(0.4)),
                 M_.Logarithm(E.col("b"), E.col("x") + E.lit(1.0))],
                {"x": x, "b": b}, [("x", T.FLOAT64), ("b", T.FLOAT64)])
    want = [1 / np.tan(x), np.arccosh(x + 1), np.arcsinh(x),
            np.arctanh(x - 0.4), np.log(x + 1) / np.log(b)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)


def test_weekday_timeadd_tounix():
    d = np.array([0, 3, 10227, 19000], np.int32)
    ts = np.array([0, 86400_000_000, 123_456_789, 7], np.int64)
    got = _proj([D.WeekDay(E.col("d")), D.ToUnixTimestamp(E.col("ts")),
                 D.TimeAdd(E.col("ts"), E.Literal(3_600_000_000, T.INT64))],
                {"d": d, "ts": ts}, [("d", T.DATE32),
                                     ("ts", T.TIMESTAMP_US)])
    assert got[0] == [(pydt.date(1970, 1, 1) + pydt.timedelta(days=int(x))
                       ).weekday() for x in d]
    assert got[1] == [int(x) // 1_000_000 for x in ts]
    assert got[2] == [int(x) + 3_600_000_000 for x in ts]


def _ansi_plan(values):
    df = pd.DataFrame({"x": pd.array(values, "Int64")})
    return CpuProject([Ca.Cast(E.col("x"), T.INT32, ansi=True).alias("y")],
                      CpuSource.from_pandas(df))


def test_ansi_cast_overflow_raises():
    plan = _ansi_plan([1, 2, 1 << 40])
    acc = accelerate(plan, C.RapidsConf({}), device="cpu")
    assert isinstance(acc, TpuExec)  # an ANSI numeric cast runs there
    msg = ("ANSI cast int64 -> int32 overflow (spark.sql.ansi.enabled "
           "semantics)")
    with pytest.raises(ArithmeticError, match=msg.replace("(", r"\(")
                       .replace(")", r"\)")):
        collect(acc)
    with pytest.raises(ArithmeticError):  # the CPU engine too
        plan.collect()


def test_ansi_cast_in_range_ok():
    plan = _ansi_plan([1, -5, 1000])
    got = collect(accelerate(plan, C.RapidsConf({}), device="cpu"))
    assert list(got["y"].astype(int)) == [1, -5, 1000]
