"""spark_rapids_tpu_torch's Cast against spark_rapids_tpu's, on the CPU.

* The twins of tests/test_cast_complex.py (all 17 cases): each plan goes
  through both packages' planners (`accelerate` + `collect`) and the
  port's CPU engine; the results must be equal, the port's plan must run
  on the device where the reference's does and fall back to a CPU
  project where the reference's does, with the reference's reason.
* A float -> string and string -> float sweep of 4,096 seeded doubles and
  floats across the exponent range, with +-0, subnormals, NaN and
  +-Infinity, against the reference's functions on the same values.
* Every other cast pair (integers, dates, timestamps and booleans to
  and from strings, the timestamp pairs, ANSI overflow) on seeded
  columns with nulls.

Tolerance: exact everywhere (strings, integers, dates, timestamps,
booleans, float bits and null masks).  One documented band is held
against Python's own shortest round trip instead of the reference:
subnormal floats (the reference's XLA flushes them to zero) and doubles
below 1e-291 (its double-double error terms underflow there; the
reference's cast.py says so).  The port formats those correctly.
"""
import types

import numpy as np
import pandas as pd
import pytest
import torch
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.vector import ColumnVector as RVector
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.exprs import cast as RCa
from spark_rapids_tpu.exprs import complex as RCx
from spark_rapids_tpu.exprs import string_fns as RS
from spark_rapids_tpu.plan import accelerate as r_accelerate
from spark_rapids_tpu.plan import collect as r_collect
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exec.base import TpuExec, make_eval_context
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.exprs import cast as Ca
from spark_rapids_tpu_torch.exprs import complex as Cx
from spark_rapids_tpu_torch.exprs import string_fns as S
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.cpu_eval import _java_float_str
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect


def _ns(types_mod, base, cast, cx, s, nodes):
    return types.SimpleNamespace(
        T=types_mod, col=base.col, Literal=base.Literal, Alias=base.Alias,
        Cast=cast.Cast, GetArrayItem=cx.GetArrayItem,
        CreateArray=cx.CreateArray, CreateMap=cx.CreateMap,
        GetMapValue=cx.GetMapValue, StringSplit=s.StringSplit,
        CpuProject=nodes.CpuProject, CpuSource=nodes.CpuSource)


PORT = _ns(T, E, Ca, Cx, S, N)
REF = _ns(RT, RE, RCa, RCx, RS, RN)

FLOAT_TO_STRING = "spark.rapids.sql.castFloatToString.enabled"
STRING_TO_FLOAT = "spark.rapids.sql.castStringToFloat.enabled"
STRING_TO_TS = "spark.rapids.sql.castStringToTimestamp.enabled"


def _names(plan) -> set:
    out = {type(plan).__name__}
    for c in getattr(plan, "children", ()) or ():
        out |= _names(c)
    return out


def _twin(build, df, conf=None, on_device=True, reason=None):
    """`build(M, source)` through both planners and the port's CPU
    engine; the results must be equal (exact), and the port's plan on the
    device or a CPU project with `reason`.  Returns the result."""
    conf = dict(conf or {})
    ref_plan = build(REF, REF.CpuSource.from_pandas(df))
    want = r_collect(r_accelerate(ref_plan, RC.RapidsConf(conf)))
    plan = build(PORT, PORT.CpuSource.from_pandas(df))
    acc = accelerate(plan, C.RapidsConf(conf), device="cpu")
    if on_device:
        assert isinstance(acc, TpuExec), type(acc).__name__
        assert "ProjectExec" in _names(acc)
    else:
        assert type(acc).__name__ == "CpuProject"
        if reason is not None:
            assert any(reason in r for r in acc._meta.reasons), \
                acc._meta.reasons
    got = collect(acc)
    compare_frames(want, got, "device", rtol=0, atol=0)
    # a collect hands a NaN over as null (the batch-to-pandas boundary of
    # both packages); the CPU engine's frames keep it as a value
    cpu = plan.collect()
    for c in cpu.columns:
        if str(cpu[c].dtype).startswith("Float"):
            cpu[c] = pd.Series(cpu[c].to_numpy(np.float64, na_value=np.nan)
                               ).astype(cpu[c].dtype)
    compare_frames(want, cpu, "CPU engine", rtol=0, atol=0)
    return got


def _project(expr_of):
    return lambda M, src: M.CpuProject([M.Alias(expr_of(M), "r")], src)


def _cast(to, name="v"):
    return _project(lambda M: M.Cast(M.col(name), getattr(M.T, to)))


# -- the twins of tests/test_cast_complex.py ---------------------------------
FLOATS = [1.0, 0.1, -2.5, 1234567.0, 1e7, 0.001, 1e-4, float("inf"),
          -float("inf"), 0.0, -0.0, 3.14159, 123.456, 2.5e-10,
          6.02214076e23]


def test_float_to_string_gated_on():
    got = _twin(_cast("STRING"), pd.DataFrame(
        {"v": np.array(FLOATS, np.float64)}), {FLOAT_TO_STRING: True})
    vals = list(got["r"])
    assert vals[0] == "1.0" and vals[4] == "1.0E7" and vals[6] == "1.0E-4"
    assert vals[8] == "-Infinity" and vals[10] == "-0.0"
    assert vals[14] == "6.02214076E23"


def test_float_to_string_gated_off_falls_back():
    _twin(_cast("STRING"), pd.DataFrame(
        {"v": pd.array([1.5, None], "Float64")}), on_device=False,
        reason="float->string formatting differs from Java at extreme "
               "exponents; enable with " + FLOAT_TO_STRING)


def test_int_to_string_not_gated():
    _twin(_cast("STRING"), pd.DataFrame(
        {"v": pd.array([0, -7, 123, None], "Int64")}))


def test_string_to_float_gated_on():
    vals = ["1.5", " 42 ", "-3.25e2", "1e-3", ".5", "1.", "inf",
            "-Infinity", "NaN", "abc", "", "1.2.3", "1e", "0.1", None]
    got = _twin(_cast("FLOAT64", "s"), pd.DataFrame({"s": vals}),
                {STRING_TO_FLOAT: True})
    assert pd.isna(got["r"][9]) and float(got["r"][3]) == 0.001


def test_string_to_float_gated_off_falls_back():
    _twin(_cast("FLOAT64", "s"), pd.DataFrame({"s": ["1.5", None]}),
          on_device=False,
          reason="string->float parse may differ by 1 ulp from Java; "
                 "enable with " + STRING_TO_FLOAT)


def test_string_to_bool():
    vals = ["true", "FALSE", " t ", "no", "Y", "1", "0", "maybe", "", None]
    got = _twin(_cast("BOOL", "s"), pd.DataFrame({"s": vals}))
    assert got["r"][0] == True and got["r"][1] == False  # noqa: E712
    assert pd.isna(got["r"][7])


def test_string_to_timestamp_gated():
    vals = ["2020-03-01", "2020-03-01 12:34:56", "2020-03-01 12:34:56.5",
            "2020-03-01 12:34:56.123456", "2020-13-01", "2020-02-30",
            "2020-03-01 25:00:00", "nope", None]
    df = pd.DataFrame({"s": vals})
    got = _twin(_cast("TIMESTAMP_US", "s"), df, {STRING_TO_TS: True})
    assert int(got["r"][1]) - int(got["r"][0]) == \
        (12 * 3600 + 34 * 60 + 56) * 1000000
    assert int(got["r"][2]) - int(got["r"][1]) == 500000
    for i in (4, 5, 6, 7):
        assert pd.isna(got["r"][i])
    _twin(_cast("TIMESTAMP_US", "s"), df, on_device=False,
          reason="string->timestamp supports canonical forms only; "
                 "enable with " + STRING_TO_TS)


def _split_df():
    return pd.DataFrame({"s": ["a,b,c", "x", "", ",lead", "trail,", ",,",
                               "a,,c", None]})


def _split_item(pattern, idx, limit=None):
    def expr(M):
        lim = None if limit is None else M.Literal(limit, M.T.INT32)
        return M.GetArrayItem(
            M.StringSplit(M.col("s"), M.Literal(pattern, M.T.STRING), lim),
            M.Literal(idx, M.T.INT32))
    return _project(expr)


@pytest.mark.parametrize("idx", [0, 1, 2, 5])
def test_string_split_index_parity(idx):
    _twin(_split_item(",", idx), _split_df())


def test_string_split_multichar_delim():
    df = pd.DataFrame({"s": ["a::b::c", "::x", "aa:a::b", "::::"]})
    for idx in (0, 1, 2):
        _twin(_split_item("::", idx), df)


def test_string_split_positive_limit():
    _twin(_split_item(",", 1, limit=2), _split_df())


def test_string_split_regex_pattern_falls_back():
    got = _twin(_split_item(r"\d+", 0), pd.DataFrame({"s": ["a1b22c"]}),
                on_device=False,
                reason="split pattern must be a literal without regex "
                       "metacharacters")
    assert list(got["r"]) == ["a"]  # the CPU engine runs the regex


def test_get_array_item_inline():
    got = _twin(_project(lambda M: M.GetArrayItem(
        M.CreateArray((M.col("a"), M.col("b"))), M.col("i"))),
        pd.DataFrame({"a": pd.array([1, 2, None], "Int64"),
                      "b": pd.array([10, 20, 30], "Int64"),
                      "i": pd.array([0, 1, 5], "Int32")}))
    assert list(got["r"][:2]) == [1, 20]
    assert pd.isna(got["r"][2])  # out of range -> null


def test_get_map_value_inline():
    got = _twin(_project(lambda M: M.GetMapValue(
        M.CreateMap((M.Literal("x", M.T.STRING), M.Literal(1, M.T.INT64),
                     M.Literal("y", M.T.STRING), M.Literal(2, M.T.INT64))),
        M.col("k"))), pd.DataFrame({"k": ["x", "y", "z", None]}))
    assert list(got["r"][:2]) == [1, 2]
    assert pd.isna(got["r"][2]) and pd.isna(got["r"][3])


def test_bare_split_falls_back():
    plan = PORT.CpuProject([PORT.Alias(PORT.StringSplit(
        PORT.col("s"), PORT.Literal(",", T.STRING)), "p")],
        PORT.CpuSource.from_pandas(pd.DataFrame({"s": ["a,b"]})))
    acc = accelerate(plan, C.RapidsConf({}), device="cpu")
    assert type(acc).__name__ == "CpuProject"
    assert any("split() result must be indexed" in r
               for r in acc._meta.reasons)


def test_float32_to_string_parity():
    got = _twin(_cast("STRING"), pd.DataFrame(
        {"v": np.array([0.1, 3.14, -2.5, 1e10, 0.001], np.float32)}),
        {FLOAT_TO_STRING: True})
    assert list(got["r"])[:2] == ["0.1", "3.14"]


def test_string_to_float_review_regressions():
    vals = ["0000000000000000001.5", "0.00000000000000000012345",
            "1e0005", "1E+0010", "1e99999", "1e-99999", "\t1.5 ",
            " 0.0001"]
    got = _twin(_cast("FLOAT64", "s"), pd.DataFrame({"s": vals}),
                {STRING_TO_FLOAT: True})
    got = [float(v) for v in got["r"]]
    assert got[0] == 1.5 and got[1] == 1.2345e-19
    assert got[2] == 1e5 and got[3] == 1e10
    assert got[4] == float("inf") and got[5] == 0.0
    assert got[6] == 1.5 and got[7] == 1e-4


def test_string_to_timestamp_trims():
    vals = [" 2020-03-01", "2020-03-01 12:34:56  ", "\t2020-01-01"]
    got = _twin(_cast("TIMESTAMP_US", "s"), pd.DataFrame({"s": vals}),
                {STRING_TO_TS: True})
    assert not got["r"].isna().any()


# -- the sweeps ----------------------------------------------------------------
SWEEP = 4096


def _sweep_doubles(seed: int, dtype) -> np.ndarray:
    """Seeded values across the whole exponent range (random bit
    patterns, both signs), the specials first."""
    rng = np.random.default_rng(seed)
    if dtype == np.float64:
        x = rng.integers(0, 2 ** 63, SWEEP, dtype=np.int64).view(np.float64)
        special = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -1e-310,
                   2.2250738585072014e-308, 1.7976931348623157e308, 0.1,
                   1e7, 9999999.999999998, 0.001, 0.00099999, 1e22, 1e23,
                   123.456, 12345.67, 2.5, 1e-5]
    else:
        x = rng.integers(0, 2 ** 31, SWEEP, dtype=np.int64).astype(
            np.int32).view(np.float32)
        special = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-40,
                   1.17549435e-38, 3.4028235e38, 0.1, 1e7, 0.001, 3.14,
                   16777216.0, 2.5]
    x = np.where(rng.random(SWEEP) < 0.5, -x, x).astype(dtype)
    x[:len(special)] = np.array(special, dtype)
    return x


def _port_strings(fn, *args):
    data, lens = fn(*args)
    data, lens = data.numpy(), lens.numpy()
    return [bytes(data[i, :lens[i]]).decode() for i in range(len(lens))]


def _ref_strings(fn, *args):
    data, lens = fn(*args)
    data, lens = np.asarray(data), np.asarray(lens)
    return [bytes(data[i, :lens[i]]).decode() for i in range(len(lens))]


def _reference_band(x: np.ndarray, f32: bool) -> np.ndarray:
    """Where the reference's formatting or parse is documented to go
    wrong: subnormals, and for doubles |x| < 1e-291."""
    ax = np.abs(x.astype(np.float64))
    tiny = np.finfo(np.float32 if f32 else np.float64).tiny
    low = ax < (tiny if f32 else 1e-291)
    return low & (ax != 0)


@pytest.mark.parametrize("f32", [False, True], ids=["double", "float"])
def test_float_to_string_sweep(f32):
    x = _sweep_doubles(21 if f32 else 20,
                       np.float32 if f32 else np.float64)
    import jax.numpy as jnp
    got = _port_strings(Ca._float_to_string, torch.from_numpy(x), f32)
    want = _ref_strings(RCa._float_to_string, jnp.asarray(x), SWEEP, f32)
    band = _reference_band(x, f32)
    for i in np.nonzero(~band)[0]:
        assert got[i] == want[i], (x[i], got[i], want[i])
    # the band: Python's shortest round trip in Java's notation
    bad = [(x[i], got[i]) for i in np.nonzero(band)[0]
           if got[i] != _java_float_str(float(x[i]), f32)]
    assert len(bad) <= 2 and all(abs(float(v)) < 1e-300 for v, _ in bad), \
        bad
    assert band.sum() >= 5 and (~band).sum() > SWEEP * 0.8


def _sweep_strings(x: np.ndarray) -> np.ndarray:
    """Each value written four ways: repr, 17 digits, scientific with 6
    digits, and fixed with 3 decimals between spaces (repr past 1e15)."""
    out = []
    for i, v in enumerate(x.astype(np.float64)):
        k = i % 4
        out.append(repr(float(v)) if k == 0 else "%.17g" % v if k == 1
                   else "%.6e" % v if k == 2
                   else " %.3f " % v if abs(v) < 1e15 else repr(float(v)))
    out[:12] = ["inf", "-Infinity", "NaN", " +1.5 ", "1e99999", "1e-99999",
                "0001.5000", "-0.0", ".5", "5.", "1.2.3", ""]
    return np.array(out, dtype=object)


@pytest.mark.parametrize("f32", [False, True], ids=["double", "float"])
def test_string_to_float_sweep(f32):
    x = _sweep_doubles(23 if f32 else 22,
                       np.float32 if f32 else np.float64)
    strs = _sweep_strings(x)
    got, gok = Ca._string_to_float(
        ColumnVector.from_numpy(strs, T.STRING, device="cpu"),
        T.FLOAT32 if f32 else T.FLOAT64).to_numpy(SWEEP)
    want, wok = RCa._string_to_float(
        RVector.from_numpy(strs, RT.STRING),
        RT.FLOAT32 if f32 else RT.FLOAT64).to_numpy(SWEEP)
    np.testing.assert_array_equal(gok, wok)
    # the reference flushes float32 subnormals to zero; the parse of
    # doubles agrees everywhere
    band = _reference_band(got, True) if f32 else np.zeros(SWEEP, bool)
    same = (got.view(np.uint8).reshape(SWEEP, -1)
            == want.view(np.uint8).reshape(SWEEP, -1)).all(axis=1)
    assert (same | ~wok | band).all(), strs[~(same | ~wok | band)][:5]
    # the band: within one float32 ulp of the nearest value
    for i in np.nonzero(band & wok)[0]:
        near = np.float32(float(strs[i]))
        assert abs(got[i] - near) <= np.spacing(np.abs(near)), strs[i]


# -- the other pairs, columnar, with nulls ----------------------------------------
N_ROWS = 1500


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(31)
    n = N_ROWS

    def nulls(values, dtype):
        s = pd.Series(values).astype(dtype)
        s[rng.random(n) < 0.1] = pd.NA
        return s
    ints = rng.integers(-2 ** 62, 2 ** 62, n)
    ints[:6] = [0, -1, 2 ** 63 - 1, -2 ** 63, 10 ** 18, -10 ** 18]
    strings = np.array(
        ["0", "-0", "+7", " 42 ", "9223372036854775807",
         "-9223372036854775808", "9223372036854775808", "00012", "1.5",
         "", "  ", "abc", "127", "-128", "128", "32767", "-32769",
         "2147483647", "-2147483649", "1 2", "2020-02-29", "2021-02-29",
         "1969-12-31", "0001-01-01", "2020-1-1", " 2020-01-01",
         "2020-03-01 00:00:00", "1999-12-31 23:59:59.999999",
         "1969-12-31 23:59:59.5", "2020-03-01T00:00:00", "t", "yes",
         "N", "false ", "TRUE"], dtype=object)
    s = strings[rng.integers(0, len(strings), n)]
    s[rng.random(n) < 0.1] = None
    return pd.DataFrame({
        "i64": nulls(ints, "Int64"),
        "i32": nulls(rng.integers(-2 ** 31, 2 ** 31, n), "Int32"),
        "i16": nulls(rng.integers(-2 ** 15, 2 ** 15, n), "Int16"),
        "i8": nulls(rng.integers(-128, 128, n), "Int8"),
        "d": nulls(rng.integers(-200_000, 200_000, n), "Int32"),
        "ts": nulls(rng.integers(-2 ** 56, 2 ** 56, n), "Int64"),
        "f": nulls(np.where(rng.random(n) < 0.2, np.array(
            [np.nan, np.inf, -np.inf, 1e19, -1e19, 0.5])[rng.integers(
                0, 6, n)], rng.normal(0, 1e9, n)), "Float64"),
        # no nulls: the reference's upload cannot fill a null boolean
        "b": rng.random(n) < 0.5,
        "s": s,
    })


SCHEMA = [("i64", "INT64"), ("i32", "INT32"), ("i16", "INT16"),
          ("i8", "INT8"), ("d", "DATE32"), ("ts", "TIMESTAMP_US"),
          ("f", "FLOAT64"), ("b", "BOOL"), ("s", "STRING")]


def _schema(tm):
    return tm.Schema.of(*[(n, getattr(tm, t)) for n, t in SCHEMA])


@pytest.fixture(scope="module")
def batches(frame):
    from spark_rapids_tpu.plan.transitions import batch_from_df as r_batch
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    return (batch_from_df(frame, _schema(T), device="cpu"),
            r_batch(frame, _schema(RT)))


PAIRS = [(src, dst) for src in ("i64", "i32", "i16", "i8", "d", "ts", "b")
         for dst in ("STRING",)] + [
    ("s", dst) for dst in ("INT64", "INT32", "INT16", "INT8", "BOOL",
                           "DATE32", "TIMESTAMP_US", "FLOAT64")] + [
    ("ts", "DATE32"), ("d", "TIMESTAMP_US"), ("ts", "INT64"),
    ("ts", "FLOAT64"), ("ts", "INT32"), ("i64", "TIMESTAMP_US"),
    ("i32", "TIMESTAMP_US"), ("f", "TIMESTAMP_US"), ("i64", "INT8"),
    ("i64", "INT16"), ("i32", "INT8"), ("i8", "INT64"), ("i16", "FLOAT32"),
    ("f", "INT8"), ("f", "INT16"), ("b", "INT8"), ("i8", "BOOL"),
    ("ts", "BOOL")]


def _eval(M, batch, expr, ref: bool):
    bound = expr.bind(_schema(M.T))
    if ref:
        import jax.numpy as jnp
        from spark_rapids_tpu.exec.base import make_eval_context as r_ctx
        ctx = r_ctx(batch.columns, batch.capacity, jnp.int32(N_ROWS))
    else:
        ctx = make_eval_context(batch.columns, batch.capacity,
                                torch.tensor(N_ROWS, dtype=torch.int32))
    return bound.eval(ctx).to_numpy(N_ROWS), ctx


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
        assert gv.dtype == wv.dtype, (what, gv.dtype, wv.dtype)
        np.testing.assert_array_equal(gv, wv, err_msg=what)


@pytest.mark.parametrize("src,dst", PAIRS, ids=[f"{s}-{d}" for s, d in PAIRS])
def test_cast_pairs_match_the_reference(src, dst, batches, frame):
    port_b, ref_b = batches
    got, _ = _eval(PORT, port_b, Ca.Cast(E.col(src), getattr(T, dst)),
                   False)
    want, _ = _eval(REF, ref_b, RCa.Cast(RE.col(src), getattr(RT, dst)),
                    True)
    _assert_same(got, want, f"{src} -> {dst}")
    # the CPU engine (timestamps and dates as their int storage)
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
    from spark_rapids_tpu_torch.plan.nodes import normalize_df
    cpu = cpu_eval(Ca.Cast(E.col(src), getattr(T, dst)),
                   normalize_df(frame, _schema(T)), _schema(T))
    null = cpu.isna().to_numpy()
    vals = np.array(cpu.astype(object), dtype=object)
    if got[0].dtype != object:
        vals[null] = 0
        vals = vals.astype(got[0].dtype)
    _assert_same(got, (vals, ~null), f"{src} -> {dst} on the CPU engine")


ANSI = [("i64", "INT32"), ("i64", "INT8"), ("i32", "INT16"), ("f", "INT64"),
        ("f", "INT16"), ("i8", "INT64")]


@pytest.mark.parametrize("src,dst", ANSI, ids=[f"{s}-{d}" for s, d in ANSI])
def test_ansi_casts_raise_the_reference_s_checks(src, dst, batches):
    """The same overflow flag and label as the reference's, and the same
    values (an ANSI cast computes what the plain one does)."""
    port_b, ref_b = batches
    got, pctx = _eval(PORT, port_b, Ca.Cast(E.col(src), getattr(T, dst),
                                            True), False)
    want, rctx = _eval(REF, ref_b, RCa.Cast(RE.col(src), getattr(RT, dst),
                                            True), True)
    _assert_same(got, want, f"ANSI {src} -> {dst}")
    assert [lbl for lbl, _ in pctx.pending_checks] == \
        [lbl for lbl, _ in rctx.pending_checks]
    assert [bool(f) for _, f in pctx.pending_checks] == \
        [bool(f) for _, f in rctx.pending_checks]
    assert any(bool(f) for _, f in pctx.pending_checks) == (dst != "INT64"
                                                            or src == "f")
