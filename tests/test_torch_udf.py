"""spark_rapids_tpu_torch's UDF compiler (udf/) against spark_rapids_tpu's:
twins of the 37 compiler and planner cases of tests/test_udf.py (its
pandas-exec, semaphore, worker-pool and daemon cases are in
tests/test_torch_pyudf.py).

Every UDF is compiled by both packages, which must agree on whether it
compiles and on the expression tree it compiles to; each compiled
expression is then evaluated by both packages' accelerated paths over
the same frame (the JAX package on its CPU backend, the port with
device="cpu") and the results must be equal exactly, nulls included.
Where the reference checks the compiled result against the Python
function applied row by row, the port is held to its own CPU engine with
the compiler off, which row-applies the function.  The cases named
`test_compiles_and_matches[...]` carry the reference test's name in
their id.  ~20 s alone on one CPU thread, most of it the JAX package
compiling each expression.
"""
import math
import types

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu import udf as rudf
from spark_rapids_tpu.exec.base import TpuExec as RTpuExec
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.models import tpcxbb as RX
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu.udf import compiler as rcompiler
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch import udf
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exprs import string_fns as S
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.models import tpcxbb as X
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O
from spark_rapids_tpu_torch.plan.transitions import RowToColumnarExec
from spark_rapids_tpu_torch.udf import compiler
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

REF = types.SimpleNamespace(C=RC, T=RT, col=rcol, N=RN, udf=rudf,
                            compile_udf=rcompiler.compile_udf,
                            Exec=RTpuExec, kw={},
                            accelerate=RO.accelerate, collect=RO.collect)
PORT = types.SimpleNamespace(C=C, T=T, col=col, N=N, udf=udf,
                             compile_udf=compiler.compile_udf, Exec=TpuExec,
                             kw={"device": "cpu"}, accelerate=O.accelerate,
                             collect=O.collect)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _df():
    """The reference test's frame with nulls."""
    return pd.DataFrame({
        "a": pd.array([1, 5, None, -3, 10], dtype="Int64"),
        "b": pd.array([2.0, -1.5, 4.0, None, 0.5], dtype="Float64"),
        "s": pd.array(["Hi", "world", None, "Ab", "zzz"], dtype=object),
    })


def _dense_df():
    """The reference's null-free frame of its opcode cases (a compiled
    expression propagates nulls where raw Python sees None as a
    value)."""
    return pd.DataFrame({
        "a": pd.array([1, 5, 7, -3, 10], dtype="Int64"),
        "b": pd.array([2.0, -1.5, 4.0, 9.25, 0.5], dtype="Float64"),
        "s": pd.array(["Hi", "world", "or bit", "Ab", "zzz"], dtype=object),
    })


def _norm(df):
    df = df.reset_index(drop=True)
    for name in df.columns:
        if df[name].dtype == object:
            df[name] = df[name].where(df[name].notna(), None)
    return df


def _assert_same(want, got):
    pd.testing.assert_frame_equal(_norm(want), _norm(got),
                                  check_dtype=False, check_exact=True)


def _shape(e):
    """An expression tree as nested (class name, literal, children)."""
    return (type(e).__name__, repr(getattr(e, "value", None)),
            tuple(_shape(c) for c in e.children()))


def _run(m, plan, conf=None):
    conf = conf or m.C.RapidsConf()
    out = m.accelerate(plan, conf, **m.kw)
    return out, m.collect(out, conf)


def _project(m, fn, ret, cols, df, parts=1):
    build = m.udf.tpu_udf(getattr(m.T, ret))(fn)
    return m.N.CpuProject([build(*[m.col(c) for c in cols]).alias("r")],
                          m.N.CpuSource.from_pandas(df, parts))


def _both_compile(fn, cols):
    """Both packages' compiled trees, which must have the same shape."""
    ref = REF.compile_udf(fn, [rcol(c) for c in cols])
    ours = PORT.compile_udf(fn, [col(c) for c in cols])
    assert (ref is None) == (ours is None)
    if ours is not None:
        assert _shape(ours) == _shape(ref)
    return ours


def _compare_both(fn, ret, cols, df, golden=False, parts=1):
    """The UDF compiles in both packages, runs wholly on the device in
    both, and their results are equal; with `golden`, the port's result
    also equals its CPU engine's row-apply of the Python function."""
    assert _both_compile(fn, cols) is not None
    ref_plan, want = _run(REF, _project(REF, fn, ret, cols, df, parts))
    plan, got = _run(PORT, _project(PORT, fn, ret, cols, df, parts))
    assert isinstance(ref_plan, RTpuExec) and isinstance(plan, TpuExec)
    _assert_same(want, got)
    if golden:
        _assert_same(_project(PORT, fn, ret, cols, df, parts).collect(),
                     got)
    return got


def _conditional(x):
    if x > 3:
        return x * 2
    return x - 1


def _nested(x, y):
    if x > 3:
        return x * 2 + y
    return abs(x) if y > 0 else 0


def _closure():
    k = 7

    def f(x):
        return x + k
    return f


def _locals(x, y):
    t = x * 2
    u = t + y
    return u - 1


def _none_checks(x):
    if x is None:
        return 0
    return x + 1


def _min3(a, b, c):
    return min(a, b, c)


#: (reference test, fn, return type, columns, frame, golden row-apply)
CASES = [
    ("test_compile_arithmetic", lambda x: x * 2 + 1, "INT64", ["a"],
     _df, False),
    ("test_compile_conditional", _conditional, "INT64", ["a"], _df, False),
    ("test_compile_nested_conditional_and_ternary", _nested, "FLOAT64",
     ["a", "b"], _df, False),
    ("test_compile_string_methods-upper", lambda s: s.upper(), "STRING",
     ["s"], _df, False),
    ("test_compile_string_methods-len-strip", lambda s: len(s.strip()),
     "INT32", ["s"], _df, False),
    ("test_compile_math_module",
     lambda x: math.sqrt(x) + math.log(x), "FLOAT64", ["b"], _df, False),
    ("test_compile_closure_constant", _closure(), "INT64", ["a"], _df,
     False),
    ("test_compile_local_variables", _locals, "FLOAT64", ["a", "b"], _df,
     False),
    ("test_compile_none_checks", _none_checks, "INT64", ["a"], _df, False),
    ("test_fallback_on_arity_mismatch-min3", _min3, "INT64",
     ["a", "a", "a"], _dense_df, True),
    ("test_module_level_math_still_compiles", lambda x: math.floor(x),
     "INT64", ["b"], _df, False),
    ("test_compile_in_tuple_literal", lambda x: x in (1, 5, 99), "BOOL",
     ["a"], _dense_df, True),
    ("test_compile_not_in_tuple_literal", lambda x: x not in (1, 5),
     "BOOL", ["a"], _dense_df, True),
    ("test_compile_substring_contains", lambda s: "or" in s, "BOOL",
     ["s"], _dense_df, True),
    ("test_compile_boolean_short_circuit-and",
     lambda x, y: x > 2 and y > 0, "BOOL", ["a", "b"], _dense_df, True),
    ("test_compile_boolean_short_circuit-or",
     lambda x, y: x > 7 or y < 0, "BOOL", ["a", "b"], _dense_df, True),
    ("test_compile_chained_comparison", lambda x: -2 < x < 6, "BOOL",
     ["a"], _dense_df, True),
    ("test_compile_variadic_min_max-min", lambda x, y: min(x, y, 3),
     "FLOAT64", ["a", "b"], _dense_df, True),
    ("test_compile_variadic_min_max-max", lambda x, y: max(x, y, 3),
     "FLOAT64", ["a", "b"], _dense_df, True),
    ("test_compile_ljust_rjust_match_python-ljust",
     lambda s: s.ljust(4, "_"), "STRING", ["s"], _dense_df, True),
    ("test_compile_ljust_rjust_match_python-rjust",
     lambda s: s.rjust(4, "*"), "STRING", ["s"], _dense_df, True),
    ("test_compile_unary_positive", lambda x: +x + 1, "INT64", ["a"],
     _dense_df, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compiles_and_matches(case):
    _, fn, ret, cols, frame, golden = case
    _compare_both(fn, ret, cols, frame(), golden)


def test_compile_conditional_is_an_if():
    assert type(_both_compile(_conditional, ["a"])).__name__ == "If"
    assert type(_both_compile(lambda s: s.upper(), ["s"])).__name__ == \
        "Upper"


def _loop(x):
    t = 0
    for _ in range(3):
        t += x
    return t


def _hash(x):
    return hash(x)


def _closes_over_a_dict():
    d = {"k": 1}

    def f(x):
        return x + d["k"]
    return f


def _min1(a):
    return min(a)


def _shadowed():
    mod = types.ModuleType("shadow_mod")
    exec("def round(x):\n    return x * 1000\n"
         "def f(v):\n    return round(v)", mod.__dict__)
    return mod.f


FALLBACKS = [
    ("test_fallback_on_loop", _loop, ["a"]),
    ("test_fallback_on_unsupported_call", _hash, ["a"]),
    ("test_fallback_on_closure_object", _closes_over_a_dict(), ["a"]),
    ("test_floor_division_falls_back", lambda x: x // 2, ["a"]),
    ("test_compile_in_non_literal_set_falls_back",
     lambda x, y: x in (y, 2), ["a", "b"]),
    ("test_fallback_on_arity_mismatch-min1", _min1, ["a"]),
    ("test_fallback_on_shadowed_builtin", _shadowed(), ["a"]),
]


@pytest.mark.parametrize("case", FALLBACKS, ids=[c[0] for c in FALLBACKS])
def test_falls_back_in_both(case):
    _, fn, cols = case
    assert PORT.compile_udf(fn, [col(c) for c in cols]) is None
    assert REF.compile_udf(fn, [rcol(c) for c in cols]) is None


# -- through the planner -----------------------------------------------------
def test_compiled_udf_runs_on_tpu():
    _compare_both(lambda x: x * 2 + 1, "INT64", ["a"], _df())


def test_compiled_conditional_udf_parity():
    def f(x, y):
        if x is None:
            return 0.0
        if y is None:
            return 0.0
        return float(x) * 2 if y > 0 else float(-x)

    for m in (REF, PORT):
        build = m.udf.tpu_udf(m.T.FLOAT64)(f)
        m.plan = m.N.CpuProject(
            [m.col("a"), build(m.col("a"), m.col("b")).alias("r")],
            m.N.CpuSource.from_pandas(_df()))
    _assert_same(_run(REF, REF.plan)[1], _run(PORT, PORT.plan)[1])
    _assert_same(PORT.plan.collect(), _run(PORT, PORT.plan)[1])


def test_compiled_string_udf_parity():
    got = _compare_both(lambda s: s.upper(), "STRING", ["s"], _df())
    assert got["r"].tolist()[:2] == ["HI", "WORLD"]


def test_uncompilable_udf_falls_back_to_cpu():
    calls = []

    def weird(x):
        calls.append(1)  # a side effect: never compilable
        return (x * 7 + 3) % 5 if x is not None else None

    plan, got = _run(PORT, _project(PORT, weird, "INT64", ["a"], _df()))
    assert not isinstance(plan, TpuExec)  # the project stayed on the CPU
    assert calls  # the original function ran
    _, want = _run(REF, _project(REF, weird, "INT64", ["a"], _df()))
    _assert_same(want, got)


def test_udf_compiler_disabled_conf():
    for m in (REF, PORT):
        c = m.C.RapidsConf({"spark.rapids.sql.udfCompiler.enabled": False})
        plan, got = _run(m, _project(m, lambda x: x + 1, "INT64", ["a"],
                                     _df()), c)
        assert not isinstance(plan, m.Exec)
        m.got = got
    _assert_same(REF.got, PORT.got)


def test_udf_in_filter():
    for m in (REF, PORT):
        is_big = m.udf.tpu_udf(m.T.BOOL)(lambda x: x > 3)
        plan, m.got = _run(m, m.N.CpuFilter(
            is_big(m.col("a")), m.N.CpuSource.from_pandas(_df())))
        assert isinstance(plan, m.Exec)
    _assert_same(REF.got, PORT.got)
    assert PORT.got["a"].tolist() == [5, 10]


def test_null_propagation_parity():
    got = _compare_both(lambda x: x + 1, "INT64", ["a"], _df())
    assert got["r"].isna().tolist() == [False, False, True, False, False]


def test_python_modulo_semantics_parity():
    df = pd.DataFrame({"a": pd.array([-7, -1, 0, 1, 7], dtype="Int64")})
    got = _compare_both(lambda x: x % 3, "INT64", ["a"], df, golden=True)
    assert got["r"].tolist() == [(-7) % 3, (-1) % 3, 0, 1, 1]


def test_string_slice_compiles():
    df = pd.DataFrame({"s": pd.array(["hello", "ab", "x", None],
                                     dtype=object)})
    got = _compare_both(lambda s: s[:2], "STRING", ["s"], df)
    assert got["r"].tolist()[:3] == ["he", "ab", "x"]


def test_cpu_udf_real_bugs_surface():
    # a type bug on non-null data raises, it does not quietly give null
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
    df = pd.DataFrame({"a": pd.array([1, 2], dtype="Int64")})
    bad = udf.PythonUDF(lambda x: x.upper(), T.STRING, (col("a"),))
    with pytest.raises(AttributeError):
        cpu_eval(bad, df, T.Schema.of(("a", T.INT64)))


def test_tpcxbb_q27_runs_compiled_not_fallback():
    """q27's UDF goes through the compiler and runs on the device: an
    uncompiled PythonUDF would leave a CPU island under a
    RowToColumnarExec."""
    tables = X.gen_tables(np.random.default_rng(4), 2000)
    conf = C.RapidsConf({"spark.rapids.sql.variableFloatAgg.enabled": True})
    plan = O.accelerate(X.QUERIES["q27"](X.sources(tables, 2),
                                         lambda p: None), conf, "cpu")
    assert isinstance(plan, TpuExec), plan

    def no_cpu_bridge(p):
        assert not isinstance(p, RowToColumnarExec), plan.tree_string()
        for c in p.children:
            no_cpu_bridge(c)
    no_cpu_bridge(plan)
    rconf = RC.RapidsConf({"spark.rapids.sql.variableFloatAgg.enabled": True})
    ref = RO.accelerate(RX.QUERIES["q27"](RX.sources(
        RX.gen_tables(np.random.default_rng(4), 2000), 2), lambda p: None),
        rconf)
    assert isinstance(ref, RTpuExec)


def _exprs_in(e):
    yield e
    for c in e.children():
        yield from _exprs_in(c)


def test_compiled_find_simplifies_to_contains():
    """The simplifier collapses the compiler's `find(x) CMP k` into
    Contains or StartsWith, in both packages alike."""
    def has_sub(s):
        if s is None:
            return 0
        if s.find("needle") >= 0:
            return 1
        return 0

    def not_found(s):
        return s.find("x") == -1

    def prefixed(s):
        return s.find("pre") == 0

    for fn, ret, want in ((has_sub, "INT64", S.Contains),
                          (not_found, "BOOL", S.Contains),
                          (prefixed, "BOOL", S.StartsWith)):
        ours = udf.compile_expression(
            udf.tpu_udf(getattr(T, ret))(fn)(col("s")))
        ref = rudf.compile_expression(
            rudf.tpu_udf(getattr(RT, ret))(fn)(rcol("s")))
        kinds = [type(x) for x in _exprs_in(ours)]
        assert want in kinds and S.StringLocate not in kinds, (fn, ours)
        assert _shape(ours) == _shape(ref)


def test_simplified_find_parity():
    """Row-level parity of the simplified Contains shapes with the
    Python function, nulls included, and with the reference."""
    def flag(s):
        if s is None:
            return -7
        if s.find("qu") >= 0 or s.find("val") >= 0:
            return 1
        return 0

    vals = ["quality", "evaluate", "plain", None, "", "qval", "vaqul"]
    df = pd.DataFrame({"s": vals})
    for m in (REF, PORT):
        build = m.udf.tpu_udf(m.T.INT64)(flag)
        _, m.got = _run(m, m.N.CpuProject(
            [m.col("s"), build(m.col("s")).alias("f")],
            m.N.CpuSource.from_pandas(df)))
    _assert_same(REF.got, PORT.got)
    exp = [(-7 if v is None else
            (1 if ("qu" in v or "val" in v) else 0)) for v in vals]
    assert PORT.got["f"].astype("int64").tolist() == exp


def test_the_compiled_plan_keeps_the_declared_schema():
    """The compiled body is cast to the declared type, so the schema of
    the rewritten plan is the fallback's."""
    plan = _project(PORT, lambda x: x > 3, "INT64", ["a"], _df())
    rewritten = udf.rewrite_udfs(plan)
    assert rewritten is not plan and plan.exprs[0].child.__class__ is \
        udf.PythonUDF
    assert type(rewritten.exprs[0].child).__name__ == "Cast"
    assert rewritten.output_schema() == plan.output_schema()
