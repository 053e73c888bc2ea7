"""The string functions of spark_rapids_tpu_torch (case folds, trims,
concat, locate, replace, pads, the regex rewrites, split()[i],
substring_index and the inline array/map extractors) against their
spark_rapids_tpu classes, on the CPU.

The same seeded columns (multi-byte characters, spaces, delimiters and
nulls) go through both packages' expressions and through the port's CPU
engine; strings, lengths, integers and null masks must match exactly.
The twins of tests/test_string_datetime.py's string cases (less those
tests/test_torch_exprs.py already twins) hold the port to the same
Python values the reference's tests hold it to.

Tolerance: exact everywhere.
"""
import types

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.exec.base import make_eval_context as r_context
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.exprs import complex as RCx
from spark_rapids_tpu.exprs import string_fns as RS
from spark_rapids_tpu.plan.transitions import batch_from_df as r_batch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import make_eval_context
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource, ProjectExec
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.exprs import complex as Cx
from spark_rapids_tpu_torch.exprs import string_fns as S
from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
from spark_rapids_tpu_torch.plan.nodes import normalize_df
from spark_rapids_tpu_torch.plan.transitions import batch_from_df

N = 1500


def _ns(types_mod, base, mods):
    ns = types.SimpleNamespace(T=types_mod, col=base.col, lit=base.lit,
                               Literal=base.Literal)
    for m in mods:
        for k, v in vars(m).items():
            if isinstance(v, type) or k in ("RLike", "RegExpReplace"):
                setattr(ns, k, v)
    return ns


PORT = _ns(T, E, (S, Cx))
REF = _ns(RT, RE, (RS, RCx))

_STRINGS = ["", " ", "a", "Hello World", "ALL CAPS", "mixedCase",
            "  hi  ", "hi ", " hi", "   ", "a,b,c", ",lead", "trail,", ",,",
            "a,,c", "a::b::c", "::x", "aa:a::b", "::::", "café", "naïve café",
            "日本", "日本語テキスト", "\U0001F600 smile", "x.y.z", ".lead",
            "trail.", "nodot", "aaaa", "abcabc", "lolo", "hello", "xxlo",
            "Customer#000000042", "25-989-741-2988", "11-719-748-3364",
            "AUTOMOBILE", "machinery", "it's  two  spaces", "abc" * 7]


def _frame(seed: int = 17) -> pd.DataFrame:
    rng = np.random.default_rng(seed)

    def strings(pool, share=0.1):
        out = np.array(pool, dtype=object)[rng.integers(0, len(pool), N)]
        out[rng.random(N) < share] = None
        return out

    def ints(lo, hi, dtype="Int32"):
        s = pd.Series(rng.integers(lo, hi, N)).astype(dtype)
        s[rng.random(N) < 0.1] = pd.NA
        return s
    return pd.DataFrame({
        "s": strings(_STRINGS),
        "t": strings(["", "zz", "q", "日", "-", "xyz"]),
        "k": ints(-3, 6),
        "n": ints(-1, 4),
        "a": ints(-50, 50, "Int64"),
        "b": ints(-50, 50, "Int64"),
    })


SCHEMA = [("s", "STRING"), ("t", "STRING"), ("k", "INT32"), ("n", "INT32"),
          ("a", "INT64"), ("b", "INT64")]


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


def _lit(M, v):
    return M.Literal(v, M.T.STRING)


def _int(M, v):
    return M.Literal(v, M.T.INT32)


def _split(M, pat, idx, limit=None):
    return M.GetArrayItem(
        M.StringSplit(M.col("s"), _lit(M, pat),
                      None if limit is None else _int(M, limit)), idx)


EXPRS = {
    "upper": lambda M: M.Upper(M.col("s")),
    "lower": lambda M: M.Lower(M.col("s")),
    "initcap": lambda M: M.InitCap(M.col("s")),
    "initcap_of_lower": lambda M: M.InitCap(M.Lower(M.col("s"))),
    "trim": lambda M: M.StringTrim(M.col("s")),
    "trim_left": lambda M: M.StringTrimLeft(M.col("s")),
    "trim_right": lambda M: M.StringTrimRight(M.col("s")),
    "concat_two": lambda M: M.ConcatStrings((M.col("s"), M.col("t"))),
    "concat_with_literal": lambda M: M.ConcatStrings(
        (M.col("t"), _lit(M, "|"), M.col("s"))),
    "trim_of_concat": lambda M: M.StringTrim(M.ConcatStrings(
        (_lit(M, "  "), M.col("s"), _lit(M, " ")))),
    "locate": lambda M: M.StringLocate(_lit(M, "lo"), M.col("s")),
    "locate_multibyte": lambda M: M.StringLocate(_lit(M, "本"),
                                                 M.col("s")),
    "locate_from": lambda M: M.StringLocate(_lit(M, "a"), M.col("s"),
                                            M.col("n")),
    "locate_null_pattern": lambda M: M.StringLocate(
        M.Literal(None, M.T.STRING), M.col("s")),
    "replace_byte": lambda M: M.StringReplace(M.col("s"), _lit(M, "-"),
                                              _lit(M, "")),
    "replace_longer": lambda M: M.StringReplace(M.col("s"), _lit(M, "a"),
                                                _lit(M, "bbb")),
    "replace_overlapping": lambda M: M.StringReplace(
        M.col("s"), _lit(M, "aa"), _lit(M, "b")),
    "replace_multibyte": lambda M: M.StringReplace(
        M.col("s"), _lit(M, "é"), _lit(M, "e")),
    "replace_empty_search": lambda M: M.StringReplace(
        M.col("s"), _lit(M, ""), _lit(M, "x")),
    "lpad": lambda M: M.LPad(M.col("s"), _int(M, 9), _lit(M, "0")),
    "rpad": lambda M: M.RPad(M.col("s"), _int(M, 12), _lit(M, ".")),
    "lpad_multibyte_pad": lambda M: M.LPad(M.col("s"), _int(M, 5),
                                           _lit(M, "日x")),
    "rpad_empty_pad": lambda M: M.RPad(M.col("s"), _int(M, 3), _lit(M, "")),
    "lpad_zero": lambda M: M.LPad(M.col("s"), _int(M, 0), _lit(M, "*")),
    "rlike_literal": lambda M: M.RLike(M.col("s"), _lit(M, "ab")),
    "regexp_replace_literal": lambda M: M.RegExpReplace(
        M.col("s"), _lit(M, ","), _lit(M, ";")),
    "split_0": lambda M: _split(M, ",", _int(M, 0)),
    "split_per_row": lambda M: _split(M, ",", M.col("k")),
    "split_limit": lambda M: _split(M, ",", _int(M, 1), limit=2),
    "split_multichar": lambda M: _split(M, "::", M.col("n")),
    "split_dash": lambda M: _split(M, "-", _int(M, 2)),
    "substring_index_2": lambda M: M.SubstringIndex(M.col("s"), _lit(M, "-"),
                                                    _int(M, 2)),
    "substring_index_neg": lambda M: M.SubstringIndex(
        M.col("s"), _lit(M, "."), _int(M, -1)),
    "substring_index_multichar": lambda M: M.SubstringIndex(
        M.col("s"), _lit(M, "::"), _int(M, -2)),
    "substring_index_zero": lambda M: M.SubstringIndex(
        M.col("s"), _lit(M, ","), _int(M, 0)),
    "array_item_strings": lambda M: M.GetArrayItem(
        M.CreateArray((M.col("s"), M.col("t"), _lit(M, "third"))),
        M.col("n")),
    "array_item_ints": lambda M: M.GetArrayItem(
        M.CreateArray((M.col("a"), M.col("b"))), M.col("n")),
    "map_value": lambda M: M.GetMapValue(
        M.CreateMap((_lit(M, "zz"), M.col("s"), _lit(M, "q"),
                     _lit(M, "queue"), _lit(M, "zz"), _lit(M, "dup"))),
        M.col("t")),
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


def _cpu(build, frame, like):
    """The port's CPU engine, as (values, validity) in `like`'s dtype."""
    out = cpu_eval(build(PORT), normalize_df(frame, _schema(T)), _schema(T))
    null = out.isna().to_numpy()
    vals = np.array(out.astype(object), dtype=object)
    if like.dtype != object:
        vals[null] = 0
        vals = vals.astype(like.dtype)
    return vals, ~null


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_string_functions_match_the_reference(name, port_batch, ref_batch,
                                              frame):
    got = _run(PORT, port_batch, EXPRS[name])
    _assert_same(got, _run(REF, ref_batch, EXPRS[name]), name)
    _assert_same(got, _cpu(EXPRS[name], frame, got[0]),
                 f"{name} on the CPU engine")


def test_new_strings_take_the_reference_s_char_capacity(port_batch,
                                                         ref_batch):
    """concat, replace and the pads size their output as the reference's
    do, so a wide column does not grow to the widest possible width."""
    for name in ("concat_two", "replace_longer", "lpad", "rpad",
                 "lpad_multibyte_pad", "trim_of_concat"):
        pb = EXPRS[name](PORT).bind(_schema(T))
        rb = EXPRS[name](REF).bind(_schema(RT))
        import jax.numpy as jnp
        p = pb.eval(make_eval_context(port_batch.columns,
                                      port_batch.capacity,
                                      torch.tensor(N, dtype=torch.int32)))
        r = rb.eval(r_context(ref_batch.columns, ref_batch.capacity,
                              jnp.int32(N)))
        assert p.char_cap == r.data.shape[1], name


# -- the twins of tests/test_string_datetime.py's string cases ---------------
def _proj1(build, vals=None, columns=None):
    columns = columns or {"s": np.array(vals, dtype=object)}
    b = ColumnarBatch.from_numpy(columns, device="cpu")
    src = LocalBatchSource([[b]], device="cpu")
    out = ProjectExec([build(PORT).alias("r")], src).collect()
    v, ok = out.column("r").to_numpy(out.num_rows)
    return [x.item() if hasattr(x, "item") else x if k else None
            for x, k in zip(v, ok)]


def _lits(M, *vals):
    return [M.lit(v) for v in vals]


TWINS = {
    "upper_lower_initcap": (
        ["Hello World", "ALL CAPS", "mixedCase"],
        [(lambda M: M.Upper(M.col("s")),
          ["HELLO WORLD", "ALL CAPS", "MIXEDCASE"]),
         (lambda M: M.Lower(M.col("s")),
          ["hello world", "all caps", "mixedcase"]),
         (lambda M: M.InitCap(M.col("s")),
          ["Hello World", "All Caps", "Mixedcase"])]),
    "trim_variants": (
        ["  hi  ", "hi", "   ", ""],
        [(lambda M: M.StringTrim(M.col("s")), ["hi", "hi", "", ""]),
         (lambda M: M.StringTrimLeft(M.col("s")), ["hi  ", "hi", "", ""]),
         (lambda M: M.StringTrimRight(M.col("s")),
          ["  hi", "hi", "", ""])]),
    "locate": (
        ["hello", "lolo", "", "xxlo"],
        [(lambda M: M.StringLocate(M.lit("lo"), M.col("s")), [4, 1, 0, 3]),
         (lambda M: M.StringLocate(M.lit("lo"), M.col("s"), M.lit(2)),
          [4, 3, 0, 3])]),
    "replace": (
        ["aaa", "abcabc", "", "xyz"],
        [(lambda M: M.StringReplace(M.col("s"), M.lit("a"), M.lit("bb")),
          ["bbbbbb", "bbbcbbbc", "", "xyz"]),
         (lambda M: M.StringReplace(M.col("s"), M.lit("abc"), M.lit("")),
          ["aaa", "", "", "xyz"])]),
    "replace_overlapping": (
        ["aaaa"],
        [(lambda M: M.StringReplace(M.col("s"), M.lit("aa"), M.lit("b")),
          ["bb"])]),
    "pad": (
        ["hi", "longer", ""],
        [(lambda M: M.LPad(M.col("s"), M.lit(5), M.lit("*")),
          ["***hi", "longe", "*****"]),
         (lambda M: M.RPad(M.col("s"), M.lit(5), M.lit("ab")),
          ["hiaba", "longe", "ababa"])]),
    "rlike_literal_only": (
        ["abc"], [(lambda M: M.RLike(M.col("s"), M.lit("b")), [True])]),
    "pad_utf8_chars": (
        ["日本", "abcdef"],
        [(lambda M: M.LPad(M.col("s"), M.lit(4), M.lit("*")),
          ["**日本", "abcd"]),
         (lambda M: M.RPad(M.col("s"), M.lit(3), M.lit("日")),
          ["日本日", "abc"])]),
    "substring_index_parity": (
        ["a.b.c", "nodot", "", "x.y", ".lead", "trail."],
        [(lambda M: M.SubstringIndex(M.col("s"), M.lit("."), M.lit(2)),
          ["a.b", "nodot", "", "x.y", ".lead", "trail."]),
         (lambda M: M.SubstringIndex(M.col("s"), M.lit("."), M.lit(-1)),
          ["c", "nodot", "", "y", "lead", ""])]),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_string_datetime_twins(name):
    vals, cases = TWINS[name]
    for build, want in cases:
        assert _proj1(build, vals) == want, name


def test_concat_twin():
    cols = {"a": np.array(["foo", "", None], dtype=object),
            "b": np.array(["bar", "x", "y"], dtype=object)}
    assert _proj1(lambda M: M.ConcatStrings(
        (M.col("a"), M.lit("-"), M.col("b"))), columns=cols) == \
        ["foo-bar", "-x", None]


def test_regex_functions_take_literals_only():
    with pytest.raises(TypeError):
        S.RLike(E.col("s"), E.lit("a.*b"))
    with pytest.raises(TypeError):
        S.RegExpReplace(E.col("s"), E.lit("[0-9]"), E.lit(""))
    assert isinstance(S.RLike(E.col("s"), E.lit("b")), S.Contains)
    assert isinstance(S.RegExpReplace(E.col("s"), E.lit("-"), E.lit("")),
                      S.StringReplace)
