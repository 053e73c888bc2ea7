"""String columns, murmur3 hashing and the hash-grouping sort of
spark_rapids_tpu_torch against spark_rapids_tpu, on the CPU.

Hashes and partition ids must match bit for bit; group boundaries and
sort orders exactly.
"""
import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.vector import ColumnVector as RCV
from spark_rapids_tpu.ops import murmur3 as RM
from spark_rapids_tpu.ops import sort_encode as RS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    _bytes_matrix,
                                                    _encode_rows,
                                                    strings_to_bytes)
from spark_rapids_tpu_torch.ops import murmur3 as M
from spark_rapids_tpu_torch.ops import sort_encode as S
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.transitions import (batch_from_df,
                                                     df_from_batch)

N = 300
_POOL = [None, "", "a", "ab", "abc", "abcd", "abcde", "é", "naïve café",
         "日本語テキスト", "x" * 33, "emb\x00ed", "\U0001F600 smile",
         "tail\x00"]


def _strings(rng, n=N, pool=_POOL):
    return np.array([pool[i] for i in rng.integers(0, len(pool), n)],
                    dtype=object)


def _unique_strings(rng, n=N):
    """Many distinct values of lengths 0-33, some non-ASCII, some null."""
    out = []
    for i in range(n):
        k = int(rng.integers(0, 34))
        chars = rng.integers(0x20, 0x7F, k)
        if i % 5 == 0:
            chars[: k // 2] = rng.integers(0xA0, 0x2FFF, k // 2)
        out.append(None if i % 11 == 0 else
                   "".join(map(chr, chars)) + str(i))
    return np.array(out, dtype=object)


def _per_row(values, valid):
    return _bytes_matrix(_encode_rows(values, valid))


@pytest.mark.parametrize("kind", ["few_distinct", "many_distinct",
                                  "numpy_str", "categorical",
                                  "nul_prefixes"])
def test_vectorized_upload_equals_the_per_row_encode(kind):
    rng = np.random.default_rng(3)
    vals = (_strings(rng) if kind != "many_distinct"
            else _unique_strings(rng))
    if kind == "nul_prefixes":
        # few distinct values that agree up to their first NUL: the
        # factorized path must not merge them
        vals = np.array(["a\x00b", "a\x00"] * 64 + ["c"] * 64, dtype=object)
    valid = np.array([v is not None for v in vals])
    if kind == "numpy_str":
        vals = np.where(valid, vals, "").astype(np.str_)
        got = strings_to_bytes(vals, valid)
    elif kind == "categorical":
        s = pd.Series(pd.Categorical(vals))
        got = batch_from_df(pd.DataFrame({"s": s}), T.Schema.of(
            ("s", T.STRING)), device="cpu").columns[0]
        got = (got.data[:N].numpy(), got.lengths[:N].numpy())
    else:
        got = strings_to_bytes(vals, valid)
    want = _per_row(vals, valid)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("make", [_strings, _unique_strings])
def test_strings_round_trip_through_pandas_like_the_reference(make):
    rng = np.random.default_rng(4)
    vals = make(rng)
    df = pd.DataFrame({"s": vals, "k": np.arange(N, dtype=np.int64)})
    schema = schema_of_df(df)
    assert [f.dtype for f in schema] == [T.STRING, T.INT64]
    batch = batch_from_df(df, schema, device="cpu")
    col = batch.columns[0]
    ref = RCV.from_numpy(vals, RT.STRING)
    np.testing.assert_array_equal(col.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(col.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(col.validity.numpy(),
                                  np.asarray(ref.validity))
    back = df_from_batch(batch)
    assert list(back["s"]) == list(vals)


def _pair(values, dtype, rtype, valid):
    return (ColumnVector.from_numpy(values, dtype, valid, device="cpu"),
            RCV.from_numpy(values, rtype, valid))


def _hash_columns(rng):
    # no subnormal doubles: the reference splits doubles with a frexp
    # decomposition that flushes subnormals to zero, while the port
    # hashes their exact bit pattern (Spark's behaviour)
    specials64 = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e300,
                           -2.5e-300])
    specials32 = specials64[:5].astype(np.float32)
    valid = rng.random(N) < 0.85
    big = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
    small = rng.integers(-2**31, 2**31, N).astype(np.int64)
    cols = {
        "int32": (rng.integers(-2**31, 2**31, N).astype(np.int32),
                  T.INT32, RT.INT32),
        "int64": (big, T.INT64, RT.INT64),
        "int64_narrow": (small, T.INT64, RT.INT64),
        "float32": (np.concatenate([specials32, rng.normal(
            size=N - 5).astype(np.float32)]), T.FLOAT32, RT.FLOAT32),
        "float64": (np.concatenate([specials64, rng.normal(
            size=N - 7) * 1e6]), T.FLOAT64, RT.FLOAT64),
        "date32": (rng.integers(-1000, 20000, N).astype(np.int32),
                   T.DATE32, RT.DATE32),
        "string": (_strings(rng), T.STRING, RT.STRING),
    }
    out = {}
    for name, (v, dt, rdt) in cols.items():
        vd = (np.array([x is not None for x in v]) if dt.is_string
              else valid)
        out[name] = _pair(v, dt, rdt, vd)
    return out


@pytest.mark.parametrize("name", ["int32", "int64", "int64_narrow",
                                  "float32", "float64", "date32", "string",
                                  "all"])
def test_murmur3_matches_reference_bit_for_bit(name):
    cols = _hash_columns(np.random.default_rng(5))
    names = list(cols) if name == "all" else [name]
    port = [cols[k][0] for k in names]
    ref = [cols[k][1] for k in names]
    if name == "int64_narrow":
        assert port[0].narrow is not None and ref[0].narrow is not None
    np.testing.assert_array_equal(M.murmur3_row_hash(port).numpy(),
                                  np.asarray(RM.murmur3_row_hash(ref)))
    for n in (1, 7, 16):
        np.testing.assert_array_equal(M.partition_ids(port, n).numpy(),
                                      np.asarray(RM.partition_ids(ref, n)))


def _mask(n_rows, cap):
    return np.arange(cap) < n_rows


def test_hash_sort_bounds_match_reference():
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(6)
    flags = np.array(list("ANR"), dtype=object)[rng.integers(0, 3, N)]
    status = np.array(list("FO"), dtype=object)[rng.integers(0, 2, N)]
    status[::17] = None
    k = rng.integers(0, 4, N).astype(np.int64)
    pairs = [_pair(flags, T.STRING, RT.STRING, None),
             _pair(status, T.STRING, RT.STRING,
                   np.array([x is not None for x in status])),
             _pair(k, T.INT64, RT.INT64, rng.random(N) < 0.9)]
    cap = pairs[0][0].capacity
    mask = _mask(N - 20, cap)
    for seed in (42, 0x3C6EF372):
        np.testing.assert_array_equal(
            S._grouping_hash([p for p, _ in pairs], seed).numpy(),
            np.asarray(RS._grouping_hash([r for _, r in pairs], seed)))
    p_perm, p_valid, p_bounds, p_coll = S.hash_sort_bounds(
        [(p, True, True) for p, _ in pairs], torch.from_numpy(mask))
    r_perm, r_valid, r_bounds, r_coll = RS.hash_sort_bounds(
        [(r, True, True) for _, r in pairs], jnp.asarray(mask))
    np.testing.assert_array_equal(p_perm.numpy(), np.asarray(r_perm))
    np.testing.assert_array_equal(p_bounds.numpy(), np.asarray(r_bounds))
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(r_valid))
    assert bool(p_coll) is bool(r_coll) is False
    # a string key routes to this lane whether its column is seen (two
    # 8-byte strings: 1 + 2 x 73 bits, three words, not wide) or only
    # its type is (a fused pre-stage: always wide)
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exprs.base import col
    schema = T.Schema.of(("f", T.STRING), ("s", T.STRING), ("k", T.INT64))
    keys = [col(n).bind(schema) for n in schema.names]
    batch = ColumnarBatch(schema, [p for p, _ in pairs], N)
    assert not S.wide_key_set(keys[:2], batch, schema)
    assert S.wide_key_set(keys[:2], None, schema)


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False),
                                             (True, False)])
def test_string_sort_order_matches_reference(asc, nulls_first):
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(7)
    vals = _unique_strings(rng)
    vals[::3] = _strings(rng, N)[::3]
    p, r = _pair(vals, T.STRING, RT.STRING,
                 np.array([v is not None for v in vals]))
    mask = _mask(N - 9, p.capacity)
    got = S.multi_key_argsort([(p, asc, nulls_first)],
                              torch.from_numpy(mask))
    want = RS.multi_key_argsort([(r, asc, nulls_first)], jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        S.segment_boundaries([p], got, torch.from_numpy(mask)).numpy(),
        np.asarray(RS.segment_boundaries([r], want, jnp.asarray(mask))))
    words = [k for k in S.encode_key_bits(p, asc, nulls_first)]
    assert [b for _, b in words] == [1] + [9] * p.char_cap
    assert S.estimate_packed_words([(T.STRING, False, p.char_cap)]) == \
        RS.estimate_packed_words([(r, asc, nulls_first)])


def test_range_exchange_samples_string_bounds_like_reference(monkeypatch):
    """A range exchange over a string key samples the same bounds as the
    reference's and routes every row to the same partition."""
    from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
    from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
    from spark_rapids_tpu.exec.sort import asc as rasc
    from spark_rapids_tpu.exprs.base import col as rcol
    from spark_rapids_tpu.shuffle import exchange as RX
    from spark_rapids_tpu.shuffle.partitioning import \
        RangePartitioning as RRange
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exec.sort import asc
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.shuffle import exchange as X
    from spark_rapids_tpu_torch.shuffle.partitioning import \
        RangePartitioning
    monkeypatch.setattr(X.ShuffleExchangeExec, "SMALL_RANGE_INPUT_ROWS", 0)
    monkeypatch.setattr(RX.ShuffleExchangeExec, "SMALL_RANGE_INPUT_ROWS", 0)
    rng = np.random.default_rng(8)
    df = pd.DataFrame({"s": _unique_strings(rng, 900),
                       "v": np.arange(900, dtype=np.int64)})
    halves = [df.iloc[:500].reset_index(drop=True),
              df.iloc[500:].reset_index(drop=True)]
    schema = schema_of_df(df)
    port = X.ShuffleExchangeExec(
        RangePartitioning([asc(col("s"))], 3),
        LocalBatchSource([[batch_from_df(h, schema, device="cpu")]
                          for h in halves], schema, device="cpu"))
    ref = RX.ShuffleExchangeExec(
        RRange([rasc(rcol("s"))], 3),
        RSource([[RBatch.from_pandas(h)] for h in halves]))
    got = [[df_from_batch(b) for b in it] for it in port.execute_partitions()]
    want = [[b.to_pandas() for b in it] for it in ref.execute_partitions()]
    assert list(df_from_batch(port.partitioning.bounds)["s"]) == \
        list(ref.partitioning.bounds.to_pandas()["s"])
    for g, w in zip(got, want):
        g = pd.concat(g) if g else pd.DataFrame({"v": []})
        w = pd.concat(w) if w else pd.DataFrame({"v": []})
        assert sorted(g["v"]) == sorted(w["v"])
    assert sum(len(p) for ps in got for p in ps) == 900
