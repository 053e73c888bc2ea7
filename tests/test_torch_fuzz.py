"""The twins of tests/test_fuzz.py's concat, hash-partition and sort cases
over all ten types, on the CPU: spark_rapids_tpu_torch's fuzzer
(utils/fuzzer.py) draws the reference's values from the same seed, and
each operation's result must equal the reference's and pandas'.  Every
type is also a hash key (Spark's murmur3 of bytes, shorts, timestamps:
the partition ids must be the reference's bit for bit) and a sort key.
The serde round trip waits for columnar/serde.py (ROADMAP.md §1 item 4).

Tolerance: exact (values, NaN and +-Infinity as values, null masks,
partition ids and order).
"""
import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import concat_batches as r_concat
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.ops.murmur3 import partition_ids as r_partition_ids
from spark_rapids_tpu.utils import fuzzer as RF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import concat_batches
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.sort import SortExec, asc
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.ops.murmur3 import partition_ids
from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning
from spark_rapids_tpu_torch.utils import fuzzer as F


def _assert_frames_equal(a: pd.DataFrame, b: pd.DataFrame):
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for name in a.columns:
        ea, eb = a[name], b[name]
        na_a, na_b = ea.isna().to_numpy(), eb.isna().to_numpy()
        np.testing.assert_array_equal(na_a, na_b, err_msg=f"nulls {name}")
        va, vb = ea[~na_a].to_numpy(), eb[~na_b].to_numpy()
        if ea.dtype == object or eb.dtype == object:
            assert list(va) == list(vb), f"column {name}"
        else:
            np.testing.assert_array_equal(va, vb, err_msg=f"column {name}")


def test_fuzz_types_are_the_reference_s():
    assert [t.id.value for t in F.FUZZ_TYPES] == \
        [t.id.value for t in RF.FUZZ_TYPES]
    assert len(F.FUZZ_TYPES) == 10


def _port_schema(ref_schema):
    return T.Schema(tuple(T.Field(f.name, T.from_name(f.dtype.id.value))
                          for f in ref_schema.fields))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_concat_matches_pandas(seed):
    rng = np.random.default_rng(100 + seed)
    schema = F.random_schema(rng)
    batches = F.random_batches(rng, schema, count=int(rng.integers(2, 5)),
                               device="cpu")
    rrng = np.random.default_rng(100 + seed)
    rschema = RF.random_schema(rrng)
    rbatches = RF.random_batches(rrng, rschema,
                                 count=int(rrng.integers(2, 5)))
    assert _port_schema(rschema) == schema
    expected = pd.concat([b.to_pandas() for b in rbatches],
                         ignore_index=True)
    _assert_frames_equal(expected, concat_batches(batches).to_pandas())
    _assert_frames_equal(r_concat(rbatches).to_pandas(),
                         concat_batches(batches).to_pandas())


ALL_TYPES = [t.id.value for t in F.FUZZ_TYPES]


@pytest.mark.parametrize("key", ALL_TYPES)
def test_fuzz_hash_partition_exhaustive_and_disjoint(key):
    """Every input row lands in exactly one partition, the one the
    reference's murmur3 picks for it."""
    seed = ALL_TYPES.index(key)
    rng = np.random.default_rng(200 + seed)
    schema = T.Schema.of(("k", T.from_name(key)), ("f", T.FLOAT64),
                         ("s", T.STRING))
    n_rows = int(rng.integers(1, 150))
    batch = F.random_batch(rng, schema, num_rows=n_rows, device="cpu")
    rrng = np.random.default_rng(200 + seed)
    rschema = RT.Schema.of(("k", getattr(RT, T.from_name(key).id.name)),
                           ("f", RT.FLOAT64), ("s", RT.STRING))
    rbatch = RF.random_batch(rrng, rschema,
                             num_rows=int(rrng.integers(1, 150)))
    n = int(rng.integers(2, 6))
    # the same partition id for every row as the reference's murmur3
    got = partition_ids([batch.columns[0]], n).numpy()[:n_rows]
    want = np.asarray(r_partition_ids([rbatch.columns[0]], n))[:n_rows]
    np.testing.assert_array_equal(got, want)
    part = HashPartitioning([col("k")], n).bind(schema)
    parts = part.partition_batch(batch)
    assert len(parts) == n
    out = pd.concat([p.to_pandas() for p in parts if p is not None],
                    ignore_index=True)
    expected = rbatch.to_pandas()
    order = ["k", "f", "s"] if key != "string" else ["k", "f"]
    _assert_frames_equal(
        expected.sort_values(order, na_position="last", ignore_index=True),
        out.sort_values(order, na_position="last", ignore_index=True))
    again = part.partition_batch(batch)
    for p1, p2 in zip(parts, again):
        assert (p1 is None) == (p2 is None)
        assert p1 is None or p1.num_rows == p2.num_rows


@pytest.mark.parametrize("key", ALL_TYPES)
def test_fuzz_sort_matches_pandas(key):
    """Sorting by each type (nulls first) gives the reference's keys, in
    numpy's ascending order of the values."""
    from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
    from spark_rapids_tpu.exec.sort import SortExec as RSort
    from spark_rapids_tpu.exec.sort import asc as rasc
    seed = ALL_TYPES.index(key)
    rng = np.random.default_rng(300 + seed)
    schema = T.Schema.of(("k", T.from_name(key)), ("v", T.FLOAT32))
    batch = F.random_batch(rng, schema, num_rows=120, null_fraction=0.2,
                           device="cpu")
    rrng = np.random.default_rng(300 + seed)
    rschema = RT.Schema.of(("k", getattr(RT, T.from_name(key).id.name)),
                           ("v", RT.FLOAT32))
    rbatch = RF.random_batch(rrng, rschema, num_rows=120, null_fraction=0.2)
    out = SortExec([asc(col("k"))], LocalBatchSource(
        [[batch]], device="cpu")).collect()
    got, got_ok = out.column("k").to_numpy(out.num_rows)
    rout = RSort([rasc(rcol("k"))], RSource([[rbatch]])).collect()
    want, want_ok = rout.column("k").to_numpy(rout.num_rows)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got[got_ok], want[want_ok])
    # the golden: nulls first, then the values ascending (NaN, a value in
    # Spark, sorts after every other float)
    vals, ok = rbatch.column("k").to_numpy(rbatch.num_rows)
    assert got_ok.tolist() == sorted(ok.tolist())
    live = vals[ok]
    gold = sorted(live) if live.dtype == object else np.sort(live)
    np.testing.assert_array_equal(got[got_ok], np.asarray(gold, got.dtype))
