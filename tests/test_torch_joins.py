"""spark_rapids_tpu_torch's HashJoinExec and SortedTopNExec against
spark_rapids_tpu's on identical bytes from a numpy seed, on the CPU.

Rows must come out in the same order, with keys, integers, strings and
nulls exact and floats within rtol 1e-6.  Both packages must also take
the same join lane (dense direct-address or sort-merge) on the same
data: the port's lane counters against the reference's dense-table
cache.
"""
import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exec.joins import HashJoinExec as RJoin
from spark_rapids_tpu.exec.joins import JoinType as RJT
from spark_rapids_tpu.exec.sort import SortedTopNExec as RTopN
from spark_rapids_tpu.exec.sort import SortOrder as RSortOrder
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.models import tpch_queries as RQ
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan.pruning import prune_columns as r_prune
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.sort import SortedTopNExec, SortOrder
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models import tpch_queries as TQ
from spark_rapids_tpu_torch.plan import nodes as TN
from spark_rapids_tpu_torch.plan.pruning import prune_columns

JT = J.JoinType


def _table(rng, n, key_hi, *, null_every=0, dup=True, name="k"):
    """n rows: an int64 key in [0, key_hi) (unique when dup is False),
    a nullable float64 value and an int32 payload."""
    keys = (rng.integers(0, key_hi, n) if dup
            else rng.permutation(key_hi)[:n]).astype(np.int64)
    valid = np.ones(n, bool)
    if null_every:
        valid[::null_every] = False
    vnull = rng.random(n) < 0.1
    data = {name: keys, f"{name}_v": rng.uniform(0, 100, n),
            f"{name}_i": rng.integers(-50, 50, n).astype(np.int32)}
    return data, {name: valid, f"{name}_v": ~vnull}


def _batches(data, validity, cap, parts):
    """The same rows, split into `parts` batches of capacity `cap`, as
    port and reference batches."""
    n = len(next(iter(data.values())))
    cuts = np.linspace(0, n, parts + 1).astype(int)
    port, ref = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        d = {k: v[lo:hi] for k, v in data.items()}
        m = {k: v[lo:hi] for k, v in validity.items()}
        c = cap or None
        port.append(ColumnarBatch.from_numpy(d, validity=m, capacity=c,
                                             device="cpu"))
        ref.append(RBatch.from_numpy(d, validity=m, capacity=c))
    return port, ref


def _frames_equal(want: pd.DataFrame, got: pd.DataFrame, what: str):
    """Same columns and rows in the same order: nulls and non-float
    values exact, floats within rtol 1e-6."""
    assert list(want.columns) == list(got.columns), what
    assert len(want) == len(got), f"{what}: {len(want)} vs {len(got)} rows"
    for name in want.columns:
        w, g = want[name], got[name]
        wn, gn = w.isna().to_numpy(), g.isna().to_numpy()
        np.testing.assert_array_equal(wn, gn, err_msg=f"{what} {name}")
        wv, gv = w[~wn].to_numpy(), g[~gn].to_numpy()
        if any(isinstance(v, float) for v in wv[:1]) or \
                getattr(wv.dtype, "kind", "O") == "f":
            np.testing.assert_allclose(gv.astype(float), wv.astype(float),
                                       rtol=1e-6, err_msg=f"{what} {name}")
        else:
            assert list(wv) == list(gv), f"{what} {name}"


def _join(jt, left, right, lk=("k",), rk=("r",), *, lcap=0, rcap=0,
          lparts=1, rparts=1, cond=None, settings=None):
    """Run one join through both packages.  Returns (port frame,
    reference frame, the lane the port took, whether the reference
    built a dense table)."""
    lp, lr = _batches(*left, lcap, lparts)
    rp, rr = _batches(*right, rcap, rparts)
    port = J.HashJoinExec(
        JT[jt.name], [E.col(k) for k in lk], [E.col(k) for k in rk],
        LocalBatchSource([[b] for b in lp], device="cpu"),
        LocalBatchSource([[b] for b in rp], device="cpu"),
        cond(E) if cond else None)
    ref = RJoin(jt, [RE.col(k) for k in lk], [RE.col(k) for k in rk],
                RSource([[b] for b in lr]), RSource([[b] for b in rr]),
                cond(RE) if cond else None)
    before = (J.sort_merge_lane.launches, J.dense_lane.launches)
    with C.session(C.RapidsConf(settings or {})):
        got = port.collect().to_pandas()
    lanes = (J.sort_merge_lane.launches - before[0],
             J.dense_lane.launches - before[1])
    lane = ("dense" if lanes[1] and not lanes[0] else
            "sort-merge" if lanes[0] and not lanes[1] else
            "none" if lanes == (0, 0) else "both")
    with RC.session(RC.RapidsConf(settings or {})):
        want = ref.collect().to_pandas()
    ref_dense = any(e is not None for e, _ in ref._dense_tables.values())
    return got, want, lane, ref_dense


@pytest.fixture(scope="module")
def sides():
    """Probe side with null keys over 3 batches, build side with
    duplicate and null keys over 2 partitions."""
    rng = np.random.default_rng(5)
    return (_table(rng, 200, 40, null_every=9),
            _table(rng, 60, 50, null_every=13, name="r"))


ALL_TYPES = [RJT.INNER, RJT.LEFT_OUTER, RJT.RIGHT_OUTER, RJT.FULL_OUTER,
             RJT.LEFT_SEMI, RJT.LEFT_ANTI]


@pytest.mark.parametrize("jt", ALL_TYPES, ids=lambda t: t.value)
def test_join_types_with_null_and_duplicate_keys(sides, jt):
    left, right = sides
    got, want, lane, ref_dense = _join(jt, left, right, lparts=3, rparts=2)
    _frames_equal(want, got, jt.value)
    assert lane == "sort-merge" and not ref_dense  # duplicate build keys
    if jt == RJT.INNER:  # null keys match nothing, duplicates expand
        lk, rk = left[0]["k"][left[1]["k"]], right[0]["r"][right[1]["r"]]
        assert len(got) == sum(int((rk == k).sum()) for k in lk)


@pytest.mark.parametrize("empty", ["build", "probe", "both"])
@pytest.mark.parametrize("jt", [RJT.INNER, RJT.LEFT_OUTER, RJT.FULL_OUTER,
                                RJT.LEFT_ANTI], ids=lambda t: t.value)
def test_empty_sides(sides, jt, empty):
    left, right = sides

    def cut(side, n):
        return ({k: v[:n] for k, v in side[0].items()},
                {k: v[:n] for k, v in side[1].items()})
    if empty in ("build", "both"):
        right = cut(right, 0)
    if empty in ("probe", "both"):
        left = cut(left, 0)
    got, want, _, _ = _join(jt, left, right)
    _frames_equal(want, got, f"{jt.value}, empty {empty}")


@pytest.mark.parametrize("jt", [RJT.INNER, RJT.LEFT_OUTER, RJT.FULL_OUTER],
                         ids=lambda t: t.value)
def test_multi_key_join(jt):
    """Two int keys (one int32), nulls in either: a row with any null
    key matches nothing."""
    rng = np.random.default_rng(8)
    left, right = _table(rng, 150, 6, null_every=7), \
        _table(rng, 80, 6, null_every=11, name="r")
    left[0]["k_i"] = left[0]["k_i"] % 4
    right[0]["r_i"] = right[0]["r_i"] % 4
    left[1]["k_i"] = rng.random(150) > 0.1
    got, want, lane, _ = _join(jt, left, right, ("k", "k_i"), ("r", "r_i"))
    _frames_equal(want, got, f"{jt.value} on two keys")
    assert lane == "sort-merge"


@pytest.mark.parametrize("jt", [RJT.INNER, RJT.FULL_OUTER, RJT.LEFT_SEMI],
                         ids=lambda t: t.value)
def test_string_keys_of_different_char_caps(jt):
    """Probe keys fit 8 bytes, build keys need 16 in one of the build
    side's two partitions: the partitions concatenate at one char
    capacity, and the two sides pad to one before their bytes are
    compared."""
    words = np.array(["a", "bb", "ccc", "dddd", "", "eeeeeeeeeeeee",
                      "ffffffffffff"], dtype=object)
    rng = np.random.default_rng(3)
    left = ({"s": words[rng.integers(0, 5, 40)],
             "x": np.arange(40, dtype=np.int64)},
            {"s": rng.random(40) > 0.1})
    right = ({"t": np.concatenate([words[rng.integers(0, 5, 15)],
                                   words[rng.integers(0, 7, 15)]]),
              "y": rng.uniform(0, 1, 30)},
             {"t": rng.random(30) > 0.1})
    got, want, _, _ = _join(jt, left, right, ("s",), ("t",), rparts=2)
    _frames_equal(want, got, f"{jt.value} on string keys")
    assert len(got) > 0


def test_inner_join_with_a_residual_condition(sides):
    left, right = sides
    got, want, lane, _ = _join(
        RJT.INNER, left, right, rparts=2,
        cond=lambda m: m.col("k_v") > m.col("r_v"))
    _frames_equal(want, got, "inner with condition")
    assert lane == "sort-merge" and 0 < len(got)
    assert (got["k_v"].astype(float) > got["r_v"].astype(float)).all()


def _dense_sides(rng, build_keys):
    left = _table(rng, 300, 140, null_every=17)
    n = len(build_keys)
    right = ({"r": np.asarray(build_keys, np.int64),
              "r_v": rng.uniform(0, 1, n),
              "r_i": rng.integers(0, 9, n).astype(np.int32)},
             {"r_v": rng.random(n) > 0.2})
    return left, right


@pytest.mark.parametrize("jt", [RJT.INNER, RJT.LEFT_OUTER, RJT.RIGHT_OUTER,
                                RJT.LEFT_SEMI, RJT.LEFT_ANTI],
                         ids=lambda t: t.value)
def test_dense_lane_where_the_reference_takes_it(jt):
    """Unique keys, capacity 128, span within maxSpan: both packages
    build the slot table and agree row for row."""
    rng = np.random.default_rng(12)
    probe, build = _dense_sides(rng, rng.permutation(120)[:100] + 10)
    if jt == RJT.RIGHT_OUTER:  # the left side builds
        got, want, lane, ref_dense = _join(jt, build, probe, ("r",), ("k",),
                                           lcap=128, rcap=512)
    else:
        got, want, lane, ref_dense = _join(jt, probe, build, rcap=128,
                                           lcap=512)
    _frames_equal(want, got, f"dense {jt.value}")
    assert lane == "dense" and ref_dense


@pytest.mark.parametrize("case", ["duplicate_keys", "span_over_max",
                                  "capacity_not_128", "disabled"])
def test_dense_lane_declined_where_the_reference_declines(case):
    rng = np.random.default_rng(13)
    keys = rng.permutation(120)[:100] + 10
    cap, settings = 128, {}
    if case == "duplicate_keys":
        keys[5] = keys[6]
    elif case == "span_over_max":
        settings = {C.DENSE_JOIN_MAX_SPAN.key: 64}
    elif case == "capacity_not_128":
        cap = 192
    else:
        settings = {C.DENSE_JOIN_ENABLED.key: False}
    left, right = _dense_sides(rng, keys)
    got, want, lane, ref_dense = _join(RJT.INNER, left, right, rcap=cap,
                                       settings=settings)
    _frames_equal(want, got, f"dense declined: {case}")
    assert lane == "sort-merge" and not ref_dense


def test_dense_lane_with_kmin_outside_int32():
    """A probe key with an int32 shadow against build keys past int32:
    the shadow must not wrap into a slot (the reference's
    test_narrow_probe_wide_build_kmin)."""
    base = np.int64(1) << 33
    left = ({"k": np.array([0, 5, 7], np.int64), "k_v": [1.0, 2.0, 3.0]},
            {})
    right = ({"r": base + np.arange(0, 100, dtype=np.int64) * 2,
              "r_v": np.linspace(0, 1, 100)}, {})
    left[0]["k"][2] = base + 4
    got, want, lane, ref_dense = _join(RJT.INNER, left, right, rcap=128)
    _frames_equal(want, got, "kmin outside int32")
    assert lane == "dense" and ref_dense
    assert list(got["k"]) == [int(base + 4)]


@pytest.fixture(scope="module")
def topn_input():
    rng = np.random.default_rng(21)
    n = 500
    data = {"a": rng.integers(0, 40, n).astype(np.int64),
            "b": rng.uniform(-5, 5, n), "c": np.arange(n, dtype=np.int32)}
    validity = {"a": rng.random(n) > 0.1, "b": rng.random(n) > 0.1}
    return _batches(data, validity, 0, 4)


@pytest.mark.parametrize("keys", [
    (("b", False, None),), (("b", True, None),), (("a", True, False),),
    (("a", False, True),), (("a", False, None), ("c", True, None)),
    (("b", True, False), ("a", False, True)),
], ids=["b_desc", "b_asc", "a_asc_nulls_last", "a_desc_nulls_first",
        "a_desc_c_asc", "b_asc_a_desc"])
def test_sorted_top_n(topn_input, keys):
    """One and two sort keys, nulls first and last: the same rows in the
    same order (the one-key cases take torch.topk, the two-key cases
    the sort)."""
    port_b, ref_b = topn_input

    def plan(src, order_cls, mod, exec_cls, parts):
        order = [order_cls(mod.col(k), asc, nf) for k, asc, nf in keys]
        return exec_cls(17, order, src([[b] for b in parts]))
    got = plan(lambda p: LocalBatchSource(p, device="cpu"), SortOrder, E,
               SortedTopNExec, port_b).collect().to_pandas()
    want = plan(RSource, RSortOrder, RE, RTopN, ref_b).collect().to_pandas()
    _frames_equal(want, got, f"top-17 by {keys}")
    assert len(got) == 17


def _source_columns(node, src_cls) -> list:
    if isinstance(node, src_cls):
        return [tuple(node.output_schema().names)]
    return [c for k in node.children for c in _source_columns(k, src_cls)]


@pytest.mark.parametrize("query", [3, 4, 5])
def test_join_pruning_keeps_the_reference_columns(query):
    tables = TD.gen_tables(np.random.default_rng(2), 200)
    port = prune_columns(TQ.QUERIES[query](TD.sources(tables), None))
    ref = r_prune(RQ.QUERIES[query](RD.sources(tables), None))
    assert _source_columns(port, TN.CpuSource) == \
        _source_columns(ref, RN.CpuSource)
    if query == 5:
        assert ("l_orderkey", "l_suppkey", "l_extendedprice",
                "l_discount") in _source_columns(port, TN.CpuSource)


def test_broadcast_join_is_refused_not_moved_to_the_cpu():
    """No TPC-H query broadcasts; a plan that does runs as a device
    BroadcastHashJoinExec (since the runtime slice ported it), never as a
    quiet CPU island, and its rows are the shuffled join's."""
    from parity import compare_frames

    from spark_rapids_tpu_torch.exec.joins import BroadcastHashJoinExec
    from spark_rapids_tpu_torch.plan import nodes as TN2
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    tables = TD.gen_tables(np.random.default_rng(2), 200)
    t = TD.sources(tables)
    conf = C.RapidsConf({})
    out = {}
    for bc in (False, True):
        plan = accelerate(TQ._join(JT.INNER, t["orders"], t["customer"],
                                   ["o_custkey"], ["c_custkey"],
                                   broadcast=bc), conf, device="cpu")
        assert not isinstance(plan, TN2.CpuNode)
        assert isinstance(plan, BroadcastHashJoinExec) is bc
        out[bc] = collect(plan, conf)
    compare_frames(out[False], out[True], "broadcast")
