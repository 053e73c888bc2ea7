"""spark_rapids_tpu_torch's CUDA kernels against their plain PyTorch twins
on an NVIDIA card.  Skips without one (a CUDA kernel has no CPU mode).

This file imports neither JAX nor spark_rapids_tpu, so it also runs on a
GPU machine without them:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.models.tpch import (LINEITEM_SCHEMA,
                                                Q1_CUTOFF_DAYS,
                                                gen_lineitem_arrays)
from spark_rapids_tpu_torch.ops import grouped_window as GW
from spark_rapids_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain(cuda_device):
    """Each CUDA kernel against its plain twin on the card (counts exact,
    f32 sums rtol 1e-5 over these small shapes)."""
    dev = cuda_device
    cols = gen_lineitem_arrays(np.random.default_rng(6), 1 << 16)
    # NaN in a padding row (batch 1 holds 100 rows) and in a filtered row
    # must reach no sum
    cols["l_quantity"][(1 << 14) + 200] = np.nan
    cut = np.flatnonzero(cols["l_shipdate"][:1 << 14] > Q1_CUTOFF_DAYS)[0]
    cols["l_extendedprice"][cut] = np.nan
    arrays = [torch.from_numpy(cols[n]).to(dev)
              for n in LINEITEM_SCHEMA.names]
    nums = torch.tensor([1 << 14, 100, 0, 5000], dtype=torch.int32,
                        device=dev)
    before = K.q1_fused.launches
    got = K.q1_fused(*arrays, nums, capacity=1 << 16, cutoff=Q1_CUTOFF_DAYS,
                     batch_rows=1 << 14)
    want = K.q1_fused_plain(*arrays, nums, capacity=1 << 16,
                            cutoff=Q1_CUTOFF_DAYS, batch_rows=1 << 14)
    assert K.q1_fused.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, 5], want[:, 5], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)

    torch.cuda.synchronize()


def _plain_rows(n, dev):
    return torch.full((1,), n, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups,n_measures,tier", [
    (26, 14, "A"),     # Q1's dictionary-lane table
    (37, 3, "A"),
    (300, 14, "B"),    # a table per warp
    (3000, 14, "B"),   # one table per block, shared-memory atomics
    (40000, 3, "C"),   # past shared memory: global vector atomics
    (5, 70, "A"),      # two launches (64 + 6 measures)
])
@pytest.mark.parametrize("aligned", [True, False])
def test_grouped_sum_tiers_match_plain(cuda_device, n_groups, n_measures,
                                       tier, aligned):
    """Each tier against the plain twin (counts exact, f32 sums rtol
    1e-5), with out-of-range keys, a row count that is no multiple of 8,
    and columns that are not 16-byte aligned; tiers A and B with a table
    per warp give the same bits twice."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(n_groups + n_measures)
    n, nrows = 1 << 16, (1 << 16) - 9
    lead = 0 if aligned else 1
    keys = torch.randint(-2, n_groups + 3, (n + lead,), generator=gen,
                         device=dev, dtype=torch.int32)[lead:]
    vals = [torch.rand(n + lead, generator=gen, device=dev)[lead:]
            for _ in range(n_measures)]
    s, c = K.grouped_sum(keys, vals, nrows, n_groups=n_groups, capacity=n)
    assert K.grouped_sum.last_tiers[0] == tier
    ws, wc = K.grouped_sum_plain(keys, vals, _plain_rows(nrows, dev),
                                 n_groups=n_groups, capacity=n)
    torch.testing.assert_close(c, wc, rtol=0, atol=0)
    torch.testing.assert_close(s, ws, rtol=1e-5, atol=1e-9)
    deterministic = tier == "A" or (tier == "B" and n_groups == 300)
    if deterministic:
        s2, c2 = K.grouped_sum(keys, vals, nrows, n_groups=n_groups,
                               capacity=n)
        assert torch.equal(s, s2) and torch.equal(c, c2)
    torch.cuda.synchronize()


def _window_case(name, dev):
    """(gid, out_cap) of one edge case of window_group_sums."""
    gen = torch.Generator(device=dev).manual_seed(11)
    n = 1 << 16
    if name == "random":        # leading -1 ids, gaps, ids past out_cap
        gid = torch.sort(torch.randint(-1, 5000, (n,), generator=gen,
                                       device=dev))[0]
        return gid.to(torch.int32), 4000
    if name == "one_run":       # a single run over every row and tile
        return torch.full((n,), 7, dtype=torch.int32, device=dev), 100
    if name == "empty_batch":   # every row numbered -1
        return torch.full((n,), -1, dtype=torch.int32, device=dev), 50
    if name == "big_gaps":      # wide gaps, runs crossing tiles
        gid = torch.arange(n, device=dev) // 3000 * 1000 + 3
        return gid.to(torch.int32), 30000
    if name == "q1_merge":      # 48 live rows, the last id repeated
        gid = torch.clamp(torch.arange(1 << 14, device=dev) // 8, max=5)
        return gid.to(torch.int32), 1 << 14
    # ragged: a capacity that fills no whole tile or quad
    gid = torch.sort(torch.randint(0, 300, (n - 1001,), generator=gen,
                                   device=dev))[0]
    return gid.to(torch.int32), 256


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["random", "one_run", "empty_batch",
                                  "big_gaps", "q1_merge", "ragged"])
@pytest.mark.parametrize("n_measures", [17, 70])
def test_window_group_sums_match_plain(cuda_device, name, n_measures):
    """The kernel against the plain twin over float64 copies of the
    measures, cast to f32 at the end, so the oracle does not depend on
    the order its atomic adds land in (f32 sums rtol 1e-5; absent ids
    exactly 0, though the output is not zero-filled first), and the same
    bits on a second call."""
    dev = cuda_device
    gid, out_cap = _window_case(name, dev)
    gen = torch.Generator(device=dev).manual_seed(n_measures)
    vals = [torch.rand(gid.numel(), generator=gen, device=dev)
            for _ in range(n_measures)]
    # dirty the allocator's free blocks, so unwritten cells would show
    torch.full((out_cap * n_measures * 2,), float("nan"), device=dev)
    got = GW.window_group_sums(gid, vals, out_cap=out_cap,
                               capacity=gid.numel())
    want = GW.window_group_sums_plain(gid, [v.double() for v in vals],
                                      out_cap=out_cap).float()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got == 0, want == 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = GW.window_group_sums(gid, vals, out_cap=out_cap,
                                 capacity=gid.numel())
    assert torch.equal(got, again)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("query", [1, 3, 4, 5, 6, 7, 8, 9, 10])
def test_planner_queries_match_the_cpu_engine(cuda_device, query):
    """TPC-H Q1 and Q3-Q10 through accelerate + collect on the card,
    wholly there (spark.rapids.sql.test.enabled), against the CPU engine
    (keys and counts exact, floats rtol 1e-5); planner Q1 launches
    window_group_sums."""
    from parity import compare_frames

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    tables = TD.gen_tables(np.random.default_rng(11), 20_000)
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    before = GW.window_group_sums.launches
    got = TB.run_query(query, tables, device=cuda_device, conf=conf)
    launched = GW.window_group_sums.launches - before
    want = QUERIES[query](TD.sources(tables, 2), None).collect()
    compare_frames(want, got, f"q{query} on the card")
    if query == 1:
        assert launched >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("join_type", ["INNER", "LEFT_OUTER", "RIGHT_OUTER",
                                       "FULL_OUTER", "LEFT_SEMI",
                                       "LEFT_ANTI"])
@pytest.mark.parametrize("unique", [True, False])
def test_join_lanes_match_the_cpu(cuda_device, join_type, unique):
    """HashJoinExec on the card against the same join on the CPU, row for
    row: unique build keys at capacity 1024 take the dense lane (but
    FULL_OUTER), duplicates the sort-merge lane."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exprs.base import col
    rng = np.random.default_rng(4)
    probe = {"k": rng.integers(0, 1200, 5000).astype(np.int64),
             "v": rng.uniform(0, 1, 5000)}
    keys = (rng.permutation(1000) if unique
            else rng.integers(0, 1000, 1000)).astype(np.int64)
    build = {"r": keys, "w": rng.integers(0, 9, 1000).astype(np.int32)}
    pvalid = {"k": rng.random(5000) > 0.05}
    jt = J.JoinType[join_type]
    left, right = (build, probe) if jt == J.JoinType.RIGHT_OUTER \
        else (probe, build)
    lkey, rkey = ("r", "k") if jt == J.JoinType.RIGHT_OUTER else ("k", "r")

    def run(dev):
        def src(d):
            return LocalBatchSource([[ColumnarBatch.from_numpy(
                d, validity=pvalid if d is probe else None,
                capacity=1024 if d is build else None, device=dev)]],
                device=dev)
        plan = J.HashJoinExec(jt, [col(lkey)], [col(rkey)], src(left),
                              src(right))
        return plan.collect().to_pandas(), plan.lane
    got, lane = run(cuda_device)
    want, cpu_lane = run("cpu")
    dense = unique and jt != J.JoinType.FULL_OUTER
    assert lane == cpu_lane == ("dense" if dense else "sort-merge")
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for name in want.columns:
        assert got[name].isna().equals(want[name].isna())
        np.testing.assert_array_equal(got[name].dropna().to_numpy(float),
                                      want[name].dropna().to_numpy(float))


def _expression_inputs(n=4096):
    """Dates (1900-2100, leap days, before 1970), doubles with zeros,
    UTF-8 strings of several widths, a tenth of each null."""
    import pandas as pd
    rng = np.random.default_rng(8)
    pool = np.array(["", "green", "dark green ivory", "café", "日本語",
                     "a_c", "50%", "x" * 40, "forest green", "\\"],
                    dtype=object)
    s = pool[rng.integers(0, len(pool), n)]
    s[rng.random(n) < 0.1] = None
    days = pd.Series(rng.integers(-25_567, 47_482, n)).astype("Int32")
    # 1900-03-01, 2000-02-29, 2100-02-28 and 1969-12-31
    days[: 4] = [-25_508, 11_016, 47_540, -1]
    days[rng.random(n) < 0.1] = pd.NA
    y = rng.integers(-3, 4, n).astype(float)
    return pd.DataFrame({
        "d": days,
        "x": pd.Series(rng.uniform(-1e3, 1e3, n)).astype("Float64"),
        "y": pd.Series(y).astype("Float64"),
        "s": s})


_EXPRESSIONS = {
    "year": lambda E, M: M["Year"](E.col("d")),
    "case_when": lambda E, M: M["CaseWhen"](
        ((E.col("s") == E.lit("green"), E.col("x")),), E.lit(0.0)),
    "case_when_strings": lambda E, M: M["CaseWhen"](
        ((E.col("x") > E.lit(0.0), E.col("s")),)),
    "divide": lambda E, M: E.col("x") / E.col("y"),
    "contains": lambda E, M: M["Contains"](E.col("s"), E.lit("green")),
    "like": lambda E, M: M["Like"](E.col("s"), E.lit("%gr_en%")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_EXPRESSIONS))
def test_expressions_match_on_the_card(cuda_device, name):
    """Year, CaseWhen, Divide, Contains and Like on CUDA tensors against
    the same expressions on CPU tensors: values, strings and nulls
    exact."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.base import make_eval_context
    from spark_rapids_tpu_torch.exprs import base as E
    from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
    from spark_rapids_tpu_torch.exprs.datetime_exprs import Year
    from spark_rapids_tpu_torch.exprs.string_fns import Contains, Like
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    M = {"Year": Year, "CaseWhen": CaseWhen, "Contains": Contains,
         "Like": Like}
    df = _expression_inputs()
    schema = T.Schema.of(("d", T.DATE32), ("x", T.FLOAT64),
                         ("y", T.FLOAT64), ("s", T.STRING))
    expr = _EXPRESSIONS[name](E, M).bind(schema)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch_from_df(df, schema, device=dev)
        ctx = make_eval_context(b.columns, b.capacity,
                                torch.tensor(len(df), dtype=torch.int32,
                                             device=dev))
        out.append(expr.eval(ctx).to_numpy(len(df)))
    (gv, gok), (wv, wok) = out
    np.testing.assert_array_equal(gok, wok)
    assert list(gv[wok]) == list(wv[wok])
    torch.cuda.synchronize()
