"""TPC-H Q1 and Q6 through spark_rapids_tpu_torch's planner
(`accelerate` + `collect`) against spark_rapids_tpu's `run_query`, on the
CPU, at the scale and seed tests/test_tpch.py uses.

Keys and counts must match exactly and floats within compare_frames'
rtol 1e-5 (the banded lane adds f32, as the reference's does).
"""
import numpy as np
import pandas as pd
import pytest
import torch
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
from spark_rapids_tpu_torch.ops import sort_encode as S
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

SCALE = 3000
SEED = 11


@pytest.fixture(scope="module")
def tables():
    return TD.gen_tables(np.random.default_rng(SEED), SCALE)


@pytest.fixture(scope="module")
def ref_tables():
    return RD.gen_tables(np.random.default_rng(SEED), SCALE)


@pytest.fixture(scope="module")
def reference(ref_tables):
    """The reference's accelerated result and plan for each query."""
    out = {}
    for q in QUERIES:
        df = RB.run_query(q, ref_tables, engine="tpu")
        out[q] = (df, RO.ExecutionPlanCapture.last_plan)
    return out


def _tree(plan) -> list:
    """Exec class names in tree order (pre-order)."""
    return [type(plan).__name__] + [n for c in plan.children
                                    for n in _tree(c)]


def _accelerate(q, tables, conf=None):
    conf = conf or C.RapidsConf(dict(TB.BENCH_CONF))
    return accelerate(QUERIES[q](TD.sources(tables, 2), None), conf,
                      device="cpu")


def test_gen_tables_matches_reference(tables, ref_tables):
    assert list(tables) == list(ref_tables)
    for name in tables:
        pd.testing.assert_frame_equal(tables[name], ref_tables[name],
                                      check_exact=True)
        assert TD.SCHEMAS[name].names == RD.SCHEMAS[name].names
        assert [f.dtype.id.value for f in TD.SCHEMAS[name]] == \
            [f.dtype.id.value for f in RD.SCHEMAS[name]]


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_run_query_matches_reference_and_cpu_engine(tables, ref_tables,
                                                    reference, query):
    got = TB.run_query(query, tables, device="cpu")
    compare_frames(reference[query][0], got, f"q{query} vs reference")
    cpu = QUERIES[query](TD.sources(tables, 2), None).collect()
    compare_frames(cpu, got, f"q{query} vs the CPU engine")
    ref_cpu = RB.run_query(query, ref_tables, engine="cpu")
    compare_frames(ref_cpu, cpu, f"q{query} CPU engines")
    if query == 1:
        assert len(got) == 6 and got["count_order"].sum() == \
            (tables["lineitem"]["l_shipdate"] <= TD.days("1998-09-02")).sum()


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_plan_matches_reference_tree(tables, reference, query):
    plan = _accelerate(query, tables)
    assert _tree(plan) == _tree(reference[query][1])
    fused = [n for n in _walk(plan) if isinstance(n, HashAggregateExec)
             and n.fused_members]
    assert [n.mode.value for n in fused] == ["partial"]


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def test_q1_takes_the_hash_and_banded_lanes(tables, monkeypatch):
    """The string keys route both aggregates through the murmur3 sort,
    then the banded lane's window_group_sums (its plain twin on CPU
    tensors): once for each of the partial aggregate's two partitions,
    and once for the final aggregate, whose small input the hash
    exchange puts in one partition."""
    from spark_rapids_tpu_torch.exec import aggregate as A
    calls = {"hash": 0, "window": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(A, "hash_sort_bounds",
                        counting("hash", A.hash_sort_bounds))
    monkeypatch.setattr(A, "window_group_sums",
                        counting("window", A.window_group_sums))
    TB.run_query(1, tables, device="cpu")
    assert calls == {"hash": 3, "window": 3}


def test_pruning_drops_unread_columns(tables):
    plan = _accelerate(1, tables)
    (src,) = [n for n in _walk(plan) if isinstance(n, LocalBatchSource)]
    assert set(src.output_schema().names) == {
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate"}
    off = _accelerate(1, tables, C.RapidsConf(
        {**TB.BENCH_CONF, C.PRUNE_COLUMNS.key: False}))
    (src,) = [n for n in _walk(off) if isinstance(n, LocalBatchSource)]
    assert "l_comment" in src.output_schema().names


def _reasons(meta) -> dict:
    out = {} if meta.can_this_be_replaced else {
        meta.node.name(): sorted(meta.reasons)}
    for c in meta.child_plans:
        out.update(_reasons(c))
    return out


def test_disabled_expression_makes_a_cpu_island(tables, ref_tables):
    key = C.op_enable_key("expression", "LessThanOrEqual")
    settings = {**TB.BENCH_CONF, key: False}
    plan = _accelerate(1, tables, C.RapidsConf(settings))
    got = collect(plan)
    want = RB.run_query(1, ref_tables, engine="tpu",
                        conf=RC.RapidsConf(settings))
    ref_meta = RO.ExecutionPlanCapture.last_meta
    assert _reasons(plan._meta) == _reasons(ref_meta) == {
        "CpuFilter": [f"unsupported expressions: expression "
                      f"LessThanOrEqual disabled by {key}"]}
    compare_frames(want, got, "q1 with a CPU filter")
    with pytest.raises(AssertionError, match="CpuFilter did not run"):
        _accelerate(1, tables, C.RapidsConf(
            {**settings, C.TEST_ENABLED.key: True}))


def test_forced_murmur3_collision_deopts_to_the_lexicographic_lane(
        tables, monkeypatch):
    """Every row hashes alike: the grouping sort keeps the rows in input
    order, adjacent key changes without a hash change flag a collision,
    and collect() re-runs the partial aggregate lexicographically."""
    want = TB.run_query(1, tables, device="cpu")
    monkeypatch.setattr(S, "_grouping_hash", lambda cols, seed: torch.full(
        (cols[0].capacity,), seed, dtype=torch.int64))
    plan = _accelerate(1, tables)
    got = collect(plan)
    (partial,) = [n for n in _walk(plan) if isinstance(n, HashAggregateExec)
                  and n.mode.value == "partial"]
    assert partial._hash_group_disabled
    compare_frames(want, got, "q1 after the collision deopt", rtol=0,
                   atol=0)


@pytest.mark.parametrize("entry", ["run_query", "accelerate"])
def test_entry_points_refuse_to_run_without_a_card(tables, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "run_query":
            TB.run_query(6, tables)
        else:
            accelerate(QUERIES[6](TD.sources(tables, 2), None))


@pytest.mark.parametrize("settings", [
    {C.HASH_GROUPING_ENABLED.key: False},
    {C.BANDED_GROUPBY_ENABLED.key: False},
    {C.HASH_GROUPING_ENABLED.key: False,
     C.BANDED_GROUPBY_ENABLED.key: False},
    {C.FUSION_ENABLED.key: False},
], ids=["lexicographic", "hash_sort_lane", "lexicographic_sort_lane",
        "unfused"])
def test_q1_string_keys_on_every_lane(tables, settings):
    """Q1's string group keys on the lexicographic and hash sorts, the
    banded and sort lanes, and without fusion, against the CPU engine."""
    conf = C.RapidsConf({**TB.BENCH_CONF, **settings})
    got = TB.run_query(1, tables, device="cpu", conf=conf)
    want = QUERIES[1](TD.sources(tables, 2), None).collect()
    compare_frames(want, got, f"q1 under {settings}")
    plan = _accelerate(1, tables, conf)
    partial = [n for n in _walk(plan) if isinstance(n, HashAggregateExec)][-1]
    assert bool(partial.fused_members) == (C.FUSION_ENABLED.key
                                           not in settings)


@pytest.mark.parametrize("global_limit", [True, False])
def test_limit_over_a_sort_matches_the_cpu_engine(tables, global_limit):
    """CpuLimit converts to Global/LocalLimitExec over the planner's
    sort; both engines keep the same rows."""
    from spark_rapids_tpu_torch.exec.sort import asc
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan.nodes import CpuLimit, CpuSort

    def plan():
        li = TD.sources(tables, 2)["lineitem"]
        return CpuLimit(7, CpuSort(
            [asc(col("l_orderkey")), asc(col("l_linenumber")),
             asc(col("l_partkey"))], li, global_sort=global_limit),
            global_limit=global_limit)
    got = collect(accelerate(plan(), C.RapidsConf(
        {C.TEST_ENABLED.key: True}), device="cpu"))
    want = plan().collect()
    assert len(got) == len(want) == (7 if global_limit else 14)
    compare_frames(want, got, "limit")
    if global_limit:
        assert list(got["l_orderkey"]) == list(want["l_orderkey"])


def test_fused_filter_project_on_the_dictionary_lane(tables):
    """A Filter -> Project chain under an aggregate on an integral key
    fuses into the aggregate's pre-stage (shared subexpressions evaluated
    once) and runs the dictionary lane; the answer is the CPU engine's."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, Sum
    from spark_rapids_tpu_torch.exprs.base import col, lit
    from spark_rapids_tpu_torch.exprs.simplify import SharedExpr
    from spark_rapids_tpu_torch.plan.nodes import (CpuAggregate, CpuFilter,
                                                   CpuProject)

    def plan():
        li = TD.sources(tables, 2)["lineitem"]
        q2 = col("l_quantity") * lit(2.0)
        proj = CpuProject([col("l_linenumber"), q2.alias("q2"),
                           (q2 * lit(2.0)).alias("q4"), col("l_shipdate")],
                          CpuFilter(col("l_shipdate") > lit(9000, T.DATE32),
                                    li))
        return CpuAggregate([col("l_linenumber")],
                            [Sum(col("q2")).alias("s2"),
                             Sum(col("q4")).alias("s4"),
                             Average(col("l_shipdate")).alias("a"),
                             Count(None).alias("c")], proj)
    acc = accelerate(plan(), C.RapidsConf(dict(TB.BENCH_CONF)),
                     device="cpu")
    partial = [n for n in _walk(acc) if isinstance(n, HashAggregateExec)][-1]
    assert partial._dict_qual is not None

    def shared(e):
        return isinstance(e, SharedExpr) or any(map(shared, e.children()))
    assert [shared(e) for e in partial._pre_stage.out_exprs] == [
        False, True, True, False]
    compare_frames(plan().collect(), collect(acc), "dictionary lane")
    assert partial._dict_gpad is not None
