"""TPC-H Q1 and Q3-Q10 through spark_rapids_tpu_torch's planner
(`accelerate` + `collect`) against spark_rapids_tpu's `run_query`, on the
CPU, at the scale and seed tests/test_tpch.py uses; and the SF10 tables
of the join queries with chip_smoke.py's goldens, at small scales.

Keys and counts must match exactly and floats within compare_frames'
rtol 1e-5 (the banded lane adds f32, as the reference's does).
"""
from collections import Counter

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
from spark_rapids_tpu_torch.exec.joins import HashJoinExec
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
from spark_rapids_tpu_torch.ops import sort_encode as S
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

SCALE = 3000
SEED = 11
#: the queries of this file; the other 13 are in test_torch_tpch_rest.py
#: (a file of their own, so xdist can put them on another worker)
FIRST_NINE = [1, 3, 4, 5, 6, 7, 8, 9, 10]
#: the sort keys whose order each join query's result must keep
ORDER_KEYS = {3: "l_orderkey", 4: "o_orderpriority", 5: "n_name",
              7: "l_year", 8: "o_year", 9: "o_year", 10: "c_custkey"}


def cpu_run(plan):
    """The CPU engine's runner of a scalar subquery: the sub-plan
    collected on the CPU engine."""
    return plan.collect()


@pytest.fixture(scope="module")
def tables():
    return TD.gen_tables(np.random.default_rng(SEED), SCALE)


@pytest.fixture(scope="module")
def ref_tables():
    return RD.gen_tables(np.random.default_rng(SEED), SCALE)


#: the aggregate's lane decisions, per (method, decision taken)
_LANE_METHODS = ("_use_hash_grouping", "_use_banded", "_dict_groupby_batch")


def _count_lanes(cls, run) -> Counter:
    """The lane decisions every HashAggregateExec of `cls` takes while
    `run()` runs: (method, True/False) counted, a dictionary batch being
    one whose _dict_groupby_batch returned a result."""
    seen: Counter = Counter()
    saved = {m: getattr(cls, m) for m in _LANE_METHODS}

    def spy(name, fn):
        def call(self, *a, **k):
            out = fn(self, *a, **k)
            seen[name, out if isinstance(out, bool) else out is not None] \
                += 1
            return out
        return call
    try:
        for m, fn in saved.items():
            setattr(cls, m, spy(m, fn))
        run()
    finally:
        for m, fn in saved.items():
            setattr(cls, m, fn)
    return seen


class Reference(dict):
    """query -> the reference's accelerated result, plan and aggregate
    lane decisions, each query run on its first lookup only."""

    def __init__(self, ref_tables):
        super().__init__()
        self.ref_tables = ref_tables

    def __missing__(self, q):
        from spark_rapids_tpu.exec.aggregate import HashAggregateExec as RHA
        got = []
        lanes = _count_lanes(RHA, lambda: got.append(
            RB.run_query(q, self.ref_tables, engine="tpu")))
        self[q] = (got[0], RO.ExecutionPlanCapture.last_plan, lanes)
        return self[q]


@pytest.fixture(scope="module")
def reference(ref_tables):
    return Reference(ref_tables)


def _tree(plan) -> list:
    """Node class names in tree order (pre-order)."""
    return [type(n).__name__ for n in _walk(plan)]


def _accelerate(q, tables, conf=None):
    """Query q's plan through accelerate, its scalar subqueries collected
    through the planner as run_query collects them."""
    conf = conf or C.RapidsConf(dict(TB.BENCH_CONF))

    def run(plan):
        return collect(accelerate(plan, conf, device="cpu"), conf)
    return accelerate(QUERIES[q](TD.sources(tables, 2), run), conf,
                      device="cpu")


def test_gen_tables_matches_reference(tables, ref_tables):
    assert list(tables) == list(ref_tables)
    for name in tables:
        pd.testing.assert_frame_equal(tables[name], ref_tables[name],
                                      check_exact=True)
        assert TD.SCHEMAS[name].names == RD.SCHEMAS[name].names
        assert [f.dtype.id.value for f in TD.SCHEMAS[name]] == \
            [f.dtype.id.value for f in RD.SCHEMAS[name]]


@pytest.mark.parametrize("query", FIRST_NINE)
def test_run_query_matches_reference_and_cpu_engine(tables, ref_tables,
                                                    reference, query):
    got = []
    lanes = _count_lanes(HashAggregateExec, lambda: got.append(
        TB.run_query(query, tables, device="cpu")))
    got = got[0]
    # the aggregates take the reference's lanes on the same data (Q10's
    # seven keys, three of them long strings and one a double: the
    # murmur3 hash-grouping lane)
    assert lanes == reference[query][2]
    if query == 10:
        assert lanes[("_use_hash_grouping", True)] >= 1
    compare_frames(reference[query][0], got, f"q{query} vs reference")
    cpu = QUERIES[query](TD.sources(tables, 2), cpu_run).collect()
    compare_frames(cpu, got, f"q{query} vs the CPU engine")
    ref_cpu = RB.run_query(query, ref_tables, engine="cpu")
    compare_frames(ref_cpu, cpu, f"q{query} CPU engines")
    if query == 1:
        assert len(got) == 6 and got["count_order"].sum() == \
            (tables["lineitem"]["l_shipdate"] <= TD.days("1998-09-02")).sum()
    if query in ORDER_KEYS:
        key = ORDER_KEYS[query]
        assert len(got) > 1
        assert list(got[key]) == list(reference[query][0][key]) == \
            list(cpu[key])


#: the modes of the aggregates that fuse a Filter/Project chain: Q1's
#: and Q6's partial aggregate; Q3-Q5 aggregate straight off a join;
#: Q7-Q9's complete aggregate fuses the projection (and Q7's filter)
#: above its last join; Q10 groups the join's columns as they are
FUSED_MODES = {1: ["partial"], 3: [], 4: [], 5: [], 6: ["partial"],
               7: ["complete"], 8: ["complete"], 9: ["complete"], 10: []}


@pytest.mark.parametrize("query", FIRST_NINE)
def test_plan_matches_reference_tree(tables, reference, query):
    """The reference's exec tree, class for class, with the same
    aggregates fused; the join queries' joins take the reference's
    lanes."""
    plan = _accelerate(query, tables)
    assert _tree(plan) == _tree(reference[query][1])
    fused = [n.mode.value for n in _walk(plan)
             if isinstance(n, HashAggregateExec) and n.fused_members]
    ref_fused = [n.mode.value for n in _walk(reference[query][1])
                 if type(n).__name__ == "HashAggregateExec"
                 and n.fused_members]
    assert fused == ref_fused == FUSED_MODES[query]
    if query in ORDER_KEYS:
        collect(plan)
        lanes = [n.lane for n in _walk(plan) if isinstance(n, HashJoinExec)]
        ref_lanes = [
            "dense" if any(e is not None for e, _ in
                           n._dense_tables.values()) else "sort-merge"
            for n in _walk(reference[query][1])
            if type(n).__name__ == "HashJoinExec"]
        assert lanes == ref_lanes


def _walk(plan):
    """Every node in pre-order, through the device/CPU transitions of a
    plan with CPU islands."""
    yield plan
    for c in list(plan.children) + [getattr(plan, a) for a in (
            "cpu_child", "tpu_child") if hasattr(plan, a)]:
        yield from _walk(c)


@pytest.mark.parametrize("query", [5, 7])
def test_a_dropped_plan_is_freed_at_once(tables, query):
    """Nothing of the planner's own keeps a plan alive in a reference
    cycle: dropping it frees its uploaded batches at once, without
    waiting for the cycle collector (Q7 shares nation through a
    CommonSubplanExec)."""
    import gc
    import weakref
    plan = _accelerate(query, tables)
    collect(plan)
    ref = weakref.ref(plan)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        del plan
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()


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
            accelerate(QUERIES[6](TD.sources(tables, 2), cpu_run))


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
    want = QUERIES[1](TD.sources(tables, 2), cpu_run).collect()
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


@pytest.fixture(scope="module")
def sf_small():
    """sf10_tables at scale factor 0.002: 30,000 orders, ~120,000
    lines."""
    return TB.sf10_tables(3, 0.002)


def test_sf10_tables_follow_dbgen_keys(sf_small):
    tables, arrays = sf_small
    orders, li = tables["orders"], tables["lineitem"]
    assert [len(tables[t]) for t in ("region", "nation", "supplier",
                                     "customer", "orders")] == \
        [5, 25, 20, 300, 3000]
    assert 3000 <= len(li) <= 7 * 3000
    for name, df in tables.items():
        assert TD.SCHEMAS[name].names == tuple(df.columns)
    okey = orders["o_orderkey"].to_numpy()
    assert np.all(((okey - 1) % 32) < 8) and len(np.unique(okey)) == 3000
    assert np.isin(li["l_orderkey"], okey).all()
    assert not np.any(orders["o_custkey"] % 3 == 0)
    assert orders["o_custkey"].between(1, 300).all()
    odate = pd.Series(orders["o_orderdate"].to_numpy(), index=okey)
    ship_gap = li["l_shipdate"].to_numpy() - \
        odate[li["l_orderkey"]].to_numpy()
    assert ship_gap.min() >= 1 and ship_gap.max() <= 121
    assert (li["l_receiptdate"] > li["l_shipdate"]).all()
    # l_suppkey is one of the part's 4 suppliers (dbgen's partsupp rule)
    p, n = li["l_partkey"].to_numpy(), 20
    options = np.stack([(p + i * (n // 4 + (p - 1) // n)) % n + 1
                        for i in range(4)])
    assert (options == li["l_suppkey"].to_numpy()).any(axis=0).all()
    assert np.array_equal(arrays["l_orderkey"], li["l_orderkey"])


#: phase 9's rows over sf_parts
REST_ROWS = {2: 14, 11: 761, 12: 2, 13: 27, 14: 1, 15: 1, 16: 653, 17: 1,
             18: 100, 19: 1, 20: 6, 21: 7, 22: 7}


@pytest.fixture(scope="module")
def sf_parts():
    """sf10_tables at scale factor 0.025: 250 suppliers, the fewest with
    which dbgen's partsupp rule gives every part 4 distinct suppliers
    (at 0.002's 20 a part can repeat one, in dbgen too); 5,000 parts,
    37,500 orders, ~150,000 lines."""
    return TB.sf10_tables(5, 0.025)


def test_sf10_part_and_partsupp_follow_dbgen(sf_small, sf_parts):
    for tables, arrays in (sf_small, sf_parts):
        part, ps = tables["part"], tables["partsupp"]
        n_part, n_supp = len(part), len(tables["supplier"])
        assert n_part == 20 * n_supp and len(ps) == 4 * n_part
        assert np.array_equal(part["p_partkey"], np.arange(1, n_part + 1))
        # partsupp row 4 (p - 1) + i is supplier number i of part p
        i = np.tile(np.arange(4), n_part)
        assert np.array_equal(ps["ps_partkey"], np.repeat(
            part["p_partkey"].to_numpy(), 4))
        assert np.array_equal(ps["ps_suppkey"], TB.part_suppkey(
            ps["ps_partkey"].to_numpy(), i, n_supp))
        assert ps["ps_availqty"].between(1, 9999).all()
        assert ps["ps_supplycost"].between(1.0, 1000.0).all()
        names = part["p_name"].str.split(" ")
        assert (names.map(len) == 5).all()
        assert (names.map(lambda w: len(set(w))) == 5).all()
        assert names.map(lambda w: set(w) <= set(TD.COLORS)).all()
        assert np.array_equal(arrays["p_green"],
                              part["p_name"].str.contains("green"))
        types = part["p_type"].astype(str).str.split(" ", expand=True)
        assert types[0].isin(TD.TYPE_S1).all() and \
            types[1].isin(TD.TYPE_S2).all() and types[2].isin(TD.TYPE_S3).all()
        assert np.array_equal(part["p_type"].cat.codes, arrays["p_type"])
        cust = tables["customer"]
        assert list(cust["c_name"]) == [f"Customer#{k:09d}"
                                        for k in cust["c_custkey"]]
        assert cust["c_address"].astype(str).str.len().between(10, 40).all()
        assert cust["c_comment"].astype(str).str.len().between(
            29, 116).all()
    tables, _ = sf_parts
    ps = tables["partsupp"]
    assert ps.groupby("ps_partkey")["ps_suppkey"].nunique().eq(4).all()
    # every line has exactly one partsupp row
    li = tables["lineitem"][["l_partkey", "l_suppkey"]]
    hits = li.merge(ps, left_on=["l_partkey", "l_suppkey"],
                    right_on=["ps_partkey", "ps_suppkey"])
    assert len(hits) == len(li)


#: the strings the queries past Q10 read, redrawn from a stream of
#: their own
REDRAWN = {"s_name", "s_address", "s_comment", "o_comment"}
#: sha256 (first 16 hex digits) of every other column of each table,
#: and of the golden arrays of Q3-Q10, at sf_small and at sf_parts, as
#: the generator made them before the redraw
KEPT_BYTES = {
    (3, 0.002): {"region": "723dd0c02bf1cf67", "nation": "e7f72f84903e62c4",
                 "supplier": "160268e94d7e4aff",
                 "customer": "a732c6afcf5b60f5", "part": "873fa6945c936af2",
                 "partsupp": "e592fc13b66e4a04",
                 "orders": "0947d586f0d6f703",
                 "lineitem": "157e3a1fdefd1fcf",
                 "arrays": "7c75c153a78f4b69"},
    (5, 0.025): {"region": "b0775f3e623f7c60", "nation": "ccb729055cc87f38",
                 "supplier": "a77b3cb3e2a255ef",
                 "customer": "96a7699951ff7f98", "part": "05ae82075dcb25ad",
                 "partsupp": "1c3462c38605dadf",
                 "orders": "4d84c31637498e26",
                 "lineitem": "41a5339954e74bd9",
                 "arrays": "4ba5218c1e3a5e0b"}}
_KEPT_ARRAYS = [
    "c_acctbal", "c_mktsegment", "c_nationkey", "l_commitdate", "l_discount",
    "l_extendedprice", "l_orderkey", "l_partkey", "l_quantity",
    "l_receiptdate", "l_returnflag", "l_shipdate", "l_suppkey",
    "n_regionkey", "o_custkey", "o_orderdate", "o_orderkey",
    "o_orderpriority", "p_green", "p_type", "ps_supplycost", "s_nationkey"]


def _kept_bytes(tables, arrays) -> dict:
    import hashlib
    out = {}
    for name, df in tables.items():
        h = hashlib.sha256()
        for c in df.columns:
            if c in REDRAWN:
                continue
            if pd.api.types.is_numeric_dtype(df[c].dtype):
                h.update(df[c].to_numpy().tobytes())
            else:
                h.update("\x1f".join(df[c].astype(str)).encode())
        out[name] = h.hexdigest()[:16]
    h = hashlib.sha256()
    for k in _KEPT_ARRAYS:
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    out["arrays"] = h.hexdigest()[:16]
    return out


def test_sf10_strings_past_q10_follow_dbgen(sf_small, sf_parts):
    """s_name is Supplier#%09d, s_address a 10-40 character v-string,
    s_comment 25-100 characters with dbgen's Customer ... Complaints and
    Customer ... Recommends rows (5 of each per 10,000 suppliers, at
    least one), o_comment 19-78 characters with 1.0% of the orders
    matching '%special%requests%'; every other column, and the golden
    arrays of Q3-Q10, keep their bytes."""
    import re
    for key, (tables, arrays) in zip(KEPT_BYTES, (sf_small, sf_parts)):
        assert _kept_bytes(tables, arrays) == KEPT_BYTES[key]
        supp, orders = tables["supplier"], tables["orders"]
        n = len(supp)
        assert list(supp["s_name"]) == [f"Supplier#{k:09d}"
                                        for k in supp["s_suppkey"]]
        assert supp["s_name"].is_unique
        assert supp["s_address"].astype(str).str.len().between(10, 40).all()
        comment = supp["s_comment"].astype(str)
        assert comment.str.len().between(25, 100).all()
        complaint = comment.str.contains("Customer.*Complaints", regex=True)
        recommend = comment.str.contains("Customer.*Recommends", regex=True)
        k = max(1, round(5 * n / 10_000))
        assert complaint.sum() == recommend.sum() == k
        assert np.array_equal(complaint.to_numpy(), arrays["s_complaint"])
        text = orders["o_comment"].astype(str)
        assert text.str.len().between(19, 78).all()
        special = text.map(lambda x: re.search("special.*requests", x)
                           is not None).to_numpy()
        assert np.array_equal(special, arrays["o_special"])
        assert 0.005 < special.mean() < 0.015
        assert text.str.contains("requests.*special", regex=True).any()


@pytest.mark.parametrize("query", [3, 4, 5, 7, 8, 9, 10, 2] +
                         list(range(11, 23)))
def test_chip_smoke_join_goldens_match_the_cpu_run(request, query):
    """chip_smoke.py's float64 numpy goldens for every query but Q1 and
    Q6 against the port's run_query on the CPU, over the same small draw;
    phase 9's queries (Q2, Q11-Q22) as the phase runs them: 16
    partitions, test.enabled, the exec tree of REST_TREES, and the
    scalar subqueries' own results held too."""
    import chip_smoke
    tables, arrays = request.getfixturevalue(
        "sf_small" if query in (3, 4, 5) else "sf_parts")
    if query == 2 or query > 10:
        islands = ({C.TEST_ALLOWED_NONGPU.key: "CpuHashJoin"}
                   if query == 21 else {})
        conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                             **islands})
        sub = []

        def run(plan):
            sub.append(collect(accelerate(plan, conf, device="cpu"), conf))
            return sub[-1]
        plan = accelerate(QUERIES[query](
            TD.sources(tables, TB.SF10_PARTITIONS), run), conf, device="cpu")
        assert chip_smoke.tree_names(plan) == [
            chip_smoke.TREE_CODES[c]
            for c in chip_smoke.REST_TREES[query].split()]
        got = collect(plan, conf)
        gold = chip_smoke.golden_rest(arrays, tables, TD, TB)[query]
        assert chip_smoke.check_rest_query(query, got, gold, sub) <= 1e-6
        assert len(sub) == (1 if query in (11, 15, 22) else 0)
        assert len(got) == REST_ROWS[query]
        return
    got = TB.run_query(query, tables, device="cpu", num_partitions=4)
    if query < 7:
        gold = chip_smoke.golden_joins(arrays, TD)[query]
        assert chip_smoke.check_join_query(query, got, gold) <= 1e-6
        want_rows = len(gold["nation"]) if query == 5 else \
            (10, 5)[query - 3]
    else:
        gold = chip_smoke.golden_parts(arrays, tables["customer"], TD,
                                       TB)[query]
        assert chip_smoke.check_part_query(query, got, gold) <= 1e-6
        want_rows = {7: 4, 8: 2, 9: 175, 10: 20}[query]
    assert len(got) == want_rows
