"""TPC-H Q2 and Q11-Q22 through spark_rapids_tpu_torch's planner
(`accelerate` + `collect`) against spark_rapids_tpu's `run_query`, on the
CPU, at the scale and seed of test_torch_tpch.py (whose fixtures this
file shares; a file of its own so that xdist can run it on another
worker).

Each query's result must match the reference's accelerated result and
both CPU engines (keys, counts and order exact, floats within
compare_frames' rtol 1e-5), its exec tree and fused aggregates the
reference's, and its aggregates and joins must take the reference's
lanes.  Q21 plans its two semi/anti joins with a residual condition as
CPU islands, as the reference does, and nothing else.
"""
from collections import Counter

import pytest
from parity import compare_frames
from test_torch_tpch import (_accelerate, _count_lanes, _tree, _walk,
                             cpu_run, ref_tables, reference, tables)

from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.joins import HashJoinExec
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

#: the shared fixtures, named so that pytest finds them in this module
FIXTURES = (tables, ref_tables, reference)

REST = [2] + list(range(11, 23))
#: the column whose order each query's result must keep
ORDER_KEYS = {2: "p_partkey", 11: "ps_partkey", 12: "l_shipmode",
              13: "c_count", 15: "s_suppkey", 16: "p_type",
              18: "o_orderkey", 20: "s_name", 21: "s_name",
              22: "cntrycode"}
#: lane decisions past the reference's.  Q22's anti join keeps its
#: output row count on the device, so the probe partition whose rich
#: customers all placed orders still reaches the aggregate, as an empty
#: batch the reference drops after reading its count: one more pass
#: through the same lanes, and the merge of the two partials
EXTRA_LANES = {22: Counter({("_dict_groupby_batch", False): 1,
                            ("_use_hash_grouping", True): 1,
                            ("_use_banded", False): 2,
                            ("_use_hash_grouping", False): 1})}
#: the modes of the aggregates that fuse a Filter/Project chain
FUSED_MODES = {2: ["complete"], 11: [], 12: [], 13: ["complete"], 14: [],
               15: ["partial"], 16: [], 17: ["complete"], 18: ["partial"],
               19: ["complete"], 20: ["partial"], 21: [],
               22: ["complete"]}
#: join lanes past the reference's.  The port's hash exchange cuts each
#: partition to its tight bucketed capacity: Q15's one top supplier
#: reaches the join as a 32-row build side, which the dense lane's
#: multiple-of-128 capacity rule refuses (the reference's exchange hands
#: over 8,192 rows of capacity)
JOIN_LANES = {15: ["sort-merge"]}


@pytest.mark.parametrize("query", REST)
def test_run_query_matches_reference_and_cpu_engine(tables, ref_tables,
                                                    reference, query):
    got = []
    lanes = _count_lanes(HashAggregateExec, lambda: got.append(
        TB.run_query(query, tables, device="cpu")))
    got = got[0]
    assert lanes == reference[query][2] + EXTRA_LANES.get(query, Counter())
    assert len(got) >= 1
    compare_frames(reference[query][0], got, f"q{query} vs reference")
    cpu = QUERIES[query](TD.sources(tables, 2), cpu_run).collect()
    compare_frames(cpu, got, f"q{query} vs the CPU engine")
    ref_cpu = RB.run_query(query, ref_tables, engine="cpu")
    compare_frames(ref_cpu, cpu, f"q{query} CPU engines")
    if query in ORDER_KEYS:
        key = ORDER_KEYS[query]
        assert list(got[key]) == list(reference[query][0][key]) == \
            list(cpu[key])


def _ref_join_lane(node) -> str:
    return ("dense" if any(e is not None for e, _ in
                           node._dense_tables.values()) else "sort-merge")


@pytest.mark.parametrize("query", REST)
def test_plan_matches_reference_tree(tables, reference, query):
    """The reference's exec tree, class for class, with the same
    aggregates fused; after a collect every join took the reference's
    lane."""
    ref_plan = reference[query][1]
    plan = _accelerate(query, tables)
    assert _tree(plan) == _tree(ref_plan)
    fused = [n.mode.value for n in _walk(plan)
             if isinstance(n, HashAggregateExec) and n.fused_members]
    ref_fused = [n.mode.value for n in _walk(ref_plan)
                 if type(n).__name__ == "HashAggregateExec"
                 and n.fused_members]
    assert fused == ref_fused == FUSED_MODES[query]
    collect(plan)
    lanes = [n.lane for n in _walk(plan) if isinstance(n, HashJoinExec)]
    assert lanes == JOIN_LANES.get(query, [
        _ref_join_lane(n) for n in _walk(ref_plan)
        if type(n).__name__ == "HashJoinExec"])
    assert all(lanes)


def test_q21_islands_are_the_two_residual_joins(tables, reference):
    """Q21's semi and anti joins with `l_suppkey != ...` conditions stay
    CpuHashJoin islands, as in the reference's plan; every other node
    runs on the device, so test.enabled passes once CpuHashJoin is
    allowed and fails without."""
    plan = _accelerate(21, tables)
    islands = [n for n in _walk(plan) if type(n).__name__.startswith("Cpu")]
    ref_islands = [n for n in _walk(reference[21][1])
                   if type(n).__name__.startswith("Cpu")]
    assert [type(n).__name__ for n in islands] == \
        [type(n).__name__ for n in ref_islands] == ["CpuHashJoin"] * 2
    assert [(n.join_type.name, n.condition is not None) for n in islands] \
        == [("LEFT_ANTI", True), ("LEFT_SEMI", True)]
    conf = {**TB.BENCH_CONF, C.TEST_ENABLED.key: True}
    with pytest.raises(AssertionError, match="CpuHashJoin"):
        _accelerate(21, tables, C.RapidsConf(conf))
    _accelerate(21, tables, C.RapidsConf(
        {**conf, C.TEST_ALLOWED_NONGPU.key: "CpuHashJoin"}))


def test_unported_cast_makes_a_cpu_island(tables):
    """A gated cast with its conf key off (float -> string,
    spark.rapids.sql.castFloatToString.enabled) stays on the CPU with the
    reference's reason, test.enabled refuses the plan, and the CPU node
    evaluates it in Java's notation; with the key on it runs on the
    device to the same strings."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan.cpu_eval import _java_float_str
    from spark_rapids_tpu_torch.plan.nodes import CpuProject

    def plan():
        return CpuProject([col("p_retailprice").cast(T.STRING).alias("s"),
                           col("p_size").cast(T.FLOAT64).alias("f")],
                          TD.sources(tables, 2)["part"])
    acc = accelerate(plan(), C.RapidsConf(dict(TB.BENCH_CONF)),
                     device="cpu")
    assert type(acc).__name__ == "CpuProject"
    assert any("float->string formatting differs from Java at extreme "
               "exponents; enable with "
               "spark.rapids.sql.castFloatToString.enabled" in r
               for r in acc._meta.reasons)
    got = collect(acc)
    prices = TD.sources(tables, 1)["part"].partitions[0]["p_retailprice"]
    assert sorted(got["s"]) == sorted(_java_float_str(float(p))
                                      for p in prices)
    with pytest.raises(AssertionError, match="CpuProject"):
        accelerate(plan(), C.RapidsConf({C.TEST_ENABLED.key: True}),
                   device="cpu")
    on = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                       C.CASTS_FLOAT_TO_STRING.key: True})
    dev = accelerate(plan(), on, device="cpu")
    assert sorted(collect(dev, on)["s"]) == sorted(got["s"])
