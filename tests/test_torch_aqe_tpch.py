"""spark_rapids_tpu_torch's adaptive query execution through the planner
against spark_rapids_tpu's: TPC-H Q3, Q5 and Q10 with
spark.sql.adaptive.enabled (each final plan with query stages and at
least one demoted broadcast join) against the JAX package's adaptive run
of Q3 and Q5 on the same frames and against the port's run without
AQE, and a planner join with broadcast=True against the
shuffled join and the reference's broadcast join (compare_frames' rtol
1e-5).  The twins of tests/test_plugin_aqe.py are in
tests/test_torch_aqe.py.
"""
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exec.joins import JoinType as RJT
from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.models.tpch_queries import QUERIES as RQUERIES
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
from spark_rapids_tpu_torch.plan import aqe
from spark_rapids_tpu_torch.plan.overrides import (ExecutionPlanCapture,
                                                   accelerate, collect)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


# --- TPC-H through the planner under AQE ------------------------------------
SF, PARTS = 0.002, 2


@pytest.fixture(scope="module")
def sf_tables():
    return TB.sf10_tables(0, sf=SF)[0]


def _walk(node):
    yield node
    kids = list(node.children)
    if isinstance(node, aqe.ShuffleQueryStageExec):
        kids.append(node.exchange)
    if isinstance(node, aqe.CustomShuffleReaderExec):
        kids.append(node.stage)
    for c in kids:
        yield from _walk(c)


@pytest.mark.parametrize("query,against_reference",
                         [(3, True), (5, True), (10, False)])
def test_tpch_adaptive_matches_the_reference(query, against_reference,
                                             sf_tables):
    """Q3, Q5 and Q10 with spark.sql.adaptive.enabled: the final plan
    has query stages and a demoted broadcast join, and the result equals
    the port's own run without AQE and, for Q3 and Q5, the JAX package's
    adaptive run of the same query on the same frames (Q10's reference
    run compiles for ~18 s on this box; its plan without AQE is held
    against the reference in test_torch_tpch.py)."""
    settings = {**TB.BENCH_CONF, "spark.sql.adaptive.enabled": True}
    conf = C.RapidsConf(settings)
    plan = accelerate(QUERIES[query](TD.sources(sf_tables, PARTS), None),
                      conf, device="cpu")
    got = collect(plan, conf)
    final = ExecutionPlanCapture.last_plan
    names = {type(n).__name__ for n in _walk(final)}
    assert "ShuffleQueryStageExec" in names, names
    assert "BroadcastHashJoinExec" in names, names
    plain = TB.run_query(query, sf_tables, device="cpu",
                         conf=C.RapidsConf(dict(TB.BENCH_CONF)),
                         num_partitions=PARTS)
    compare_frames(plain, got, f"q{query} with and without AQE")
    if not against_reference:
        return
    rconf = RC.RapidsConf({**RB.BENCH_CONF,
                           "spark.sql.adaptive.enabled": True})

    def rrun(p):
        return RO.collect(RO.accelerate(p, rconf), rconf)
    want = rrun(RQUERIES[query](RD.sources(sf_tables, PARTS), rrun))
    compare_frames(want, got, f"q{query} against the reference")


def test_planner_broadcast_join(sf_tables):
    """A join planned with broadcast=True runs as a BroadcastHashJoinExec
    (no NotImplementedError, no CPU island) and equals the shuffled
    join and the reference's broadcast join."""
    from spark_rapids_tpu.models import tpch_queries as RQ
    from spark_rapids_tpu_torch.models import tpch_queries as TQ
    t = TD.sources(sf_tables, 4)
    conf = C.RapidsConf(dict(TB.BENCH_CONF))
    results = {}
    for bc in (False, True):
        plan = accelerate(TQ._join(JoinType.INNER, t["orders"],
                                   t["customer"], ["o_custkey"],
                                   ["c_custkey"], broadcast=bc),
                          conf, device="cpu")
        assert isinstance(plan, TpuExec)
        kinds = {type(n).__name__ for n in _walk(plan)}
        assert ("BroadcastHashJoinExec" in kinds) is bc, kinds
        results[bc] = collect(plan, conf)
    compare_frames(results[False], results[True], "broadcast")
    rconf = RC.RapidsConf(dict(RB.BENCH_CONF))
    rt = RD.sources(sf_tables, 4)
    want = RO.collect(RO.accelerate(RQ._join(
        RJT.INNER, rt["orders"], rt["customer"], ["o_custkey"],
        ["c_custkey"], broadcast=True), rconf), rconf)
    compare_frames(want, results[True], "against the reference")
