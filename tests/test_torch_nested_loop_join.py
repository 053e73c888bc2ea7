"""spark_rapids_tpu_torch's brute-force joins against spark_rapids_tpu's:
twins of tests/test_plan_overrides.py's nested-loop and cartesian cases
(disabled by default, planned on the device when enabled) and of
tests/test_shuffle_joins.py's CartesianProductExec and NestedLoopJoinExec
target-size cases, each on the same frames through both packages, with
the rows compared exactly; plus the column pruning of a conditioned
nested-loop join below a projection.
"""
import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exec.joins import CartesianProductExec as RCartesian
from spark_rapids_tpu.exec.joins import JoinType as RJT
from spark_rapids_tpu.exec.joins import NestedLoopJoinExec as RNLJ
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.joins import (CartesianProductExec, JoinType,
                                               NestedLoopJoinExec)
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.overrides import (ExecutionPlanCapture,
                                                   accelerate, collect)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _key(name: str) -> str:
    return C.op_enable_key("exec", name)


def _both(make, settings: dict):
    """`make(N, E, JT)` planned and collected by each package under
    `settings`: (reference frame, port frame, port plan)."""
    ref_conf = RC.RapidsConf(settings)
    ref = RO.collect(RO.accelerate(make(RN, RE, RJT), ref_conf), ref_conf)
    conf = C.RapidsConf(settings)
    plan = accelerate(make(N, E, JoinType), conf, device="cpu")
    return ref, collect(plan, conf), plan


def _walk(plan):
    yield plan
    for ch in plan.children:
        yield from _walk(ch)


def test_nested_loop_join_disabled_by_default():
    """Brute-force joins fall back unless enabled (the reference's
    disabledByDefault, GpuOverrides.scala:1770-1789)."""
    def make(NS, ES, JT):
        left = NS.CpuSource.from_pandas(pd.DataFrame(
            {"x": np.arange(5, dtype=np.int64)}))
        right = NS.CpuSource.from_pandas(pd.DataFrame(
            {"y": np.arange(3, dtype=np.int64)}))
        return NS.CpuNestedLoopJoin(JT.INNER, left, right,
                                    ES.col("x") > ES.col("y"))
    ref, got, _ = _both(make, {})
    ExecutionPlanCapture.assert_did_fall_back("CpuNestedLoopJoin")
    got = got.sort_values(["x", "y"], ignore_index=True)
    assert len(got) == sum(1 for x in range(5) for y in range(3) if x > y)
    pd.testing.assert_frame_equal(
        got, ref.sort_values(["x", "y"], ignore_index=True),
        check_dtype=False)


def test_nested_loop_join_planned_on_the_device():
    """Enabled, a non-equi inner join plans onto NestedLoopJoinExec, equal
    to the CPU engine and to the reference's device plan."""
    rng = np.random.default_rng(7)
    ldf = pd.DataFrame({"x": rng.integers(0, 20, 40).astype(np.int64),
                        "lv": rng.uniform(0, 1, 40)})
    rdf = pd.DataFrame({"y": rng.integers(0, 20, 15).astype(np.int64),
                        "rv": rng.uniform(0, 1, 15)})

    def make(NS, ES, JT):
        return NS.CpuNestedLoopJoin(
            JT.INNER, NS.CpuSource.from_pandas(ldf),
            NS.CpuSource.from_pandas(rdf), ES.col("x") > ES.col("y"))
    order = ["x", "y", "lv", "rv"]
    expected = make(N, E, JoinType).collect().sort_values(
        order, ignore_index=True)
    ref, got, plan = _both(make, {_key("CpuNestedLoopJoin"): True})
    assert isinstance(plan, TpuExec)
    assert any(isinstance(p, NestedLoopJoinExec) for p in _walk(plan)), \
        f"no NestedLoopJoinExec in:\n{plan}"
    got = got.sort_values(order, ignore_index=True)
    pd.testing.assert_frame_equal(got, expected, check_dtype=False)
    pd.testing.assert_frame_equal(
        got, ref.sort_values(order, ignore_index=True), check_dtype=False)


def test_cartesian_product_planned_on_the_device():
    """A CROSS join with no condition, enabled by its own key (the
    reference's separate exec[CartesianProductExec] rule)."""
    def make(NS, ES, JT):
        return NS.CpuCartesianProduct(
            NS.CpuSource.from_pandas(pd.DataFrame(
                {"x": np.arange(4, dtype=np.int64)})),
            NS.CpuSource.from_pandas(pd.DataFrame(
                {"y": np.arange(3, dtype=np.int64)})))
    _, off, _ = _both(make, {})  # disabled by default
    ExecutionPlanCapture.assert_did_fall_back("CpuCartesianProduct")
    ref, got, plan = _both(make, {_key("CpuCartesianProduct"): True})
    assert isinstance(plan, TpuExec)
    got = got.sort_values(["x", "y"], ignore_index=True)
    assert len(got) == 12
    for other in (ref, off):
        pd.testing.assert_frame_equal(
            got, other.sort_values(["x", "y"], ignore_index=True),
            check_dtype=False)


def _source(df, pkg_source):
    return pkg_source.from_pandas(df) if pkg_source is RSource else \
        LocalBatchSource([[ColumnarBatch.from_numpy(
            {c: df[c].to_numpy() for c in df}, device="cpu")]],
            device="cpu")


def test_cartesian_product():
    a = pd.DataFrame({"x": np.array([1, 2, 3], np.int64)})
    b = pd.DataFrame({"y": np.array([10, 20], np.int64)})
    ref = RCartesian(_source(a, RSource), _source(b, RSource)).to_pandas()
    out = CartesianProductExec(_source(a, None),
                               _source(b, None)).to_pandas()
    assert len(out) == 6
    assert sorted(map(tuple, out.values)) == sorted(
        (x, y) for x in [1, 2, 3] for y in [10, 20])
    # left-major pairs, as the reference emits them
    assert out.values.tolist() == ref.values.tolist()


def test_nested_loop_join_target_size_sharding():
    """target_size_bytes bounds the pair expansion: the left side is cut
    so one pair block fits, the rows unchanged (reference
    GpuBroadcastNestedLoopJoinExec targetSizeBytes)."""
    ldf = pd.DataFrame({"x": np.arange(200, dtype=np.int64)})
    rdf = pd.DataFrame({"y": np.arange(7, dtype=np.int64)})
    exp = ldf.merge(rdf, how="cross")
    exp = exp[exp["x"] % 11 > exp["y"]].sort_values(
        ["x", "y"], ignore_index=True)
    rj = RNLJ(_source(ldf, RSource), _source(rdf, RSource),
              condition=RE.col("x") % RE.lit(11) > RE.col("y"),
              join_type=RJT.INNER)
    rj.target_size_bytes = 2048
    j = NestedLoopJoinExec(_source(ldf, None), _source(rdf, None),
                           condition=E.col("x") % E.lit(11) > E.col("y"),
                           join_type=JoinType.INNER)
    j.target_size_bytes = 2048  # forces several left pieces
    batches = list(j.execute_columnar())
    assert len(batches) > 1
    got = j.to_pandas().sort_values(["x", "y"], ignore_index=True)
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)
    ref = rj.to_pandas().sort_values(["x", "y"], ignore_index=True)
    pd.testing.assert_frame_equal(got, ref, check_dtype=False)


def test_a_conditioned_nested_loop_join_prunes_its_inputs():
    """Below a projection, each side keeps only the columns the
    projection and the condition read."""
    from spark_rapids_tpu_torch.plan.pruning import prune_columns
    ldf = pd.DataFrame({"x": np.arange(6, dtype=np.int64),
                        "unused_l": np.arange(6.0)})
    rdf = pd.DataFrame({"y": np.arange(4, dtype=np.int64),
                        "w": np.arange(4, dtype=np.int64) * 10,
                        "unused_r": np.arange(4.0)})
    node = N.CpuProject(
        [E.col("x"), E.col("w")],
        N.CpuNestedLoopJoin(JoinType.INNER, N.CpuSource.from_pandas(ldf),
                            N.CpuSource.from_pandas(rdf),
                            E.col("x") > E.col("y")))
    pruned = prune_columns(node)
    join = pruned.child
    assert list(join.children[0].output_schema().names) == ["x"]
    assert list(join.children[1].output_schema().names) == ["y", "w"]
    pd.testing.assert_frame_equal(pruned.collect(), node.collect())
    conf = C.RapidsConf({_key("CpuNestedLoopJoin"): True})
    got = collect(accelerate(node, conf, device="cpu"), conf)
    pd.testing.assert_frame_equal(
        got.sort_values(["x", "w"], ignore_index=True),
        node.collect().sort_values(["x", "w"], ignore_index=True),
        check_dtype=False)
