"""spark_rapids_tpu_torch's adaptive query execution (plan/aqe.py) and
broadcast hash join against spark_rapids_tpu's, twins of 15 of the 23
tests of tests/test_plugin_aqe.py: partition-spec coalescing, stage
materialization and coalescing, the broadcast demotion (and its
threshold), query-stage prep and its pinned verdicts, the broadcast
join's probe rebinding, stage buffers released after a collect (nested
stages too), AQE end to end through the planner, and a second collect
that materializes again.  Each result is held against the JAX package's
on the same seeded frames: rows exact, float sums within compare_frames'
rtol 1e-5 or the reference test's own 2e-3 where the dictionary lane's
f32 accumulators run.

TPC-H under AQE and a planner join with broadcast=True are in
tests/test_torch_aqe_tpch.py (a file of its own, so xdist can put it on
another worker: the JAX package's adaptive runs compile per shape).

Left out, with the layer that brings them: the seven plugin-lifecycle
tests (`TestPluginLifecycle`, plugin.py, ROADMAP.md item 10) and the
Python worker semaphore test (`TestPythonWorkerSemaphoreReentrancy`,
pyudf, item 10).
"""
import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exec.joins import BroadcastHashJoinExec as RBHJ
from spark_rapids_tpu.exec.joins import HashJoinExec as RHJ
from spark_rapids_tpu.exec.joins import JoinType as RJT
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.plan import aqe as raqe
from spark_rapids_tpu.shuffle.exchange import \
    BroadcastExchangeExec as RBExchange
from spark_rapids_tpu.shuffle.exchange import \
    ShuffleExchangeExec as RShuffle
from spark_rapids_tpu.shuffle.partitioning import \
    HashPartitioning as RHashPart
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.joins import (BroadcastHashJoinExec,
                                               HashJoinExec, JoinType)
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.plan import aqe
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.overrides import (ExecutionPlanCapture,
                                                   accelerate, collect)
from spark_rapids_tpu_torch.plan.transitions import batch_from_df
from spark_rapids_tpu_torch.shuffle.exchange import (BroadcastExchangeExec,
                                                     ShuffleExchangeExec)
from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _reset_conf(one_torch_thread):  # noqa: F811
    yield
    C.set_active_conf(C.RapidsConf())
    RC.set_active_conf(RC.RapidsConf())


def _src(df, parts=4):
    """The port's source over `df` cut into `parts` partitions, as the
    reference's LocalBatchSource.from_pandas cuts it."""
    schema = schema_of_df(df)
    bounds = np.linspace(0, len(df), parts + 1).astype(int)
    return LocalBatchSource(
        [[batch_from_df(df.iloc[a:b].reset_index(drop=True), schema,
                        "cpu")] if b > a else []
         for a, b in zip(bounds[:-1], bounds[1:])], schema, device="cpu")


def _rsrc(df, parts=4):
    return RSource.from_pandas(df, num_partitions=parts)


def _both(conf_dict):
    return C.RapidsConf(conf_dict), RC.RapidsConf(conf_dict)


def _same_rows(want: pd.DataFrame, got: pd.DataFrame, label=""):
    compare_frames(want.reset_index(drop=True), got.reset_index(drop=True),
                   label)


# --- partition specs --------------------------------------------------------
class TestCoalesceSpecs:
    def test_merges_adjacent_small(self):
        specs = aqe.coalesce_partition_specs([10, 10, 10, 10], 25)
        assert specs == [(0, 2), (2, 4)] == \
            raqe.coalesce_partition_specs([10, 10, 10, 10], 25)

    def test_large_partitions_stay_alone(self):
        specs = aqe.coalesce_partition_specs([100, 1, 1, 100], 50)
        assert specs == [(0, 1), (1, 3), (3, 4)] == \
            raqe.coalesce_partition_specs([100, 1, 1, 100], 50)

    def test_empty(self):
        assert aqe.coalesce_partition_specs([], 10) == [(0, 0)] == \
            raqe.coalesce_partition_specs([], 10)


class TestAdaptiveExecution:
    def _frame(self, rows=1000):
        rng = np.random.default_rng(0)
        return pd.DataFrame({
            "k": pd.array(rng.integers(0, 50, rows), "Int64"),
            "v": pd.array(rng.normal(size=rows), "Float64")})

    def _exchange_plan(self, rows=1000, parts=8):
        df = self._frame(rows)
        return df, ShuffleExchangeExec(
            HashPartitioning([col("k")], num_partitions=parts),
            _src(df, parts))

    def test_stage_materializes_once_and_coalesces(self):
        df, ex = self._exchange_plan()
        conf, rconf = _both({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": 1 << 40})
        plan = aqe.adaptive_execute(ex, conf)
        assert isinstance(plan, aqe.CustomShuffleReaderExec)
        assert plan.output_partition_count() == 1
        out = plan.collect().to_pandas()
        assert sorted(out["k"].tolist()) == sorted(df["k"].tolist())
        rplan = raqe.adaptive_execute(RShuffle(
            RHashPart([rcol("k")], num_partitions=8), _rsrc(df, 8)), rconf)
        assert type(rplan).__name__ == type(plan).__name__
        _same_rows(rplan.collect().to_pandas().sort_values(["k", "v"]),
                   out.sort_values(["k", "v"]))

    def test_no_coalesce_when_partitions_large_enough(self):
        _, ex = self._exchange_plan()
        conf = C.RapidsConf({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": 1})
        plan = aqe.adaptive_execute(ex, conf)
        assert isinstance(plan, aqe.ShuffleQueryStageExec)
        assert plan.output_partition_count() == 8

    def test_disabled_is_identity(self):
        _, ex = self._exchange_plan()
        assert aqe.adaptive_execute(ex, C.RapidsConf()) is ex
        assert C.RapidsConf()[C.ADAPTIVE_ENABLED] is \
            RC.RapidsConf()[RC.ADAPTIVE_ENABLED] is False

    @staticmethod
    def _join_frames():
        rng = np.random.default_rng(1)
        big = pd.DataFrame({
            "k": pd.array(rng.integers(0, 20, 500), "Int64"),
            "x": pd.array(rng.normal(size=500), "Float64")})
        small = pd.DataFrame({
            "k": pd.array(np.arange(20), "Int64"),
            "y": pd.array(np.arange(20) * 1.5, "Float64")})
        return big, small

    def test_join_demoted_to_broadcast(self):
        big, small = self._join_frames()
        n = 4
        join = HashJoinExec(
            JoinType.INNER, [col("k")], [col("k")],
            ShuffleExchangeExec(HashPartitioning([col("k")], n),
                                _src(big, 2)),
            ShuffleExchangeExec(HashPartitioning([col("k")], n),
                                _src(small, 2)))
        conf, rconf = _both({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.autoBroadcastJoinThreshold": 1 << 30})
        plan = aqe.adaptive_execute(join, conf)
        assert isinstance(plan, BroadcastHashJoinExec)
        assert isinstance(plan._build, BroadcastExchangeExec)
        out = plan.collect().to_pandas()
        rjoin = RHJ(RJT.INNER, [rcol("k")], [rcol("k")],
                    RShuffle(RHashPart([rcol("k")], n), _rsrc(big, 2)),
                    RShuffle(RHashPart([rcol("k")], n), _rsrc(small, 2)))
        rplan = raqe.adaptive_execute(rjoin, rconf)
        assert isinstance(rplan, RBHJ)
        _same_rows(rplan.collect().to_pandas(), out, "demoted join")
        expect = big.merge(small, on="k")
        assert len(out) == len(expect)

    def test_join_not_demoted_above_threshold(self):
        big, small = self._join_frames()
        n = 4
        join = HashJoinExec(
            JoinType.INNER, [col("k")], [col("k")],
            ShuffleExchangeExec(HashPartitioning([col("k")], n),
                                _src(big[["k"]], 2)),
            ShuffleExchangeExec(HashPartitioning([col("k")], n),
                                _src(small[["k"]], 2)))
        conf = C.RapidsConf({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.autoBroadcastJoinThreshold": 0,
            "spark.sql.adaptive.coalescePartitions.enabled": False})
        plan = aqe.adaptive_execute(join, conf)
        assert isinstance(plan, HashJoinExec)
        assert not isinstance(plan, BroadcastHashJoinExec)
        out = plan.collect().to_pandas()
        assert len(out) == len(big.merge(small, on="k"))

    def test_query_stage_prep_returns_plan_unchanged(self):
        df = pd.DataFrame({"a": pd.array([1, 2, 3], "Int64")})
        src = N.CpuSource.from_pandas(df)
        plan = N.CpuFilter(col("a") > 1, src)
        assert aqe.query_stage_prep(plan, C.RapidsConf()) is plan
        # verdicts are pinned onto the nodes (reference TreeNodeTag)
        assert plan._tpu_tag[0] is True
        assert src._tpu_tag[0] is True

    def test_pinned_off_tpu_verdict_survives_retag(self):
        """A node the whole-plan prep pinned off the device stays off it
        when a stage-local re-tag would accept it; the pin is used once."""
        df = pd.DataFrame({"a": pd.array([1, 2, 3], "Int64")})
        src = N.CpuSource.from_pandas(df)
        plan = N.CpuFilter(col("a") > 1, src)
        plan._tpu_tag = (False, frozenset({"whole-plan consistency pin"}))
        out = accelerate(plan, C.RapidsConf(), device="cpu")
        assert isinstance(out, N.CpuNode)
        ExecutionPlanCapture.assert_did_fall_back("CpuFilter")
        out2 = accelerate(plan, C.RapidsConf(), device="cpu")
        assert isinstance(out2, TpuExec)

    def test_broadcast_join_probe_side_rebinding(self):
        """A BroadcastHashJoinExec whose PROBE child is an exchange runs
        the adapted stage, not the raw exchange through a stale alias."""
        rng = np.random.default_rng(3)
        big = pd.DataFrame({"k": pd.array(rng.integers(0, 10, 400),
                                          "Int64")})
        small = pd.DataFrame({"k": pd.array(np.arange(10), "Int64")})
        join = BroadcastHashJoinExec(
            JoinType.INNER, [col("k")], [col("k")],
            ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                                _src(big, 2)),
            BroadcastExchangeExec(_src(small, 1)))
        conf, rconf = _both({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": 1 << 40})
        plan = aqe.adaptive_execute(join, conf)
        assert isinstance(plan, BroadcastHashJoinExec)
        assert isinstance(plan._probe, (aqe.CustomShuffleReaderExec,
                                        aqe.ShuffleQueryStageExec))
        out = plan.collect().to_pandas()
        rplan = raqe.adaptive_execute(RBHJ(
            RJT.INNER, [rcol("k")], [rcol("k")],
            RShuffle(RHashPart([rcol("k")], 4), _rsrc(big, 2)),
            RBExchange(_rsrc(small, 1))), rconf)
        _same_rows(rplan.collect().to_pandas().sort_values("k"),
                   out.sort_values("k"))
        assert len(out) == len(big.merge(small, on="k"))

    def _agg_plan(self, df, parts):
        from spark_rapids_tpu_torch.exprs.aggregates import AggAlias, Sum
        return N.CpuAggregate([col("k")], [AggAlias(Sum(col("v")), "s")],
                              N.CpuSource.from_pandas(df,
                                                      num_partitions=parts))

    def test_stage_buffers_released_after_collect(self):
        df = pd.DataFrame({
            "k": pd.array(np.arange(100) % 7, "Int64"),
            "v": pd.array(np.arange(100, dtype=float), "Float64")})
        conf = C.RapidsConf({
            "spark.sql.adaptive.enabled": True,
            "spark.rapids.sql.variableFloatAgg.enabled": True})
        C.set_active_conf(conf)
        plan = accelerate(self._agg_plan(df, 2), conf, device="cpu")
        collect(plan, conf)
        stages = []

        def walk(n):
            if isinstance(n, aqe.ShuffleQueryStageExec):
                stages.append(n)
            if isinstance(n, aqe.CustomShuffleReaderExec):
                stages.append(n.stage)
            for c in n.children:
                walk(c)
        walk(ExecutionPlanCapture.last_plan)
        assert stages, "the adaptive plan should hold a shuffle stage"
        assert all(s._buckets is None for s in stages)

    def test_collect_runs_adaptively_end_to_end(self):
        rng = np.random.default_rng(2)
        df = pd.DataFrame({
            "k": pd.array(rng.integers(0, 10, 300), "Int64"),
            "v": pd.array(rng.normal(size=300), "Float64")})
        conf = C.RapidsConf({
            "spark.sql.adaptive.enabled": True,
            "spark.rapids.sql.variableFloatAgg.enabled": True})
        C.set_active_conf(conf)
        out = collect(accelerate(self._agg_plan(df, 4), conf,
                                 device="cpu"), conf)
        out = out.sort_values("k").reset_index(drop=True)
        expect = (df.groupby("k", as_index=False)["v"].sum()
                  .rename(columns={"v": "s"})
                  .sort_values("k").reset_index(drop=True))
        # variableFloatAgg admits the dictionary lane's f32 accumulators:
        # the reference test's tolerance
        np.testing.assert_allclose(out["s"].astype(float),
                                   expect["s"].astype(float), rtol=2e-3)


class TestAqeRegression:
    def test_double_collect_rematerializes(self):
        df = pd.DataFrame({"k": pd.array(np.arange(50) % 5, "Int64")})
        ex = ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                                 _src(df, 2))
        conf = C.RapidsConf({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.advisoryPartitionSizeInBytes": 1 << 40})
        plan = aqe.adaptive_execute(ex, conf)
        first = plan.collect().to_pandas()
        aqe.release_stage_buffers(plan)
        second = plan.collect().to_pandas()  # runs the exchange again
        assert sorted(first["k"].tolist()) == sorted(second["k"].tolist())

    def test_nested_stage_buffers_released(self):
        """A shuffle above a shuffle: the inner stage is reachable only
        through the outer stage's exchange and is released all the
        same."""
        df = pd.DataFrame({"k": pd.array(np.arange(80) % 8, "Int64")})
        inner = ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                                    _src(df, 2))
        outer = ShuffleExchangeExec(HashPartitioning([col("k")], 2), inner)
        conf = C.RapidsConf({
            "spark.sql.adaptive.enabled": True,
            "spark.sql.adaptive.coalescePartitions.enabled": False})
        plan = aqe.adaptive_execute(outer, conf)
        assert isinstance(plan, aqe.ShuffleQueryStageExec)
        inner_stage = plan.exchange.children[0]
        assert isinstance(inner_stage, aqe.ShuffleQueryStageExec)
        plan.collect()
        aqe.release_stage_buffers(plan)
        assert plan._buckets is None
        assert inner_stage._buckets is None
