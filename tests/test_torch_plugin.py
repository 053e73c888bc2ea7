"""spark_rapids_tpu_torch's plugin lifecycle (plugin.py), the shim surface
it and the planner route through (shims/), and the API audit
(api_validation.py), against spark_rapids_tpu's: twins of the seven
`TestPluginLifecycle` tests and
`TestPythonWorkerSemaphoreReentrancy.test_stacked_map_in_pandas_single_worker`
of tests/test_plugin_aqe.py, of tests/test_fuzz.py's
test_api_validation_all_versions, and of the tests/test_shims.py cases
that tests/test_torch_plan_gaps.py does not already twin (the per-version
shuffle managers, the Databricks AQE reader name and prep rule, the
map-index-range gate, First/Last construction, the transition classes
and the accelerated transition's parity and planning, build sides, and
AQE keeping a pinned partition count).

Each result is held against the JAX package's on the same frames, rows
exact; the lifecycle runs with device="cpu" (without it, activate()
raises on a machine with no card: tests/test_torch_guards.py).  ~8 s
alone.
"""
import importlib

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import plugin as RP
from spark_rapids_tpu import shims as RSH
from spark_rapids_tpu.api_validation import \
    audit_all_versions as ref_audit_all_versions
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu.plan.transitions import \
    AcceleratedColumnarToRowExec as RAccel
from spark_rapids_tpu.plan.transitions import ColumnarToRowExec as RC2R
from spark_rapids_tpu.pyudf.exec import CpuMapInPandas as RMapInPandas
from spark_rapids_tpu.pyudf.semaphore import \
    PythonWorkerSemaphore as RWorkerSem
from spark_rapids_tpu.shuffle.manager import MapOutputRegistry as RRegistry
from spark_rapids_tpu.shuffle.manager import MapStatus as RMapStatus
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import plugin as P
from spark_rapids_tpu_torch import shims as SH
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api_validation import (SHIM_SURFACE,
                                                   audit_all_versions)
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.joins import JoinType, NestedLoopJoinExec
from spark_rapids_tpu_torch.exprs.aggregates import First, Last
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.memory.env import ResourceEnv
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.transitions import (
    AcceleratedColumnarToRowExec, ColumnarToRowExec, batch_from_df)
from spark_rapids_tpu_torch.pyudf.exec import CpuMapInPandas
from spark_rapids_tpu_torch.pyudf.semaphore import PythonWorkerSemaphore
from spark_rapids_tpu_torch.shuffle.manager import (MapOutputRegistry,
                                                    MapStatus,
                                                    TpuShuffleManager)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _reset_conf(one_torch_thread):  # noqa: F811
    yield
    C.set_active_conf(C.RapidsConf())
    RC.set_active_conf(RC.RapidsConf())


def _batch(df):
    return batch_from_df(df, schema_of_df(df), "cpu")


def _src(df, parts=1):
    schema = schema_of_df(df)
    bounds = np.linspace(0, len(df), parts + 1).astype(int)
    return LocalBatchSource(
        [[batch_from_df(df.iloc[a:b].reset_index(drop=True), schema,
                        "cpu")] for a, b in zip(bounds[:-1], bounds[1:])],
        schema, device="cpu")


# -- the plugin lifecycle -----------------------------------------------------
class TestPluginLifecycle:
    def test_fixup_injects_sql_extension(self):
        conf = P.fixup_configs({})
        assert conf["spark.sql.extensions"] == P._SQL_EXTENSION == \
            "spark_rapids_tpu_torch.plugin.SQLExecPlugin"
        assert P.fixup_configs(conf)["spark.sql.extensions"].count(
            P._SQL_EXTENSION) == 1
        ref = RP.fixup_configs({})
        assert ref["spark.sql.extensions"] == RP._SQL_EXTENSION

    def test_fixup_appends_kryo_registrator(self):
        settings = {
            "spark.serializer": "org.apache.spark.serializer.KryoSerializer",
            "spark.kryo.registrator": "com.example.MyRegistrator"}
        regs = P.fixup_configs(settings)["spark.kryo.registrator"]
        ref = RP.fixup_configs(settings)["spark.kryo.registrator"]
        assert regs.split(",") == ["com.example.MyRegistrator",
                                   P._KRYO_REGISTRATOR]
        assert regs.replace("_torch", "") == ref
        # the registrator named is the port's class
        mod, name = P._KRYO_REGISTRATOR.rsplit(".", 1)
        assert getattr(importlib.import_module(mod), name) is \
            P.TpuKryoRegistrator

    def test_fixup_rejects_unknown_serializer(self):
        for m in (P, RP):
            with pytest.raises(ValueError, match="serializer"):
                m.fixup_configs({"spark.serializer": "com.example.Custom"})

    def test_driver_plugin_returns_rapids_conf_map(self):
        for m in (P, RP):
            spark_conf = {"spark.rapids.sql.enabled": "true",
                          "spark.rapids.sql.explain": "ALL",
                          "spark.executor.cores": "4"}
            shipped = m.DriverPlugin().init(spark_conf)
            assert shipped == {"spark.rapids.sql.enabled": "true",
                               "spark.rapids.sql.explain": "ALL"}
            assert "spark.sql.extensions" in spark_conf

    def test_activate_initializes_resource_env(self, tmp_path):
        conf = P.activate({"spark.rapids.sql.batchSizeBytes": 1 << 20},
                          spill_dir=str(tmp_path), device="cpu")
        try:
            assert conf[C.BATCH_SIZE_BYTES] == 1 << 20
            env = ResourceEnv.get()
            assert env.device_store is not None
            assert env.device.type == "cpu"
            assert C.get_active_conf()[C.BATCH_SIZE_BYTES] == 1 << 20
            # the installed rules accelerate for the executor's device
            ext = P.active_extensions()
            rules = ext.columnar_rules[0](conf)
            df = pd.DataFrame({"a": pd.array([1, 2, None], "Int64")})
            plan = rules.pre_columnar_transitions(N.CpuProject(
                [(col("a") + 1).alias("b")], N.CpuSource.from_pandas(df)))
            got = O.collect(plan, conf)
            want = RO.collect(RO.accelerate(RN.CpuProject(
                [(rcol("a") + 1).alias("b")], RN.CpuSource.from_pandas(df))))
            pd.testing.assert_frame_equal(got, want, check_dtype=False)
            assert rules.post_columnar_transitions(plan) is plan
            prep = ext.query_stage_prep_rules[0](conf)
            assert callable(prep)
        finally:
            P.deactivate()
        assert ResourceEnv.peek() is None
        assert C.get_active_conf()[C.BATCH_SIZE_BYTES] != 1 << 20

    def test_executor_init_failure_is_fatal(self):
        for m, kw in ((P, {"device": "cpu"}), (RP, {})):
            with pytest.raises(m.ExecutorInitError):
                m.ExecutorPlugin().init(
                    {"spark.rapids.memory.host.spillStorageSize": object()},
                    **kw)

    def test_kryo_registrator_roundtrip(self):
        P.TpuKryoRegistrator.register_all(device="cpu")
        RP.TpuKryoRegistrator.register_all()
        df = pd.DataFrame({"a": pd.array([1, 2, None], "Int64")})
        back = P.TpuKryoRegistrator.deserialize(
            ColumnarBatch, P.TpuKryoRegistrator.serialize(_batch(df)))
        rback = RP.TpuKryoRegistrator.deserialize(
            RBatch, RP.TpuKryoRegistrator.serialize(RBatch.from_pandas(df)))
        out, want = back.to_pandas()["a"], rback.to_pandas()["a"]
        assert out.iloc[0] == want.iloc[0] == 1
        assert out.iloc[1] == want.iloc[1] == 2
        assert pd.isna(out.iloc[2]) and pd.isna(want.iloc[2])
        assert back.columns[0].data.device.type == "cpu"


def test_stacked_map_in_pandas_single_worker():
    """Two chained mapInPandas with concurrentPythonWorkers=1 do not
    deadlock on the worker slot (a per-thread reentrant hold)."""
    def double(frames):
        for f in frames:
            yield f.assign(a=f["a"] * 2)

    df = pd.DataFrame({"a": pd.array([1.0, 2.0, 3.0], "Float64")})
    outs = []
    for sem, mip, src, types_ in (
            (PythonWorkerSemaphore, CpuMapInPandas, N.CpuSource, T),
            (RWorkerSem, RMapInPandas, RN.CpuSource,
             importlib.import_module("spark_rapids_tpu.types"))):
        sem.initialize(1)
        try:
            schema = types_.Schema.of(("a", types_.FLOAT64, True))
            plan = mip(double, schema, mip(double, schema,
                                           src.from_pandas(df)))
            outs.append(plan.collect())
        finally:
            sem.shutdown()
    assert outs[0]["a"].tolist() == outs[1]["a"].tolist() == \
        [4.0, 8.0, 12.0]


# -- the API audit ------------------------------------------------------------
def test_api_validation_all_versions():
    """`auditAllVersions.sh` as a unit test: every supported version
    audits clean, the UDF and pandas rules included."""
    reports = audit_all_versions()
    assert [r.version for r in reports] == \
        [r.version for r in ref_audit_all_versions()]
    assert len(reports) == 5
    for r in reports:
        assert r.ok(), str(r)
        assert r.checked > len(SHIM_SURFACE)
    from spark_rapids_tpu_torch.plan.overrides import EXEC_RULES
    names = {c.__name__ for c in EXEC_RULES}
    assert {"CpuArrowEvalPython", "CpuMapInPandas",
            "CpuFlatMapGroupsInPandas", "CpuAggregateInPandas",
            "CpuWindowInPandas", "CpuFlatMapCoGroupsInPandas"} <= names


def test_the_audit_finds_a_missing_rule_and_shim_method():
    from spark_rapids_tpu_torch import api_validation as AV

    class Unruled(N.CpuNode):
        pass
    Unruled.__module__ = "spark_rapids_tpu_torch.plan.nodes"
    report = AV.AuditReport("test")
    try:
        AV.audit_exec_rules(report)
    finally:
        Unruled.__module__ = __name__
    assert any("Unruled" in p for p in report.problems)

    class Partial(SH.Spark301Shims):
        make_first_last = None
    report = AV.AuditReport("test")
    AV.audit_shim_surface(report, Partial())
    assert report.problems == ["shim Partial missing make_first_last()"]


# -- the shims ----------------------------------------------------------------
VERSIONS = [("3.0.0", "spark300"), ("3.0.1", "spark301"),
            ("3.0.2", "spark302"), ("3.1.0", "spark310"),
            ("3.0.0-databricks", "spark300db")]


def test_shuffle_manager_classes_resolve_per_version():
    for version, pkg in VERSIONS:
        shims = SH.get_spark_shims(version)
        path = shims.shuffle_manager_class()
        assert path == f"spark_rapids_tpu_torch.shims.{pkg}." \
            "RapidsShuffleManager"
        assert path.replace("_torch", "") == \
            RSH.get_spark_shims(version).shuffle_manager_class()
        cls = shims.shuffle_manager_type()
        assert issubclass(cls, TpuShuffleManager)
        assert cls.SPARK_VERSION == pkg


def test_the_exchange_lane_makes_the_versions_manager():
    """The shuffle lane's executors are the session's version's
    RapidsShuffleManager."""
    from spark_rapids_tpu_torch.shims import spark310
    TpuShuffleManager.close_all()
    df = pd.DataFrame({"k": np.arange(40, dtype=np.int64) % 5,
                       "v": np.arange(40, dtype=np.int64)})
    from spark_rapids_tpu_torch.exprs.aggregates import Sum
    conf = C.RapidsConf({"spark.rapids.shuffle.enabled": True,
                         "spark.rapids.shuffle.localExecutors": 2,
                         "spark.rapids.tpu.sparkVersion": "3.1.0"})
    ResourceEnv.init(conf, device="cpu")
    try:
        plan = N.CpuAggregate([col("k")], [Sum(col("v")).alias("s")],
                              N.CpuSource.from_pandas(df, 2))
        got = O.collect(O.accelerate(plan, conf, "cpu"), conf)
        assert sorted(got["s"].tolist()) == [140, 148, 156, 164, 172]
        managers = list(TpuShuffleManager._managers.values())
        assert managers and all(type(m) is spark310.RapidsShuffleManager
                                for m in managers)
    finally:
        TpuShuffleManager.close_all()
        ResourceEnv.shutdown()


def test_aqe_reader_name_databricks_fork():
    for version, name in (("3.0.0", "CustomShuffleReaderExec"),
                          ("3.0.0-databricks",
                           "DatabricksShuffleReaderExec")):
        assert SH.get_spark_shims(version).aqe_shuffle_reader_name() == \
            RSH.get_spark_shims(version).aqe_shuffle_reader_name() == name


def test_map_index_ranges_gate():
    sid = 991
    results = []
    for reg, status, shims in ((MapOutputRegistry, MapStatus, SH),
                               (RRegistry, RMapStatus, RSH)):
        reg.clear()
        for map_id, sizes in enumerate([[10, 0, 5], [0, 7, 3]]):
            reg.register(sid, map_id, status("e0", "local", sizes))
        s310 = shims.get_spark_shims("3.1.0")
        s300 = shims.get_spark_shims("3.0.0")
        part = s310.get_map_sizes(reg, sid, 1, 2, 0, 3)
        full = s300.get_map_sizes(reg, sid, 0, None, 0, 3)
        with pytest.raises(NotImplementedError):
            s300.get_map_sizes(reg, sid, 1, 2, 0, 3)
        reg.clear()
        results.append((part, full))
    assert results[0] == results[1]
    assert results[0][0] == [(1, 1, 7), (1, 2, 3)]
    assert (0, 0, 10) in results[0][1] and (1, 1, 7) in results[0][1]


def test_first_last_construction():
    sh = SH.get_spark_shims("3.0.0")
    f = sh.make_first_last(col("a"), last=False, ignore_nulls=True)
    last = sh.make_first_last(col("a"), last=True, ignore_nulls=False)
    assert isinstance(f, First) and f.ignore_nulls
    assert isinstance(last, Last) and not last.ignore_nulls
    rf = RSH.get_spark_shims("3.0.0").make_first_last(
        rcol("a"), last=False, ignore_nulls=True)
    assert type(rf).__name__ == "First" and rf.ignore_nulls


def _frame():
    return pd.DataFrame({
        "a": np.arange(20, dtype=np.int64),
        "b": [float(i) if i % 3 else np.nan for i in range(20)],
        "s": [None if i % 5 == 0 else f"v{i}" for i in range(20)],
    })


def test_transition_classes_per_version():
    src = _src(_frame())
    assert type(SH.get_spark_shims("3.0.1").columnar_to_row_transition(
        src)) is ColumnarToRowExec
    assert type(SH.get_spark_shims("3.1.0").columnar_to_row_transition(
        src)) is AcceleratedColumnarToRowExec


def test_accelerated_transition_parity():
    df = _frame()
    base = ColumnarToRowExec(_src(df, 2)).collect()
    fast = AcceleratedColumnarToRowExec(_src(df, 2)).collect()
    pd.testing.assert_frame_equal(base, fast)
    want = RAccel(RSource.from_pandas(df, num_partitions=2)).collect()
    pd.testing.assert_frame_equal(
        RC2R(RSource.from_pandas(df, num_partitions=2)).collect(), want)
    pd.testing.assert_frame_equal(fast, want, check_dtype=False)


def _find(plan, cls):
    found = []

    def walk(n):
        if isinstance(n, cls):
            found.append(n)
        for k in getattr(n, "children", []):
            walk(k)
        tk = getattr(n, "tpu_child", None)
        if tk is not None:
            walk(tk)
    walk(plan)
    return found


def test_accelerated_transition_in_plan_rewrite():
    """Under sparkVersion 3.1.0 a CPU node above a device island gets the
    accelerated transition."""
    df = _frame()
    c = C.RapidsConf({"spark.rapids.tpu.sparkVersion": "3.1.0",
                      "spark.rapids.sql.exec.CpuFilter": False})
    plan = O.accelerate(N.CpuFilter(col("a") > 4, N.CpuProject(
        [col("a"), col("b"), col("s")], N.CpuSource.from_pandas(df))),
        c, "cpu")
    assert _find(plan, AcceleratedColumnarToRowExec)
    got = O.collect(plan, c)
    rc = RC.RapidsConf({"spark.rapids.tpu.sparkVersion": "3.1.0",
                        "spark.rapids.sql.exec.CpuFilter": False})
    rplan = RO.accelerate(RN.CpuFilter(rcol("a") > 4, RN.CpuProject(
        [rcol("a"), rcol("b"), rcol("s")], RN.CpuSource.from_pandas(df))),
        rc)
    assert _find(rplan, RAccel)
    want = RO.collect(rplan, rc)
    assert list(got.columns) == list(want.columns)
    for name in want.columns:
        e, g = want[name], got[name]
        np.testing.assert_array_equal(e.isna().to_numpy(),
                                      g.isna().to_numpy())
        assert e[~e.isna()].tolist() == g[~g.isna()].tolist(), name


def test_build_side_and_nested_loop_constructor():
    left = _src(pd.DataFrame({"a": [1]}))
    right = _src(pd.DataFrame({"b": [2]}))
    for cls in SH.ALL_SHIMS:
        s = cls()
        assert s.build_side_of(JoinType.LEFT_SEMI, "left") == "right"
        assert s.build_side_of(JoinType.INNER, "left") == "left"
        j = s.make_nested_loop_join(JoinType.CROSS, left, right, None,
                                    target_size_bytes=1024)
        assert isinstance(j, NestedLoopJoinExec)
        assert j.target_size_bytes == 1024
        bx = s.make_broadcast_exchange(right)
        assert type(bx).__name__ == "BroadcastExchangeExec"


def test_databricks_prep_rule_injection_drift():
    """The built rule carries the Databricks fork's name on the db shim
    only, and still delegates to the rule."""
    for shim, rshim, expect_db in (
            (SH.Spark301Shims(), RSH.Spark301Shims(), False),
            (SH.Spark300dbShims(), RSH.Spark300dbShims(), True)):
        for s, conf in ((shim, C.RapidsConf()), (rshim, RC.RapidsConf())):
            rule = s.make_query_stage_prep_rule(
                conf, lambda conf: (lambda plan: plan))
            assert (getattr(rule, "__name__", "") ==
                    "DatabricksQueryStagePrepRule") == expect_db
            assert rule("PLAN") == "PLAN"


def test_aqe_respects_pinned_partition_count():
    """A user's repartition(N) planned under 3.1 is not coalesced by AQE;
    under 3.0 it may be.  Each version's rows equal the reference's."""
    df = pd.DataFrame({"a": np.arange(64, dtype=np.int64)})
    for ver, may_coalesce in (("3.0.1", True), ("3.1.0", False)):
        settings = {"spark.rapids.tpu.sparkVersion": ver,
                    "spark.sql.adaptive.enabled": True,
                    "spark.sql.adaptive.coalescePartitions.enabled": True}
        conf = C.RapidsConf(settings)
        plan = N.CpuShuffleExchange(
            N.PartitioningSpec("hash", 8, (col("a"),)),
            N.CpuSource.from_pandas(df, num_partitions=2))
        out = O.collect(O.accelerate(plan, conf, "cpu"), conf)
        rconf = RC.RapidsConf(settings)
        want = RO.collect(RO.accelerate(RN.CpuShuffleExchange(
            RN.PartitioningSpec("hash", 8, (rcol("a"),)),
            RN.CpuSource.from_pandas(df, num_partitions=2)), rconf), rconf)
        assert sorted(out["a"]) == sorted(want["a"]) == list(range(64))
        names = [type(n).__name__ for n in _find(
            O.ExecutionPlanCapture.last_plan, object)]
        if not may_coalesce:
            assert "CustomShuffleReaderExec" not in names, \
                f"{ver} must pin the partition count"
