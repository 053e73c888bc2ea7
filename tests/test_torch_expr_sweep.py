"""The ETL plans of chip_smoke.py's phase 10 (models/etl_bench.py, X1-X4)
through spark_rapids_tpu_torch's planner, device engine on the CPU and
CPU engine, against spark_rapids_tpu's planner on the same tables
(`tpch_bench.sf10_tables(5, 0.025)`: 37,500 orders, 3,750 customers,
~150,000 lines), with `spark.rapids.sql.test.enabled` so that no plan has
a CPU node; and the planner rules the slice adds: the gated casts, ANSI
casts at collect and across fusion (the twin of tests/test_fusion.py's
ANSI case), and the tags of the inline complex types.

Tolerances: keys, counts, integers, dates, timestamps, strings and null
masks exact; floats (variance, stddev, months_between, sums of doubles)
within rtol 1e-12 of the reference (its jitted kernels may fuse an add),
the CPU engine's pandas var/std within 1e-9 (another summation).
"""
import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.exprs import (aggregates as RAg, arithmetic as RAr,
                                    base as RE, bitwise as RBw, cast as RCa,
                                    complex as RCx, datetime_exprs as RDt,
                                    math_exprs as RMa, predicates as RPr,
                                    string_fns as RSt)
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.plan import accelerate as r_accelerate
from spark_rapids_tpu.plan import collect as r_collect
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.models import etl_bench as EB
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
from spark_rapids_tpu_torch.plan.transitions import (ColumnarToRowExec,
                                                     RowToColumnarExec)

PORT = EB.port_classes()
REF = EB.namespace(RT, RE, (RAg, RAr, RBw, RCa, RCx, RDt, RMa, RPr, RSt,
                            RN))
#: one partition: the reference compiles each plan's kernels once (the
#: partial/final split is held in tests/test_torch_agg.py)
PARTITIONS = 1


@pytest.fixture(scope="module")
def etl_tables():
    return TB.sf10_tables(5, 0.025)


def _walk(plan):
    """Every node, device and CPU, through the transitions."""
    yield plan
    kids = getattr(plan, "children", None) or []
    if isinstance(plan, ColumnarToRowExec):
        kids = [plan.tpu_child]
    elif isinstance(plan, RowToColumnarExec):
        kids = [plan.cpu_child]
    for c in kids:
        yield from _walk(c)


def _sorted(df, keys):
    return df.sort_values(keys, ignore_index=True)


def _compare(want, got, label, rtol):
    """Every column but the floats exact; the floats within `rtol`."""
    floats = [c for c in want.columns if want[c].dtype.kind == "f"
              or str(want[c].dtype).startswith("Float")]
    compare_frames(want.drop(columns=floats), got.drop(columns=floats),
                   label, rtol=0, atol=0)
    if floats:
        compare_frames(want[floats], got[floats], label, rtol=rtol, atol=0)


PLANS = {"x1": (EB.x1_plan, None), "x2": (EB.x2_plan, ["h"]),
         "x3": (EB.x3_plan, ["c_custkey"]),
         "x3_country": (EB.x3_country_plan, ["cc"]),
         "x4": (EB.x4_plan, ["l_returnflag", "l_linestatus"]),
         "x4_supplier": (EB.x4_supplier_plan, ["l_suppkey"])}


def check_plan(name, etl_tables):
    """PLANS[name] through both planners and the port's CPU engine."""
    tables, _ = etl_tables
    build, keys = PLANS[name]
    settings = {**EB.ETL_CONF, "spark.rapids.sql.test.enabled": True}
    want = r_collect(r_accelerate(build(REF, RD.sources(tables, PARTITIONS)),
                                  RC.RapidsConf(settings)))
    plan = build(PORT, TD.sources(tables, PARTITIONS))
    acc = accelerate(plan, C.RapidsConf(settings), device="cpu")
    assert isinstance(acc, TpuExec)  # test.enabled: no CPU node at all
    got = collect(acc)
    cpu = plan.collect()
    if keys:
        want, got, cpu = (_sorted(f, keys) for f in (want, got, cpu))
    _compare(want, got, f"{name} device", 1e-12)
    _compare(want, cpu, f"{name} CPU engine", 1e-9)
    if name == "x1":
        assert want.iloc[0].tolist()[1:] == [0, 0, 0, 0]
    if name == "x3":
        phone = tables["customer"]["c_phone"].astype(str)
        assert (got["cc"].to_numpy(np.int64) == tables["customer"][
            "c_nationkey"].to_numpy() + 10).all()
        assert (got["loc"] == 9).all()
        assert list(got["rep"]) == list(phone.str.replace("-", ""))


#: the plans this file runs; tests/test_torch_etl_dates.py and
#: tests/test_torch_etl_stats.py run the others (files of their own, so
#: that xdist can put the reference's compiles on other workers)
@pytest.mark.parametrize("name", ["x1", "x3"])
def test_etl_plans_match_the_reference(name, etl_tables):
    check_plan(name, etl_tables)


def test_gated_casts_are_cpu_islands_with_the_reference_s_reasons(
        etl_tables):
    """X1 with the cast gates off: its project stays on the CPU with the
    reference's reasons, test.enabled refuses it, and the CPU island
    gives the device's answer."""
    tables, _ = etl_tables
    base = {k: v for k, v in EB.ETL_CONF.items() if "cast" not in k}
    plan = EB.x1_plan(PORT, TD.sources(tables, PARTITIONS))
    acc = accelerate(plan, C.RapidsConf(base), device="cpu")
    islands = [n for n in _walk(acc) if type(n).__name__ == "CpuProject"]
    assert islands, [type(n).__name__ for n in _walk(acc)]
    from spark_rapids_tpu_torch.plan.meta import wrap_plan
    meta = wrap_plan(plan, C.RapidsConf(base), device="cpu")
    meta.tag_for_gpu()
    text = meta.explain(all_nodes=True)
    assert "float->string formatting differs from Java at extreme " \
           "exponents; enable with " \
           "spark.rapids.sql.castFloatToString.enabled" in text
    assert "string->float parse may differ by 1 ulp from Java; enable " \
           "with spark.rapids.sql.castStringToFloat.enabled" in text
    assert "string->timestamp supports canonical forms only; enable " \
           "with spark.rapids.sql.castStringToTimestamp.enabled" in text
    with pytest.raises(AssertionError, match="CpuProject"):
        accelerate(plan, C.RapidsConf(
            {**base, "spark.rapids.sql.test.enabled": True}), device="cpu")
    assert collect(acc).iloc[0].tolist()[1:] == [0, 0, 0, 0]


def test_unsupported_expression_deopts_only_its_stage():
    """The twin of tests/test_fusion.py's ANSI case: an ANSI project in a
    fusible chain stays per-operator, the filter and project above it
    still fuse, and the result is the unfused plan's."""
    from spark_rapids_tpu_torch.exec.sort import asc
    from spark_rapids_tpu_torch.exprs.base import col, lit
    from spark_rapids_tpu_torch.exprs.cast import Cast
    from spark_rapids_tpu_torch.plan.nodes import (CpuFilter, CpuProject,
                                                   CpuSort, CpuSource)
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"a": rng.integers(0, 100, 2000).astype(np.int64),
                       "b": rng.uniform(0, 10, 2000)})
    plan = CpuSort(
        [asc(col("z"))],
        CpuProject(
            [(col("ai") + col("ai")).alias("z"), col("b2")],
            CpuFilter(col("ai") >= lit(0), CpuProject(
                [Cast(col("a"), T.INT32, ansi=True).alias("ai"),
                 (col("b") * lit(2.0)).alias("b2")],
                CpuSource.from_pandas(df, num_partitions=2)))),
        global_sort=True)
    conf = C.RapidsConf(dict(TB.BENCH_CONF))
    p = accelerate(plan, conf, device="cpu")
    names = [type(n).__name__ for n in _walk(p)]
    assert "ProjectExec" in names and "FusedStageExec" in names, names
    off = C.RapidsConf({**TB.BENCH_CONF,
                        "spark.rapids.sql.fusion.enabled": False})
    pd.testing.assert_frame_equal(
        collect(p, conf).reset_index(drop=True),
        collect(accelerate(plan, off, device="cpu"), off
                ).reset_index(drop=True))


def test_complex_types_run_inline_only():
    """A bare CreateArray or CreateMap, a GetArrayItem over anything but
    split() or array(), and substring_index with a column count stay on
    the CPU, with the reference's reasons."""
    from spark_rapids_tpu_torch.exprs.base import Literal, col
    from spark_rapids_tpu_torch.exprs.complex import (CreateArray,
                                                      CreateMap,
                                                      GetArrayItem)
    from spark_rapids_tpu_torch.exprs.string_fns import SubstringIndex
    from spark_rapids_tpu_torch.plan.nodes import CpuProject, CpuSource
    df = pd.DataFrame({"a": pd.array([1, 2], "Int64"),
                       "s": ["x.y", "z"], "n": pd.array([1, 2], "Int32")})
    cases = [
        (CreateArray((col("a"), col("a"))),
         "CreateArray must be consumed by GetArrayItem or explode"),
        (CreateMap((Literal("k", T.STRING), col("a"))),
         "CreateMap must be consumed by GetMapValue"),
        (GetArrayItem(col("s"), Literal(0, T.INT32)),
         "GetArrayItem supports inline arrays (split()/array()) only"),
        (SubstringIndex(col("s"), Literal(".", T.STRING), col("n")),
         "substring_index delimiter and count must be literals")]
    for expr, reason in cases:
        acc = accelerate(CpuProject([expr.alias("r")],
                                    CpuSource.from_pandas(df)),
                         C.RapidsConf({}), device="cpu")
        assert type(acc).__name__ == "CpuProject"
        assert any(reason in r for r in acc._meta.reasons), \
            acc._meta.reasons
