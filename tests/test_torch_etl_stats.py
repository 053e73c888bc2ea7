"""X4 of chip_smoke.py's phase 10 (models/etl_bench.py: var_samp,
stddev_samp, first/last, sums of narrow casts, sqrt, log10 and bitwise
ands, an unsigned shift's max and a rounded average by (l_returnflag,
l_linestatus); stddev_samp by l_suppkey), X3's country codes, and X4's
two ANSI casts, through spark_rapids_tpu_torch's planner against
spark_rapids_tpu's (a file of its own beside
tests/test_torch_expr_sweep.py, whose fixtures and helpers it shares, so
that xdist can put the reference's compiles on another worker).

Tolerances: as in tests/test_torch_expr_sweep.py: keys, counts and
integer sums exact; variance, stddev and float sums within rtol 1e-12 of
the reference, the CPU engine's pandas var/std within 1e-9.
"""
import pytest
from parity import compare_frames
from test_torch_expr_sweep import (PARTITIONS, PORT, REF, _walk, check_plan,
                                   etl_tables)

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.plan import accelerate as r_accelerate
from spark_rapids_tpu.plan import collect as r_collect
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.models import etl_bench as EB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

#: the shared fixture, named so that pytest finds it in this module
FIXTURES = (etl_tables,)


@pytest.mark.parametrize("name", ["x3_country", "x4", "x4_supplier"])
def test_etl_plans_match_the_reference(name, etl_tables):
    check_plan(name, etl_tables)


@pytest.mark.parametrize("column,to,raises", [
    ("l_extendedprice", "INT16", True), ("l_quantity", "INT8", False)])
def test_ansi_casts_at_collect(column, to, raises, etl_tables):
    """An ANSI cast that overflows raises ArithmeticError at collect with
    the reference's message; one in range sums as the plain cast does."""
    tables, arrays = etl_tables
    settings = {**EB.ETL_CONF, "spark.rapids.sql.test.enabled": True}
    acc = accelerate(EB.x4_ansi_plan(PORT, TD.sources(tables, PARTITIONS),
                                     column, getattr(T, to)),
                     C.RapidsConf(settings), device="cpu")
    assert isinstance(acc, TpuExec)
    # the ANSI project is never fused into the aggregate
    assert any(type(n).__name__ == "ProjectExec" for n in _walk(acc))
    ref = r_accelerate(EB.x4_ansi_plan(REF, RD.sources(tables, PARTITIONS),
                                       column, getattr(RT, to)),
                       RC.RapidsConf(settings))
    if raises:
        msg = (r"ANSI cast float64 -> int16 overflow "
               r"\(spark.sql.ansi.enabled semantics\)")
        with pytest.raises(ArithmeticError, match=msg):
            collect(acc)
        with pytest.raises(ArithmeticError, match=msg):
            r_collect(ref)
    else:
        got = collect(acc)
        assert int(got["total"][0]) == int(arrays["l_quantity"].sum())
        compare_frames(r_collect(ref), got, "ansi", rtol=0, atol=0)
