"""The 30 TPCx-BB queries (models/tpcxbb.py; q18 and q27 through the UDF
compiler) through spark_rapids_tpu_torch's planner on the CPU
(`tpcxbb.run_query(q, tables, device="cpu")`), against spark_rapids_tpu's
CPU engine and the port's own CPU engine, over the reference fixture's
tables (tests/test_workloads.py: scale 4,000, seed 4, two partitions),
with the checks of test_torch_tpcds.py; the generator's frames and the
registry against the reference's."""
import numpy as np
import pandas as pd
import pytest
from parity import compare_frames
from test_torch_tpcds import (_assert_order, _order_columns, cpu_run,
                              one_torch_thread)

from spark_rapids_tpu.models import tpcxbb as RX
from spark_rapids_tpu_torch.models import tpcxbb as X


#: the shared fixture, named so that pytest finds it in this module
FIXTURES = (one_torch_thread,)


@pytest.fixture(scope="module")
def ref_tables():
    return RX.gen_tables(np.random.default_rng(4), 4000)


@pytest.fixture(scope="module")
def tables():
    return X.gen_tables(np.random.default_rng(4), 4000)


@pytest.mark.parametrize("name", sorted(X.QUERIES))
def test_tpcxbb_query_matches_reference(tables, ref_tables, name):
    want = RX.QUERIES[name](RX.sources(ref_tables, 2), cpu_run).collect()
    assert len(want) > 0
    cpu_plan = X.QUERIES[name](X.sources(tables, 2), cpu_run)
    cpu = cpu_plan.collect()
    got = X.run_query(name, tables, device="cpu")
    compare_frames(want, cpu, f"{name} CPU engines")
    compare_frames(want, got, f"{name} vs the reference's CPU engine")
    compare_frames(cpu, got, f"{name} vs the port's CPU engine")
    cols = _order_columns(cpu_plan)
    assert cols != [], name
    if cols:
        _assert_order(want, got, cols, name)
        _assert_order(cpu, got, cols, name)


def test_gen_tables_equal_the_reference(tables, ref_tables):
    assert list(tables) == list(ref_tables)
    for name, want in ref_tables.items():
        pd.testing.assert_frame_equal(tables[name], want, obj=name)
    for ours, theirs in ((X.CLICKS_SCHEMA, RX.CLICKS_SCHEMA),
                         (X.REVIEWS_SCHEMA, RX.REVIEWS_SCHEMA)):
        assert [(f.name, f.dtype.id.value) for f in ours.fields] == \
            [(f.name, f.dtype.id.value) for f in theirs.fields]


def test_queries_are_the_reference_less_its_two_udf_queries():
    """The port has all of the reference's queries, the two whose text
    analysis is a Python UDF among them (the name is kept from when the
    port lacked those two)."""
    assert set(X.QUERIES) == set(RX.QUERIES)
    assert len(X.QUERIES) == 30


@pytest.mark.parametrize("name", ["q18", "q27"])
def test_udf_queries_compile_and_run_wholly_on_the_device(tables, name):
    """q18's and q27's UDFs compile, so under
    spark.rapids.sql.test.enabled no CPU node is left; with the compiler
    off the UDF's project is the only CPU node, and the results agree."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.models.tpch_bench import BENCH_CONF
    from spark_rapids_tpu_torch.plan.overrides import accelerate
    on = C.RapidsConf({**BENCH_CONF, "spark.rapids.sql.test.enabled": True})
    plan = accelerate(X.QUERIES[name](X.sources(tables, 2), cpu_run), on,
                      "cpu")
    assert isinstance(plan, TpuExec)
    got = X.run_query(name, tables, device="cpu", conf=on)
    off = C.RapidsConf({**BENCH_CONF,
                        "spark.rapids.sql.udfCompiler.enabled": False,
                        "spark.rapids.sql.test.enabled": True,
                        "spark.rapids.sql.test.allowedNonGpu": "CpuProject"})
    with pytest.raises(AssertionError):
        X.run_query(name, tables, device="cpu", conf=C.RapidsConf({
            **BENCH_CONF, "spark.rapids.sql.udfCompiler.enabled": False,
            "spark.rapids.sql.test.enabled": True}))
    compare_frames(X.run_query(name, tables, device="cpu", conf=off), got,
                   f"{name} compiled against the row-applied UDF")
