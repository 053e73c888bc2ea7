"""Mortgage's ETL and summary plans (models/mortgage.py) through
spark_rapids_tpu_torch's planner on the CPU
(`mortgage.run_plan(plan_fn, tables, device="cpu")`), against
spark_rapids_tpu's CPU engine and the port's own CPU engine, over the
reference fixture's tables (tests/test_workloads.py: 300 loans x 12
months, seed 5, two partitions); the generator's frames and the plans'
names against the reference's."""
import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu.models import mortgage as RM
from spark_rapids_tpu_torch.models import mortgage as M


@pytest.fixture(scope="module")
def ref_tables():
    return RM.gen_tables(np.random.default_rng(5), loans=300, months=12)


@pytest.fixture(scope="module")
def tables():
    return M.gen_tables(np.random.default_rng(5), loans=300, months=12)


@pytest.mark.parametrize("plan", ["etl_plan", "summary_plan"])
def test_mortgage_plan_matches_reference(tables, ref_tables, plan):
    want = getattr(RM, plan)(RM.sources(ref_tables, 2)).collect()
    cpu = getattr(M, plan)(M.sources(tables, 2)).collect()
    got = M.run_plan(getattr(M, plan), tables, device="cpu")
    assert len(want) == (300 if plan == "etl_plan" else 18)
    compare_frames(want, cpu, f"{plan} CPU engines")
    compare_frames(want, got, f"{plan} vs the reference's CPU engine")
    compare_frames(cpu, got, f"{plan} vs the port's CPU engine")
    # both plans end in a sort: the keys come in the reference's order
    keys = ["loan_id"] if plan == "etl_plan" else ["orig_channel",
                                                    "seller_name"]
    assert got[keys].values.tolist() == want[keys].values.tolist()


def test_gen_tables_equal_the_reference(tables, ref_tables):
    assert list(tables) == list(ref_tables)
    for name, want in ref_tables.items():
        pd.testing.assert_frame_equal(tables[name], want, obj=name)
    for ours, theirs in ((M.PERF_SCHEMA, RM.PERF_SCHEMA),
                         (M.ACQ_SCHEMA, RM.ACQ_SCHEMA)):
        assert [(f.name, f.dtype.id.value) for f in ours.fields] == \
            [(f.name, f.dtype.id.value) for f in theirs.fields]


def test_the_plans_are_the_references():
    for name in ("etl_plan", "summary_plan", "gen_tables", "sources"):
        assert callable(getattr(M, name)) and callable(getattr(RM, name))
    assert M.CHANNELS == RM.CHANNELS and M.SELLERS == RM.SELLERS
