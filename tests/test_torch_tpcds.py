"""The ten TPC-DS queries with a window (q36, q44, q47, q49, q51, q53,
q57, q67, q70, q89) through spark_rapids_tpu_torch's planner on the CPU
(`tpcds_bench.run_query(q, tables, device="cpu")`), against
spark_rapids_tpu's CPU engine and the port's own CPU engine, over the
reference fixture's tables (tests/test_workloads.py: scale 20,000, seed
3, two partitions).  q53 also goes against the reference's accelerated
path.  The other eight of the slice are in test_torch_tpcds_rollup.py,
and the other 85 queries in test_torch_tpcds_rest_*.py, files of their
own so that xdist can run them on other workers.

Keys, counts, strings, ranks and the result order exact; floats within
compare_frames' rtol 1e-5 (the generator quantizes money to quarters,
so most sums are exact in float64 whatever the order)."""
import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.models import tpcds_data as RD
from spark_rapids_tpu.models import tpcds_queries as RQ
from spark_rapids_tpu.models.tpch_bench import BENCH_CONF as RBENCH
from spark_rapids_tpu.plan.overrides import accelerate as raccelerate
from spark_rapids_tpu.plan.overrides import collect as rcollect
from spark_rapids_tpu_torch.exprs.base import AttributeReference
from spark_rapids_tpu_torch.models import tpcds_bench as TB
from spark_rapids_tpu_torch.models import tpcds_data as TD
from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES
from spark_rapids_tpu_torch.plan import nodes as N

WINDOW_QUERIES = ["q36", "q44", "q47", "q49", "q51", "q53", "q57", "q67",
                  "q70", "q89"]
#: the queries also held against the reference's accelerated path: a
#: window, a rollup, a union and (q96) a count over three joins
AGAINST_ACCELERATED = {"q53", "q86", "q5", "q96"}
#: the reference's own fixture lets q91 come out empty
#: (tests/test_workloads.py ALLOW_EMPTY): its five predicate chains can
#: leave no row at this scale
ALLOW_EMPTY = {"q91"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch's CPU ops while the module runs: the
    tables are small, and with xdist's workers side by side each
    worker's full pool of spinning OpenMP threads slowed these tests
    about tenfold on an 8-core box."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_tables():
    return RD.gen_tables(np.random.default_rng(3), 20000)


@pytest.fixture(scope="module")
def tables():
    return TD.gen_tables(np.random.default_rng(3), 20000)


def cpu_run(plan):
    return plan.collect()


def _order_columns(plan):
    """The output columns the query's final sort orders by, or None
    where no sort orders the result (a global aggregate, a projection
    of scalars)."""
    out = set(plan.output_schema().names)
    node = plan
    while not isinstance(node, N.CpuSort):
        if not node.children:
            return None
        node = node.children[0]
    return [o.expr.name for o in node.order
            if isinstance(o.expr, AttributeReference) and o.expr.name in out]


def _assert_order(want: pd.DataFrame, got: pd.DataFrame, cols, label):
    """The result rows come in the same order of their sort keys."""
    for c in cols:
        w, g = want[c], got[c]
        assert w.isna().tolist() == g.isna().tolist(), f"{label} {c}"
        wv, gv = w[w.notna()].tolist(), g[g.notna()].tolist()
        if wv and isinstance(wv[0], float):
            np.testing.assert_allclose(gv, wv, rtol=1e-5, err_msg=label)
        else:
            assert [str(v) for v in gv] == [str(v) for v in wv], \
                f"{label} order of {c}"


def check_query(name, tables, ref_tables):
    want = RQ.QUERIES[name](RD.sources(ref_tables, 2), cpu_run).collect()
    assert len(want) > 0 or name in ALLOW_EMPTY
    cpu_plan = QUERIES[name](TD.sources(tables, 2), cpu_run)
    cpu = cpu_plan.collect()
    got = TB.run_query(name, tables, device="cpu")
    compare_frames(want, cpu, f"{name} CPU engines")
    compare_frames(want, got, f"{name} vs the reference's CPU engine")
    compare_frames(cpu, got, f"{name} vs the port's CPU engine")
    cols = _order_columns(cpu_plan)
    assert cols != [], name
    if cols:
        _assert_order(want, got, cols, name)
        _assert_order(cpu, got, cols, name)
    if name in AGAINST_ACCELERATED:
        conf = RC.RapidsConf(dict(RBENCH))

        def run(plan):
            return rcollect(raccelerate(plan, conf), conf)
        acc = run(RQ.QUERIES[name](RD.sources(ref_tables, 2), run))
        compare_frames(acc, got, f"{name} vs the reference accelerated")
        if cols:
            _assert_order(acc, got, cols, name)


@pytest.mark.parametrize("name", WINDOW_QUERIES)
def test_window_query_matches_reference(tables, ref_tables, name):
    check_query(name, tables, ref_tables)


def test_gen_tables_equal_the_reference(tables, ref_tables):
    assert list(tables) == list(ref_tables)
    for name, want in ref_tables.items():
        pd.testing.assert_frame_equal(tables[name], want, obj=name)
    assert [f.name for f in TD.SCHEMAS["store_sales"].fields] == \
        [f.name for f in RD.SCHEMAS["store_sales"].fields]


def _holds_window_or_expand(plan) -> bool:
    if type(plan).__name__ in ("CpuWindow", "CpuExpand"):
        return True
    return any(_holds_window_or_expand(c) for c in plan.children)


def test_queries_are_the_reference_plans_with_a_window_or_expand():
    """The port registers the reference's 103 queries; the 18 of this
    file and test_torch_tpcds_rollup.py are the ones whose plans hold a
    window or an expand."""
    from test_torch_tpcds_rollup import ROLLUP_QUERIES
    assert sorted(QUERIES) == sorted(RQ.QUERIES)
    assert len(QUERIES) == 103
    small = RD.gen_tables(np.random.default_rng(3), 2000)
    slice_ = {name for name, fn in RQ.QUERIES.items()
              if _holds_window_or_expand(fn(RD.sources(small, 2), cpu_run))}
    assert set(WINDOW_QUERIES) | set(ROLLUP_QUERIES) == slice_
