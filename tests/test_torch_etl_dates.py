"""X2 of chip_smoke.py's phase 10 (models/etl_bench.py: timestamps from
the order dates, their fields, trunc, months_between, time_add, weekday
and text, grouped by the hour) through spark_rapids_tpu_torch's planner
against spark_rapids_tpu's, and X1's and X2's row projections over a
sample of orders against Python's strings and numpy (a file of its own
beside tests/test_torch_expr_sweep.py, whose fixtures and helpers it
shares, so that xdist can put the reference's compiles on another
worker).

Tolerances: as in tests/test_torch_expr_sweep.py: integers, dates,
timestamps, strings and null masks exact; months_between within rtol
1e-12 of the reference (its jitted kernel may fuse the last add).
"""
import numpy as np
from test_torch_expr_sweep import (PORT, REF, _compare, check_plan,
                                   etl_tables)

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.plan import accelerate as r_accelerate
from spark_rapids_tpu.plan import collect as r_collect
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.models import etl_bench as EB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

#: the shared fixture, named so that pytest finds it in this module
FIXTURES = (etl_tables,)


def test_x2_matches_the_reference(etl_tables):
    check_plan("x2", etl_tables)


def test_etl_sample_strings_match_python(etl_tables):
    """X1's and X2's row projections over a sample of orders: Java's
    strings of the keys, dates, prices and timestamps, and X2's fields
    held against numpy and the reference."""
    tables, arrays = etl_tables
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(len(tables["orders"]), 2048, replace=False))
    sample = {"orders": tables["orders"].iloc[idx].reset_index(drop=True)}
    settings = C.RapidsConf({**EB.ETL_CONF,
                             "spark.rapids.sql.test.enabled": True})
    got = collect(accelerate(EB.x1_strings_plan(
        PORT, TD.sources(sample, 1)["orders"]), settings, device="cpu"))
    from spark_rapids_tpu_torch.plan.cpu_eval import _java_float_str
    keys = arrays["o_orderkey"][idx]
    days = arrays["o_orderdate"][idx]
    iso = [str(np.datetime64(int(d), "D")) for d in days]
    assert list(got["k_str"]) == [str(int(k)) for k in keys]
    assert list(got["d_str"]) == iso
    assert list(got["t_str"]) == [f"{d} 00:00:00" for d in iso]
    prices = tables["orders"]["o_totalprice"].to_numpy()[idx]
    assert list(got["p_str"]) == [_java_float_str(p) for p in prices]
    rows = collect(accelerate(EB.x2_rows_plan(
        PORT, TD.sources(sample, 1)["orders"]), settings, device="cpu"))
    want = r_collect(r_accelerate(EB.x2_rows_plan(
        REF, RD.sources(sample, 1)["orders"]),
        RC.RapidsConf({**EB.ETL_CONF})))
    # the reference's jitted months_between may fuse its last add: 1e-12
    _compare(want, rows, "x2 rows", 1e-12)
    secs = days.astype(np.int64) * 86400 + keys * 7919 % 86400
    np.testing.assert_array_equal(rows["ts"].to_numpy(np.int64),
                                  secs * 1_000_000)
    np.testing.assert_array_equal(rows["h"].to_numpy(np.int64),
                                  secs % 86400 // 3600)
    np.testing.assert_array_equal(rows["td"].to_numpy(np.int64), days)
    assert rows["d_miss"].sum() == 0
    assert list(rows["t_str"]) == [
        str(np.datetime64(int(s), "s")).replace("T", " ") for s in secs]
