"""The dictionary lane's edges against spark_rapids_tpu on identical
bytes: null keys (the null slot), rows outside the first batch's probed
window (inline singleton partials), several keys (the composite slot),
and Average/Count over nullable integer and float inputs."""
import numpy as np
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec.aggregate import HashAggregateExec as RAgg
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exprs import aggregates as RA
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs.base import col
from test_torch_q1 import assert_frames_match, to_port


def _batch(rng, n, key_ranges, schema):
    data, valid = {}, {}
    for name, (lo, hi) in key_ranges.items():
        data[name] = rng.integers(lo, hi, n).astype(
            schema.field(name).dtype.storage_dtype)
        valid[name] = rng.random(n) > 0.1
    data["iv"] = rng.integers(-1000, 1000, n).astype(np.int64)
    data["fv"] = rng.uniform(-5, 5, n).astype(np.float32)
    valid["iv"] = rng.random(n) > 0.2
    valid["fv"] = rng.random(n) > 0.2
    return RBatch.from_numpy(data, schema, valid)


def _aggs(mod, colf):
    return [mod.Sum(colf("iv")).alias("s_i"),
            mod.Average(colf("iv")).alias("a_i"),
            mod.Sum(colf("fv")).alias("s_f"),
            mod.Average(colf("fv")).alias("a_f"),
            mod.Count(colf("fv")).alias("c_f"),
            mod.CountStar().alias("c")]


@pytest.mark.parametrize("case", ["one_key_overflow", "two_keys"])
def test_dictionary_lane_edges_match_reference(case):
    rng = np.random.default_rng(31)
    if case == "one_key_overflow":
        schema = RT.Schema.of(("k", RT.INT64), ("iv", RT.INT64),
                              ("fv", RT.FLOAT32))
        # the probe sizes the window on batch 1; batch 2 adds 300 rows
        # past it, which ride as singleton partial groups
        batches = [_batch(rng, 2000, {"k": (0, 40)}, schema),
                   _batch(rng, 1700, {"k": (0, 40)}, schema),
                   _batch(rng, 300, {"k": (500, 900)}, schema)]
        keys = ["k"]
    else:
        schema = RT.Schema.of(("k1", RT.INT32), ("k2", RT.INT32),
                              ("iv", RT.INT64), ("fv", RT.FLOAT32))
        batches = [_batch(rng, 2500, {"k1": (-3, 4), "k2": (10, 15)},
                          schema),
                   _batch(rng, 1500, {"k1": (-3, 4), "k2": (10, 15)},
                          schema)]
        keys = ["k1", "k2"]
    settings = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    with RC.session(RC.RapidsConf(settings)):
        want = RAgg([rcol(k) for k in keys], _aggs(RA, rcol),
                    RSource([batches])).collect().to_pandas()
    agg = HashAggregateExec([col(k) for k in keys], _aggs(A, col),
                            LocalBatchSource([[to_port(b) for b in batches]],
                                             device="cpu"))
    with C.session(C.RapidsConf(settings)):
        got = agg.collect().to_pandas()
    assert agg._dict_gpad is not None and agg._dict_range_misses == 0
    assert want["k" if case == "one_key_overflow" else "k1"].isna().any()
    assert_frames_match(got, want, keys, rtol=1e-6)


# -- First, Last, VarianceSamp and StddevSamp ---------------------------------
def _moment_frame(seed: int = 41, n: int = 3000):
    """Groups of large-magnitude low-variance doubles (~1e8, where raw
    (sum, sum of squares) intermediates would cancel), nullable ints,
    a string column, groups of one value and a group of nulls alone."""
    import pandas as pd
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 40, n)
    g[:3] = [97, 98, 98]                  # a one-row group
    g[3:9] = 99                           # nulls alone
    x = 1e8 + rng.normal(size=n)
    xv = pd.arrays.FloatingArray(x, rng.random(n) < 0.1)
    xv[3:9] = pd.NA
    iv = pd.array(rng.integers(-1000, 1000, n), "Int64")
    iv[rng.random(n) < 0.15] = pd.NA
    iv[3:9] = pd.NA
    s = np.array(["a", "bb", "", "café", None], dtype=object)[
        rng.integers(0, 5, n)]
    return pd.DataFrame({"g": pd.array(g, "Int64"), "x": xv, "i": iv,
                         "s": s})


def _moment_aggs(mod, colf):
    return [mod.VarianceSamp(colf("x")).alias("vx"),
            mod.StddevSamp(colf("x")).alias("sx"),
            mod.VarianceSamp(colf("i")).alias("vi"),
            mod.StddevSamp(colf("i")).alias("si"),
            mod.First(colf("i")).alias("fi"),
            mod.Last(colf("i")).alias("li"),
            mod.First(colf("i"), ignore_nulls=True).alias("fin"),
            mod.Last(colf("x"), ignore_nulls=True).alias("lxn"),
            mod.First(colf("s")).alias("fs"),
            mod.Last(colf("s"), ignore_nulls=True).alias("lsn")]


def _assert_moments(got, want, label):
    """Keys, counts, First/Last exact (strings too); variance and
    stddev within rtol 1e-12; the same null masks."""
    got = got.sort_values("g", ignore_index=True)
    want = want.sort_values("g", ignore_index=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        g, w = got[name], want[name]
        np.testing.assert_array_equal(g.isna().to_numpy(),
                                      w.isna().to_numpy(),
                                      err_msg=f"{label} nulls {name}")
        ok = ~w.isna().to_numpy()
        if name in ("vx", "sx", "vi", "si", "lxn"):
            np.testing.assert_allclose(
                g[ok].to_numpy(np.float64), w[ok].to_numpy(np.float64),
                rtol=1e-12 if name != "lxn" else 0, err_msg=f"{label} {name}")
        else:
            assert list(g[ok]) == list(w[ok]), f"{label} {name}"


@pytest.mark.parametrize("partitions", [1, 4])
def test_moments_and_first_last_match_reference(partitions):
    """Through both planners (one partition: a complete aggregate; four:
    partial -> exchange -> final, the Chan merge) and the port's CPU
    aggregate, against the reference (variance and stddev rtol 1e-12,
    the rest exact), and against pandas' var/std (ddof=1)."""
    import pandas as pd
    from spark_rapids_tpu.plan import accelerate as r_accelerate
    from spark_rapids_tpu.plan import collect as r_collect
    from spark_rapids_tpu.plan import nodes as RN
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    df = _moment_frame()
    settings = {"spark.rapids.sql.variableFloatAgg.enabled": True,
                "spark.rapids.sql.test.enabled": True}
    ref_plan = RN.CpuAggregate([rcol("g")], _moment_aggs(RA, rcol),
                               RN.CpuSource.from_pandas(df, partitions))
    want = r_collect(r_accelerate(ref_plan, RC.RapidsConf(settings)))
    plan = N.CpuAggregate([col("g")], _moment_aggs(A, col),
                          N.CpuSource.from_pandas(df, partitions))
    got = collect(accelerate(plan, C.RapidsConf(settings), device="cpu"))
    _assert_moments(got, want, "device")
    # pandas' own var/std round differently: on values ~1e8 with
    # variance ~1 (a condition number near 1e16) they agree to ~1e-8,
    # so the CPU engine is held at the reference test's rtol 1e-6
    cpu = plan.collect()
    for name in ("vx", "sx", "vi", "si"):
        c = cpu.sort_values("g", ignore_index=True)[name]
        w = want.sort_values("g", ignore_index=True)[name]
        np.testing.assert_array_equal(c.isna().to_numpy(),
                                      w.isna().to_numpy(), err_msg=name)
        np.testing.assert_allclose(c.dropna().to_numpy(np.float64),
                                   w.dropna().to_numpy(np.float64),
                                   rtol=1e-6, err_msg=f"CPU engine {name}")
    if partitions == 1:  # one partition keeps the input's row order
        first_last = ["g", "fi", "li", "fin", "lxn", "fs", "lsn"]
        _assert_moments(cpu[first_last], want[first_last], "CPU engine")
    exp = df.groupby("g")["x"].agg(["var", "std"]).sort_index()
    gw = want.sort_values("g", ignore_index=True)
    np.testing.assert_allclose(
        gw["vx"].to_numpy(np.float64, na_value=np.nan),
        exp["var"].to_numpy(np.float64, na_value=np.nan), rtol=1e-6)
    # a group of one value and a group of nulls alone give null
    keys = gw["g"].to_numpy(np.int64)
    assert gw["vx"].isna().to_numpy()[keys == 97].all()
    assert gw["sx"].isna().to_numpy()[keys == 99].all()


def test_variance_welford_large_magnitude():
    """The twin of tests/test_sort_aggregate.py's Welford case through the
    port's HashAggregateExec: values ~1e8 with variance ~1, complete and
    partial/final, against pandas (rtol 1e-6, the reference test's) and
    the reference's exec (rtol 1e-12); a group of fewer than two values
    is null."""
    import pandas as pd
    rng = np.random.default_rng(7)
    df = pd.DataFrame({"g": rng.integers(0, 5, 400).astype(np.int64),
                       "x": 1e8 + rng.normal(size=400)})
    exp = df.groupby("g")["x"].agg(v="var", s="std").sort_index()
    ref_batches = [RBatch.from_numpy({"g": df["g"].to_numpy()[sl],
                                      "x": df["x"].to_numpy()[sl]})
                   for sl in (slice(0, 130), slice(130, 270),
                              slice(270, 400))]

    def aggs(mod, colf):
        return [mod.VarianceSamp(colf("x")).alias("v"),
                mod.StddevSamp(colf("x")).alias("s")]
    want = RAgg([rcol("g")], aggs(RA, rcol),
                RSource([ref_batches])).collect().to_pandas()
    from spark_rapids_tpu_torch.exec.aggregate import AggMode
    port = [to_port(b) for b in ref_batches]
    single = HashAggregateExec([col("g")], aggs(A, col),
                               LocalBatchSource([port], device="cpu"))
    partial = HashAggregateExec(
        [col("g")], aggs(A, col),
        LocalBatchSource([[b] for b in port], device="cpu"),
        mode=AggMode.PARTIAL)
    parts = [b for it in partial.execute_partitions() for b in it]
    final = HashAggregateExec(
        [col("g")], aggs(A, col),
        LocalBatchSource([parts], partial.output_schema(), device="cpu"),
        mode=AggMode.FINAL)
    for exec_ in (single, final):
        out = exec_.collect().to_pandas().sort_values("g", ignore_index=True)
        np.testing.assert_allclose(out["v"], exp["v"], rtol=1e-6)
        np.testing.assert_allclose(out["s"], exp["s"], rtol=1e-6)
        w = want.sort_values("g", ignore_index=True)
        np.testing.assert_allclose(out["v"], w["v"], rtol=1e-12)
        np.testing.assert_allclose(out["s"], w["s"], rtol=1e-12)
    tiny = RBatch.from_numpy({"g": np.array([0, 1, 1], np.int64),
                              "x": np.array([5.0, 2.0, 4.0])})
    out = HashAggregateExec(
        [col("g")], [A.VarianceSamp(col("x")).alias("v")],
        LocalBatchSource([[to_port(tiny)]], device="cpu")
    ).collect().to_pandas().sort_values("g", ignore_index=True)
    assert pd.isna(out["v"][0]) and abs(out["v"][1] - 2.0) < 1e-12


def test_first_last():
    """The twin of tests/test_sort_aggregate.py::test_first_last."""
    b = RBatch.from_numpy(
        {"k": np.array([1, 1, 1, 2], np.int64),
         "v": np.array([0, 10, 20, 30], np.int64)},
        validity={"v": np.array([False, True, True, True])})
    out = HashAggregateExec(
        [col("k")], [A.First(col("v"), ignore_nulls=True).alias("f"),
                     A.Last(col("v")).alias("l")],
        LocalBatchSource([[to_port(b)]], device="cpu")).collect()
    k, f, l = (out.column(n).to_numpy(2)[0].tolist() for n in "kfl")
    assert dict(zip(k, zip(f, l))) == {1: (10, 20), 2: (30, 30)}


def test_first_with_leading_null():
    """The twin of tests/test_plan_overrides.py's case: the CPU engine's
    First without ignore_nulls takes a leading null."""
    import pandas as pd
    from spark_rapids_tpu_torch.plan.nodes import CpuAggregate, CpuSource
    df = pd.DataFrame({"g": pd.array([1, 1, 2], dtype="Int64"),
                       "x": pd.array([None, 5, 7], dtype="Int64")})
    out = CpuAggregate([col("g")], [A.First(col("x")).alias("f")],
                       CpuSource.from_pandas(df)).collect()
    out = out.sort_values("g", ignore_index=True)
    assert pd.isna(out["f"][0]) and out["f"][1] == 7


def test_moments_stay_off_the_kernel_lanes():
    """As in the reference, only Sum/Count/Average take the dictionary and
    banded lanes: an aggregate with VarianceSamp or First runs the sort
    lane."""
    b = to_port(RBatch.from_numpy({"k": np.array([1, 2, 1], np.int64),
                                   "x": np.array([1.0, 2.0, 4.0])}))
    for f in (A.VarianceSamp(col("x")), A.First(col("x"))):
        agg = HashAggregateExec([col("k")], [A.Sum(col("x")).alias("s"),
                                             f.alias("f")],
                                LocalBatchSource([[b]], device="cpu"))
        assert agg._dict_qual is None and not agg._banded_qual
