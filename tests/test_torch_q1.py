"""TPC-H Q1 through spark_rapids_tpu_torch's exec tree against
spark_rapids_tpu's, on identical bytes.

The reference batches are made from a numpy seed; the port's batches are
built from `np.asarray` of the reference's own columns (data, validity,
narrow shadow) through columnar.interop, so both engines read the same
values.  Keys and counts must match exactly, sums rtol 1e-6.
"""
import numpy as np
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec.aggregate import HashAggregateExec as RAgg
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exprs.aggregates import CountStar as RCountStar
from spark_rapids_tpu.exprs.aggregates import Sum as RSum
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.models import tpch as rtpch
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.interop import batch_from_arrays
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exprs.aggregates import CountStar, Sum
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.models import tpch


def to_port(ref_batch):
    """The port's twin of a reference batch, on the CPU."""
    cols = ref_batch.columns
    return batch_from_arrays(
        [(f.name, f.dtype.id.value) for f in ref_batch.schema.fields],
        [np.asarray(c.data) for c in cols],
        [np.asarray(c.validity) for c in cols], ref_batch.num_rows,
        narrow=[None if c.narrow is None else np.asarray(c.narrow)
                for c in cols], device="cpu")


def assert_frames_match(got, want, keys, rtol):
    got = got.sort_values(keys).reset_index(drop=True)
    want = want.sort_values(keys).reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for name in want.columns:
        g, w = got[name].to_numpy(), want[name].to_numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def lineitem_batches():
    rng = np.random.default_rng(11)
    ref = [rtpch.gen_lineitem(rng, n) for n in (3000, 2500, 4000)]
    return ref, [to_port(b) for b in ref]


@pytest.mark.parametrize("variable_float_agg", [False, True])
def test_q1_plan_matches_reference(lineitem_batches, variable_float_agg):
    """Off: every lane is the exact sort lane.  On: the dictionary lane
    (grouped_sum) per batch and the banded merge (window_group_sums)."""
    ref_batches, port_batches = lineitem_batches
    settings = {"spark.rapids.sql.variableFloatAgg.enabled":
                variable_float_agg}
    with RC.session(RC.RapidsConf(settings)):
        want = rtpch.q1_plan(RSource([ref_batches])).collect().to_pandas()
    with C.session(C.RapidsConf(settings)):
        got = tpch.q1_plan(LocalBatchSource([port_batches], device="cpu")
                           ).collect().to_pandas()
    assert len(want) == 6
    assert_frames_match(got, want, ["l_returnflag", "l_linestatus"],
                        rtol=1e-6)
    # and the pandas golden, which projects and sums in float32
    import pandas as pd
    frame = pd.concat([b.to_pandas() for b in port_batches],
                      ignore_index=True)
    golden = tpch.q1_reference_pandas(frame)
    assert_frames_match(got, golden.astype(got.dtypes.to_dict()),
                        ["l_returnflag", "l_linestatus"], rtol=1e-5)


@pytest.mark.parametrize("dict_groupby", [True, False])
def test_int64_sum_past_2_23_deopts_like_reference(dict_groupby):
    """|v| sums past 2^23 fire the f32 exactness certificates (the
    dictionary lane's, and the banded lane's in the update and the
    merge); collect() must disable the lanes at fault and re-run, and
    return the exact int64 sums, as the reference does."""
    rng = np.random.default_rng(12)
    ref_batches = []
    for n in (3000, 2000):
        ref_batches.append(RBatch.from_numpy(
            {"k": rng.integers(0, 3, n).astype(np.int32),
             "v": rng.integers(-10 ** 5, 10 ** 6, n).astype(np.int64)},
            RT.Schema.of(("k", RT.INT32), ("v", RT.INT64))))
    settings = {"spark.rapids.tpu.dictGroupby.enabled": dict_groupby}
    with RC.session(RC.RapidsConf(settings)):
        want = RAgg([rcol("k")], [RSum(rcol("v")).alias("s"),
                                  RCountStar().alias("c")],
                    RSource([ref_batches])).collect().to_pandas()
    port_src = LocalBatchSource([[to_port(b) for b in ref_batches]],
                                device="cpu")
    agg = HashAggregateExec([col("k")], [Sum(col("v")).alias("s"),
                                         CountStar().alias("c")], port_src)
    with C.session(C.RapidsConf(settings)):
        got = agg.collect().to_pandas()
    assert agg._banded_disabled
    assert (agg._dict_range_misses > 3) == dict_groupby
    assert int(want["s"].abs().max()) > 1 << 24
    assert_frames_match(got, want, ["k"], rtol=0)


def test_port_lineitem_draws_match_reference():
    """gen_lineitem gives the same draws from the same rng state."""
    ref = rtpch.gen_lineitem(np.random.default_rng(13), 777)
    port = tpch.gen_lineitem(np.random.default_rng(13), 777, device="cpu")
    for name in tpch.LINEITEM_SCHEMA.names:
        np.testing.assert_array_equal(port.column(name).data.numpy(),
                                      np.asarray(ref.column(name).data))


@pytest.mark.parametrize("q1_fused_conf", [True, False])
def test_stacked_q1_step_matches_reference(q1_fused_conf):
    """The stacked step against the reference's, 4 batches of 1024 rows:
    with spark.rapids.tpu.pallas.q1Fused.enabled the q1_fused wrapper
    (plain twin on the CPU) against the Pallas kernel, without it the
    per-batch torch step against the reference's vmapped XLA step."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(14)
    arrays = [tpch.gen_lineitem_arrays(rng, 1024) for _ in range(4)]
    cols = [np.concatenate([a[n] for a in arrays])
            for n in tpch.LINEITEM_SCHEMA.names]
    nums = np.array([1024, 900, 1, 512], np.int32)
    settings = {"spark.rapids.tpu.pallas.q1Fused.enabled": q1_fused_conf}
    with RC.session(RC.RapidsConf(settings)):
        want = np.asarray(rtpch.build_q1_fused_kernel(4096, 1024)(
            *[jnp.asarray(c) for c in cols], jnp.asarray(nums)))
    with C.session(C.RapidsConf(settings)):
        got = tpch.build_q1_fused_kernel(4096, 1024, device="cpu")(
            *[torch.from_numpy(c) for c in cols], torch.from_numpy(nums))
    np.testing.assert_array_equal(got[:, 5].numpy(), want[:, 5])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("q1_conf", [False, True])
def test_single_batch_q1_step_matches_reference(q1_conf):
    """build_q1_kernel: plain torch ops, or with
    spark.rapids.tpu.pallas.q1.enabled the q1_fused wrapper, against the
    reference's XLA step on 555 rows (counts exact, sums rtol 1e-5)."""
    import jax.numpy as jnp
    import torch
    cols = tpch.gen_lineitem_arrays(np.random.default_rng(15), 1024)
    args = [cols[n] for n in tpch.LINEITEM_SCHEMA.names]
    want = rtpch.build_q1_kernel(1024)(*[jnp.asarray(a) for a in args],
                                       jnp.int32(555))
    settings = {"spark.rapids.tpu.pallas.q1.enabled": q1_conf}
    with C.session(C.RapidsConf(settings)):
        got = tpch.build_q1_kernel(1024, device="cpu")(
            *[torch.from_numpy(a) for a in args], 555)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    for i in range(2, 7):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5)
