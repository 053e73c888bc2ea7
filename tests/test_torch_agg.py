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
