"""spark_rapids_tpu_torch's columnar export (ml/) against
spark_rapids_tpu's: twins of the five tests of
tests/test_ml_integration.py (the export gate, the exported batches and
their device, the export through a CPU island, collect_arrays, and a
training loop over the exported columns), with device="cpu".  Where the
reference exports jax arrays and trains with jax.grad, the port exports
torch tensors and trains a torch.nn.Linear with torch.optim.SGD.  The
exported values equal the JAX package's exactly.  ~4 s alone.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.ml import ColumnarRdd as RColumnarRdd
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.ml import ColumnarRdd
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

EXPORT = {"spark.rapids.sql.exportColumnarRdd": True}


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _df(n=64):
    rng = np.random.default_rng(7)
    x = rng.normal(size=n)
    return pd.DataFrame({
        "x": x,
        "noise": rng.normal(scale=0.01, size=n),
        "label": 3.0 * x + 1.0,
        "s": [f"r{i}" for i in range(n)],
    })


def test_export_requires_conf():
    with pytest.raises(RuntimeError, match="exportColumnarRdd"):
        ColumnarRdd.convert(N.CpuSource.from_pandas(_df()), C.RapidsConf(),
                            device="cpu")
    with pytest.raises(RuntimeError, match="exportColumnarRdd"):
        RColumnarRdd.convert(RN.CpuSource.from_pandas(_df()),
                             RC.RapidsConf())


def test_export_batches_are_device_resident_and_match_collect():
    df = _df()
    c = C.RapidsConf(EXPORT)
    plan = N.CpuProject([col("x"), (col("label") * 2).alias("y2")],
                        N.CpuFilter(col("x") > 0, N.CpuSource.from_pandas(df,
                                                                          3)))
    batches = [b for it in ColumnarRdd.convert(plan, c, device="cpu")
               for b in it]
    assert batches and all(isinstance(b, ColumnarBatch) for b in batches)
    # the columns are the engine's own tensors, on the plan's device
    assert all(isinstance(b.column("x").data, torch.Tensor)
               and b.column("x").data.device.type == "cpu" for b in batches)
    got = pd.concat([b.to_pandas() for b in batches], ignore_index=True)
    expected = collect(accelerate(plan, c, "cpu"), c)
    rplan = RN.CpuProject([rcol("x"), (rcol("label") * 2).alias("y2")],
                          RN.CpuFilter(rcol("x") > 0,
                                       RN.CpuSource.from_pandas(df, 3)))
    want = pd.concat([b.to_pandas() for it in RColumnarRdd.convert(
        rplan, RC.RapidsConf(EXPORT)) for b in it], ignore_index=True)
    np.testing.assert_array_equal(got["y2"].to_numpy(float),
                                  expected["y2"].to_numpy(float))
    np.testing.assert_array_equal(got["y2"].to_numpy(float),
                                  want["y2"].to_numpy(float))


def test_export_through_cpu_island():
    """A plan with a CPU node still exports batches (the reference's
    InternalColumnarRddConverter row path)."""
    df = _df()
    settings = {**EXPORT, "spark.rapids.sql.exec.CpuFilter": False}
    parts = ColumnarRdd.convert(
        N.CpuFilter(col("x") > 0, N.CpuSource.from_pandas(df, 2)),
        C.RapidsConf(settings), device="cpu")
    batches = [b for it in parts for b in it]
    rparts = RColumnarRdd.convert(
        RN.CpuFilter(rcol("x") > 0, RN.CpuSource.from_pandas(df, 2)),
        RC.RapidsConf(settings))
    assert sum(b.num_rows for b in batches) == \
        sum(b.num_rows for it in rparts for b in it) == \
        int((df["x"] > 0).sum())
    assert all(b.columns[0].data.device.type == "cpu" for b in batches)


def test_collect_arrays_drops_strings_and_trims_padding():
    arrays = ColumnarRdd.collect_arrays(N.CpuSource.from_pandas(_df(50), 2),
                                        C.RapidsConf(EXPORT), device="cpu")
    ref = RColumnarRdd.collect_arrays(RN.CpuSource.from_pandas(_df(50), 2),
                                      RC.RapidsConf(EXPORT))
    assert set(arrays) == set(ref) == {"x", "noise", "label"}
    assert all(a.shape == (50,) for a in arrays.values())
    for name, a in arrays.items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(ref[name]))


def test_end_to_end_torch_training_on_export():
    """The ml-integration story: query -> device columns -> gradient
    descent with no host round trip.  Recovers y = 3x + 1."""
    plan = N.CpuProject([col("x"), col("label")],
                        N.CpuSource.from_pandas(_df(256), 2))
    cols = ColumnarRdd.collect_arrays(plan, C.RapidsConf(EXPORT),
                                      device="cpu")
    x = cols["x"].to(torch.float32).unsqueeze(1)
    y = cols["label"].to(torch.float32).unsqueeze(1)
    torch.manual_seed(0)
    model = torch.nn.Linear(1, 1)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for _ in range(200):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
    assert abs(model.weight.item() - 3.0) < 0.05
    assert abs(model.bias.item() - 1.0) < 0.05
