"""Two repairs of the port against the reference:

* A query that raises frees its device memory as soon as its error is
  dropped.  Its error's traceback holds the frames of the failed plan,
  and `TpuExec.collect` and the planner's collect each kept the error in
  a local of a frame on that traceback: a reference cycle, so every
  batch of the failed plan lived until the next cycle collection (on the
  card, a failed TPC-H or TPCx-BB query's memory stayed held while the
  next query ran).  The tests drop the error with the collector off and
  find every batch tensor the plan made gone.
* Every conf key of the reference is declared in the port, with the
  reference's default where the key means the same in both packages.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _raising_gathers(monkeypatch, fail_at: int) -> list:
    """Every ColumnVector.gather's output weakly recorded; the
    `fail_at`-th call raises OutOfMemoryError after making its output."""
    refs: list = []
    orig = ColumnVector.gather
    calls = [0]

    def gather(self, indices, index_valid=None):
        out = orig(self, indices, index_valid)
        refs.append(weakref.ref(out.data))
        calls[0] += 1
        if calls[0] == fail_at:
            raise torch.cuda.OutOfMemoryError("injected for the test")
        return out
    monkeypatch.setattr(ColumnVector, "gather", gather)
    return refs


def _planner_q3():
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    tables = TD.gen_tables(np.random.default_rng(7), 3000)
    return lambda: TB.run_query(3, tables, device="cpu")


def _exec_tree_q1():
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.models import tpch
    rng = np.random.default_rng(4)
    batches = [tpch.gen_lineitem(rng, 3000, device="cpu") for _ in range(4)]
    plan = tpch.q1_plan(LocalBatchSource([batches[:2], batches[2:]],
                                         device="cpu"))
    return lambda: plan.collect()


@pytest.mark.parametrize("make,fail_at", [(_planner_q3, 120),
                                          (_exec_tree_q1, 6)],
                         ids=["planner_q3", "exec_tree_q1"])
def test_a_raising_collect_frees_its_batches(monkeypatch, make, fail_at):
    run = make()
    refs = _raising_gathers(monkeypatch, fail_at)
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        err = None
        try:
            run()
        except torch.cuda.OutOfMemoryError as e:
            err = e
        assert err is not None, "the injected error did not surface"
        assert len(refs) >= fail_at
        assert any(r() is not None for r in refs), \
            "the error should hold the failed plan's frames"
        del err
        alive = sum(r() is not None for r in refs)
        assert alive == 0, (f"{alive} of {len(refs)} gathered tensors "
                            "outlived the dropped error")
    finally:
        if was_enabled:
            gc.enable()


def test_every_reference_conf_key_is_declared():
    from spark_rapids_tpu import config as RC
    missing = sorted(k for k in RC._REGISTRY if k not in C._REGISTRY)
    assert not missing, missing


@pytest.mark.parametrize("key", [
    "spark.rapids.sql.hasNans", "spark.rapids.sql.improvedFloatOps.enabled",
    "spark.rapids.sql.metrics.level", "spark.rapids.memory.gpu.debug",
    "spark.rapids.sql.kernelCache.maxEntries",
    "spark.rapids.sql.spmd.enabled"])
def test_declared_keys_keep_the_reference_defaults(key):
    from spark_rapids_tpu import config as RC
    assert C._REGISTRY[key].default == RC._REGISTRY[key].default
    assert C.RapidsConf({})[C._REGISTRY[key]] == RC._REGISTRY[key].default
