"""Guards of spark_rapids_tpu_torch: it stands alone, its entry points run
on the card or refuse, and its kernel wrappers launch nothing for CPU
tensors."""
import ast
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import graft_entry
from spark_rapids_tpu_torch import memory as M
from spark_rapids_tpu_torch import plugin
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.serde import (deserialize_batch,
                                                   serialize_batch)
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.ml import ColumnarRdd
from spark_rapids_tpu_torch.models import (mortgage, tpcds_bench, tpcds_data,
                                           tpch, tpcxbb)
from spark_rapids_tpu_torch.ops import grouped_window as GW
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_tpu_torch.plan.nodes import CpuSource
from spark_rapids_tpu_torch.plan.overrides import accelerate
from spark_rapids_tpu_torch.pyudf.exec import (CpuArrowEvalPython,
                                               PandasUdfSpec)
from spark_rapids_tpu_torch.utils import fuzzer

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*torch*.py"))


def test_the_import_guard_covers_the_io_layer_and_the_shims():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for layer in ("io", "shims"):
        files = sorted((ROOT / "spark_rapids_tpu_torch" / layer).glob(
            "*.py"))
        assert files and all(str(p.relative_to(ROOT)) in names
                             for p in files)


def test_the_import_guard_covers_the_shuffle_manager_lane():
    """The shuffle manager, its transport, codecs, catalogs, recovery,
    speculation and the script that runs its phase are under the guard."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("shuffle/transport.py", "shuffle/compression.py",
              "shuffle/catalog.py", "shuffle/client_server.py",
              "shuffle/ici_transport.py", "shuffle/manager.py",
              "shuffle/recovery.py", "exec/speculation.py"):
        assert f"spark_rapids_tpu_torch/{f}" in names, f
    assert "scripts/torch_shuffle_phase.py" in names


def test_the_import_guard_covers_the_observability_layer():
    """The tracer, ledgers, kernel catalog, telemetry and roofline, and
    the script that runs their phase, are under the guard."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("tracing", "roofline", "profile", "movement", "residency",
              "kernelprof", "telemetry"):
        assert f"spark_rapids_tpu_torch/utils/{f}.py" in names, f
    assert "scripts/torch_profile_phase.py" in names


def test_the_import_guard_covers_the_udf_layer_plugin_and_ml():
    """The UDF compiler, the pandas execs and their worker daemon, the
    per-version shims, the plugin, the API audit and the ML export are
    under the guard."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("udf/__init__.py", "udf/compiler.py", "pyudf/__init__.py",
              "pyudf/semaphore.py", "pyudf/worker.py", "pyudf/daemon.py",
              "pyudf/exec.py", "plugin.py", "api_validation.py",
              "ml/__init__.py", "ml/columnar_rdd.py", "shims/spark300.py",
              "shims/spark300db.py", "shims/spark301.py",
              "shims/spark302.py", "shims/spark310.py"):
        assert f"spark_rapids_tpu_torch/{f}" in names, f


def test_the_udf_worker_imports_no_torch():
    """`python -m spark_rapids_tpu_torch.pyudf.worker` loads the package
    and its pyudf package lazily: neither imports torch at start-up."""
    import subprocess
    import sys
    code = ("import sys, spark_rapids_tpu_torch.pyudf.worker as w; "
            "w.initialize_worker_env(); import os; "
            "print('torch' in sys.modules, "
            "repr(os.environ['CUDA_VISIBLE_DEVICES']))")
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "RAPIDS_PYTHON_ON_TPU"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "''"]


def test_a_transport_class_of_the_jax_package_is_refused(monkeypatch):
    """spark.rapids.shuffle.transport.class naming a module of the JAX
    package (its own default, in a conf both packages share) raises a
    ValueError naming the port's class, and nothing is imported."""
    import importlib

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.shuffle import transport as TR
    imported = []
    real = importlib.import_module
    monkeypatch.setattr(importlib, "import_module",
                        lambda name, *a: imported.append(name) or
                        real(name, *a))
    for path in ("spark_rapids_tpu.shuffle.ici_transport.IciShuffleTransport",
                 "spark_rapids_tpu.no_such_module.Transport"):
        conf = C.RapidsConf({C.SHUFFLE_TRANSPORT_CLASS.key: path})
        with pytest.raises(ValueError, match="spark_rapids_tpu_torch.shuffle"
                           ".ici_transport.IciShuffleTransport"):
            TR.make_transport(conf)
    assert imported == []
    t = TR.make_transport(C.RapidsConf())
    assert type(t).__module__ == "spark_rapids_tpu_torch.shuffle.ici_transport"
    t.shutdown()


@pytest.mark.parametrize("layer", ["io", "shims"])
def test_io_and_shims_import_pyarrow_only_inside_functions(layer):
    """pyarrow decodes and encodes on the host only where a file is read
    or written: the rest of the port imports without it."""
    for path in sorted((ROOT / "spark_rapids_tpu_torch" / layer).glob(
            "*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom)
                    else [])
            assert not any(m and m.split(".")[0] == "pyarrow"
                           for m in mods), f"{path.name} imports pyarrow"


def _imported_modules(path: Path) -> list:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "spark_rapids_tpu"), \
            f"{path.name} imports {mod}"


def test_the_import_guard_covers_the_distribution_layer():
    """The mesh, the mesh all-to-all, the SPMD gangs, the graft entry's
    twin and the script that runs their phase are under the guard."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("parallel/__init__.py", "parallel/mesh.py",
              "parallel/collective_exchange.py", "exec/spmd.py",
              "graft_entry.py"):
        assert f"spark_rapids_tpu_torch/{f}" in names, f
    assert "scripts/torch_mesh_phase.py" in names


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points run there")


_ENTRY_POINTS = {
    "ColumnarBatch.from_numpy": lambda: ColumnarBatch.from_numpy(
        {"a": np.arange(4, dtype=np.int32)}),
    "ColumnVector.from_numpy": lambda: ColumnVector.from_numpy(
        np.arange(4, dtype=np.int64)),
    "gen_lineitem": lambda: tpch.gen_lineitem(np.random.default_rng(0), 8),
    "LocalBatchSource": lambda: LocalBatchSource([[]]),
    "build_q1_fused_kernel": lambda: tpch.build_q1_fused_kernel(1024, 256),
    "build_q1_kernel": lambda: tpch.build_q1_kernel(1024),
    "random_batch": lambda: fuzzer.random_batch(np.random.default_rng(0)),
    "DeviceManager": lambda: M.DeviceManager(hbm_total=1 << 30),
    "DeviceMemoryStore": lambda: M.DeviceMemoryStore(),
    "HostMemoryStore": lambda: M.HostMemoryStore(1 << 10),
    "DiskStore": lambda: M.DiskStore(),
    "ResourceEnv": lambda: M.ResourceEnv(hbm_total=1 << 30),
    "deserialize_batch": lambda: deserialize_batch(serialize_batch(
        ColumnarBatch.from_numpy({"a": np.arange(4)}, device="cpu")),
        "cuda"),
    "tpcds_bench.run_query": lambda: tpcds_bench.run_query(
        "q3", tpcds_data.gen_tables(np.random.default_rng(0), 2000)),
    "tpcxbb.run_query": lambda: tpcxbb.run_query(
        "q01", tpcxbb.gen_tables(np.random.default_rng(0), 2000)),
    "tpcxbb.run_query(q27)": lambda: tpcxbb.run_query(
        "q27", tpcxbb.gen_tables(np.random.default_rng(0), 2000)),
    "plugin.activate": lambda: plugin.activate({}),
    "ColumnarRdd.convert": lambda: ColumnarRdd.convert(
        CpuSource.from_pandas(pd.DataFrame({"a": [1, 2]})),
        C.RapidsConf({"spark.rapids.sql.exportColumnarRdd": True})),
    "ArrowEvalPythonExec": lambda: accelerate(CpuArrowEvalPython(
        [PandasUdfSpec("r", lambda s: s, T.INT64, (col("a"),))],
        CpuSource.from_pandas(pd.DataFrame({"a": [1, 2]}))),
        C.RapidsConf({"spark.rapids.sql.exec.CpuArrowEvalPython": True})),
    "make_mesh": lambda: make_mesh(4, slots_per_device=4),
    "graft_entry.entry": lambda: graft_entry.entry(),
    "graft_entry.dryrun_multichip": lambda: graft_entry.dryrun_multichip(4),
    "mortgage.run_plan": lambda: mortgage.run_plan(
        mortgage.etl_plan, mortgage.gen_tables(np.random.default_rng(0),
                                               20, 2)),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_refuse_to_fall_back_to_the_cpu(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name]()


def test_a_file_scan_refuses_to_read_onto_the_cpu(no_card, tmp_path):
    """read_parquet(...) accelerated for "cuda" raises without a card; it
    does not read onto the CPU instead."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.io.exec import (ScanDescription,
                                                TpuFileSourceScanExec)
    from spark_rapids_tpu_torch.plan.overrides import accelerate
    pq.write_table(pa.table({"a": [1, 2]}), tmp_path / "a.parquet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accelerate(pio.read_parquet(str(tmp_path)), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuFileSourceScanExec(ScanDescription(str(tmp_path), "parquet"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColumnarBatch.from_arrow(pa.table({"a": [1, 2]}))


def test_cpu_tensors_launch_no_kernel():
    before = (K.q1_fused.launches, K.grouped_sum.launches,
              GW.window_group_sums.launches)
    n = 256
    i32 = torch.zeros(n, dtype=torch.int32)
    f32 = torch.ones(n, dtype=torch.float32)
    table = K.q1_fused(i32, i32, f32, f32, f32, f32, i32, 5, capacity=n,
                       cutoff=tpch.Q1_CUTOFF_DAYS)
    assert table[0, 5].item() == 5
    sums, counts = K.grouped_sum(i32, [f32], n, n_groups=3, capacity=n)
    assert counts.tolist() == [n, 0, 0]
    out = GW.window_group_sums(i32, [f32], out_cap=2, capacity=n)
    assert out[0, 0].item() == n
    assert (K.q1_fused.launches, K.grouped_sum.launches,
            GW.window_group_sums.launches) == before == (0, 0, 0)


def test_wrappers_refuse_malformed_inputs():
    i32 = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected torch.float32"):
        K.grouped_sum(i32, [i32], 64, n_groups=2, capacity=64)
    with pytest.raises(ValueError, match="contiguous"):
        GW.window_group_sums(torch.zeros(128, dtype=torch.int32)[::2],
                             [torch.ones(64)], out_cap=2, capacity=64)
    with pytest.raises(ValueError, match="multiple of batch_rows"):
        K.q1_fused(*([i32] * 2 + [torch.ones(64)] * 4 + [i32]), 1,
                   capacity=64, cutoff=0, batch_rows=48)


def test_memory_layer_takes_its_device(tmp_path):
    """The memory layer's objects live on the device they are given; the
    process singletons refuse to be made without one."""
    env = M.ResourceEnv.init(hbm_total=1 << 30, spill_dir=str(tmp_path),
                             device="cpu")
    try:
        for obj in (env, env.device_manager, env.device_store,
                    env.host_store, env.disk_store):
            assert obj.device == torch.device("cpu")
    finally:
        M.ResourceEnv.shutdown()
    with pytest.raises(ValueError, match="no device"):
        M.DeviceManager.get()
    with pytest.raises(ValueError, match="no device"):
        M.ResourceEnv.get()
    assert M.DeviceManager.peek() is None and M.ResourceEnv.peek() is None
