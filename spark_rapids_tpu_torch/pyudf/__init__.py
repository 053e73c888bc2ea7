"""Python and pandas UDF execution (port of spark_rapids_tpu/pyudf/;
reference `org/apache/spark/sql/rapids/execution/python/`:
`GpuArrowEvalPythonExec` ships batches to a Python worker over Arrow IPC
and reads the results back as batches, `GpuMapInPandas` maps whole
frames, `PythonWorkerSemaphore` caps concurrent workers).

A batch leaves the card once at these operators, the UDF sees pandas
objects under the worker semaphore, and the result columns are uploaded
again under the task semaphore.  Vectorized UDFs run in-process, or in
the daemon's worker processes under spark.rapids.python.daemon.enabled
(pyudf/daemon.py).  The execs are off by default, as in the reference
(`GpuOverrides.scala:1821-1845`).

The names below load on first use, so that `python -m
spark_rapids_tpu_torch.pyudf.worker` imports neither torch nor the
port's kernels.
"""
import importlib

_EXPORTS = {
    "PythonWorkerSemaphore": "semaphore",
    **{name: "exec" for name in (
        "AggregateInPandasExec", "ArrowEvalPythonExec",
        "CpuAggregateInPandas", "CpuArrowEvalPython",
        "CpuFlatMapCoGroupsInPandas", "CpuFlatMapGroupsInPandas",
        "CpuMapInPandas", "CpuWindowInPandas", "FlatMapCoGroupsInPandasExec",
        "FlatMapGroupsInPandasExec", "MapInPandasExec", "PandasUdfSpec",
        "WindowInPandasExec", "pandas_udf")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
