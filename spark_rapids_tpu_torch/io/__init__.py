"""The I/O layer (port of spark_rapids_tpu/io/): file scans (parquet, ORC,
CSV) and writers (parquet, ORC).  pyarrow decodes and encodes on the
host and is imported only where a file is read or written.

The entry points build plan nodes; `accelerate()` replaces them with the
GPU execs:

    plan = accelerate(CpuFilter(cond, read_parquet(path)), conf)
    df = collect(plan, conf)
    collect(accelerate(write(child, out_path, "parquet"), conf), conf)
"""
from __future__ import annotations

from typing import Optional, Sequence

from spark_rapids_tpu_torch import types as T


def read_parquet(path: str, schema: Optional[T.Schema] = None):
    from spark_rapids_tpu_torch.io.exec import CpuFileScan, ScanDescription
    return CpuFileScan(ScanDescription(path, "parquet", schema))


def read_orc(path: str, schema: Optional[T.Schema] = None):
    from spark_rapids_tpu_torch.io.exec import CpuFileScan, ScanDescription
    return CpuFileScan(ScanDescription(path, "orc", schema))


def read_csv(path: str, schema: T.Schema, options=None):
    from spark_rapids_tpu_torch.io.exec import CpuFileScan, ScanDescription
    return CpuFileScan(ScanDescription(path, "csv", schema, options))


def write(child, path: str, file_format: str,
          partition_by: Sequence[str] = (), mode: str = "error",
          options=None):
    from spark_rapids_tpu_torch.io.exec import CpuWriteFiles
    return CpuWriteFiles(child, path, file_format, partition_by, mode,
                         options)
