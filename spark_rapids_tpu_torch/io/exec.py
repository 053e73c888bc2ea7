"""Scan and write operators and their device-neutral plan nodes (port of
spark_rapids_tpu/io/exec.py).

`CpuFileScan` and `CpuWriteFiles` are what a user's plan holds (Spark's
FileSourceScanExec and InsertIntoHadoopFsRelationCommand) and the CPU
engine's evaluation of them; plan/overrides.py converts them to
`TpuFileSourceScanExec` and `TpuWriteFilesExec`, with the per-format
enable confs and the CSV option guards deciding fallback.  Each scan
partition is read straight through its coalescing reader; no prefetch
thread overlaps it with the device work above.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.exec.base import TpuExec, UnaryExecBase
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.io.csv import CsvFormat, CsvOptions
from spark_rapids_tpu_torch.io.orc import OrcFormat
from spark_rapids_tpu_torch.io.parquet import ParquetFormat
from spark_rapids_tpu_torch.io.scan import (FilePartition, FormatReader,
                                            MultiFileCoalescingReader,
                                            discover_files)
from spark_rapids_tpu_torch.io.writer import WriteJob, WriteStats
from spark_rapids_tpu_torch.plan.nodes import CpuNode, normalize_df


def make_format(file_format: str, schema: Optional[T.Schema] = None,
                options=None) -> FormatReader:
    if file_format == "parquet":
        # the hybrid-calendar read mode is frozen from the session conf
        # by FormatReader.resolve_session at execution time
        return ParquetFormat()
    if file_format == "orc":
        return OrcFormat()
    if file_format == "csv":
        if schema is None:
            raise ValueError("CSV requires an explicit schema")
        return CsvFormat(schema, options or CsvOptions())
    raise ValueError(f"unsupported scan format {file_format}")


class ScanDescription:
    """A planned scan, shared by the CPU node and the GPU exec: files
    discovered, splits packed, schemas resolved."""

    _EXTENSIONS = {"parquet": ".parquet", "orc": ".orc", "csv": ".csv"}

    def __init__(self, path: str, file_format: str,
                 schema: Optional[T.Schema] = None, options=None,
                 conf: Optional[C.RapidsConf] = None):
        conf = conf or C.get_active_conf()
        self.path = path
        self.file_format = file_format
        self.options = options
        files, self.part_schema = discover_files(
            path, self._EXTENSIONS[file_format])
        # partition columns never live in the data files: strip them
        # BEFORE building the reader (the CSV parser needs the exact
        # per-file column list)
        if schema is not None:
            self.data_schema = T.Schema(tuple(
                f for f in schema.fields
                if f.name not in self.part_schema.names))
        else:
            if not files:
                raise FileNotFoundError(f"no {file_format} files in {path}")
            probe = make_format(file_format, None, options)
            self.data_schema = T.Schema(tuple(
                f for f in probe.file_schema(files[0].path).fields
                if f.name not in self.part_schema.names))
        self.reader = make_format(file_format, self.data_schema, options)
        #: the multi-file (small-file coalescing) reader's toggle; see
        #: shims.copy_scan_with_small_file_opt
        self.small_file_opt = True
        from spark_rapids_tpu_torch.shims import current_shims
        self.partitions = current_shims(conf).plan_file_partitions(
            files, conf[C.MAX_PARTITION_BYTES], conf[C.FILE_OPEN_COST],
            min_partitions=conf[C.MIN_PARTITION_NUM])
        self.output_schema = T.Schema(
            tuple(self.data_schema.fields) + tuple(self.part_schema.fields))

    def pruned(self, names: set) -> "ScanDescription":
        """A copy that reads only the named columns (Catalyst's schema
        pruning): the reader decodes only their chunks or stripes."""
        sd = copy.copy(self)
        sd.data_schema = T.Schema(tuple(
            f for f in self.data_schema.fields if f.name in names))
        sd.part_schema = T.Schema(tuple(
            f for f in self.part_schema.fields if f.name in names))
        sd.reader = make_format(self.file_format, sd.data_schema,
                                self.options)
        sd.output_schema = T.Schema(
            tuple(sd.data_schema.fields) + tuple(sd.part_schema.fields))
        return sd


class CpuFileScan(CpuNode):
    """The scan in a user's plan, and its CPU evaluation."""

    def __init__(self, scan: ScanDescription):
        super().__init__()
        self.scan = scan
        self.pushed_filter: Optional[Expression] = None

    def name(self) -> str:
        return f"CpuFileScan[{self.scan.file_format}]"

    def describe(self) -> str:
        return (f"CpuFileScan[{self.scan.file_format}]({self.scan.path}, "
                f"{len(self.scan.partitions)} partitions)")

    def output_schema(self) -> T.Schema:
        return self.scan.output_schema

    def output_partition_count(self) -> int:
        return max(1, len(self.scan.partitions))

    def execute(self) -> list[Iterator[pd.DataFrame]]:
        return [self._read_partition(p) for p in self.scan.partitions]

    def _read_partition(self, part: FilePartition
                        ) -> Iterator[pd.DataFrame]:
        scan = self.scan
        reader = scan.reader.resolve_session(C.get_active_conf())
        for split in part.splits:
            table = reader.read_split(split, scan.data_schema,
                                      self.pushed_filter)
            if table is None or table.num_rows == 0:
                continue
            df = table.to_pandas()
            for f in scan.data_schema.fields:
                if f.name not in df.columns:
                    df[f.name] = pd.Series([pd.NA] * len(df))
            pvals = dict(split.partition_values)
            for f in scan.part_schema.fields:
                df[f.name] = pvals.get(f.name)
            # dates become int32 days in normalize_df
            yield normalize_df(df[list(scan.output_schema.names)],
                               scan.output_schema)


class TpuFileSourceScanExec(TpuExec):
    """Columnar file scan on `device`: one output partition per
    FilePartition, decoded on the host's buffering pool and uploaded."""

    def __init__(self, scan: ScanDescription,
                 pushed_filter: Optional[Expression] = None,
                 conf: Optional[C.RapidsConf] = None, device="cuda"):
        super().__init__()
        self.scan = scan
        self.pushed_filter = pushed_filter
        self.conf = conf or C.get_active_conf()
        self._device = resolve_device(device)

    def output_schema(self) -> T.Schema:
        return self.scan.output_schema

    def device(self) -> torch.device:
        return self._device

    def output_partition_count(self) -> int:
        return max(1, len(self.scan.partitions))

    def describe(self) -> str:
        pf = f", pushed={self.pushed_filter!r}" if self.pushed_filter else ""
        return (f"TpuFileSourceScanExec[{self.scan.file_format}]"
                f"({self.scan.path}{pf})")

    def execute_partitions(self) -> list[Iterator[ColumnarBatch]]:
        # scan->compute pipeline break: a producer decodes and uploads
        # batch k+1 while the consumer works on batch k (started lazily,
        # so partitions do not all begin at once); the prefetch conf is
        # the running query's, not the plan-time snapshot
        from spark_rapids_tpu_torch.exec.pipeline import maybe_prefetch
        return [maybe_prefetch(self._partition_iter(p), label="scan",
                               metrics=self.metrics)
                for p in self.scan.partitions] or [iter(())]

    def _partition_iter(self, part: FilePartition
                        ) -> Iterator[ColumnarBatch]:
        if self.scan.small_file_opt:
            groups = [part]
        else:
            # coalescing off: each split decodes through its own reader
            groups = [dataclasses.replace(part, splits=(s,))
                      for s in part.splits]
        for g in groups:
            reader = MultiFileCoalescingReader(
                self.scan.reader, g, self.scan.data_schema,
                self.scan.part_schema, self.pushed_filter, self.conf,
                self._device, metrics=self.metrics)
            for batch in reader:
                self.update_output_metrics(batch)
                yield batch


# ---------------------------------------------------------------------------
_WRITE_SCHEMA = T.Schema.of(("num_files", T.INT64), ("num_rows", T.INT64),
                            ("num_bytes", T.INT64))


class CpuWriteFiles(CpuNode):
    """A write in a user's plan (InsertIntoHadoopFsRelationCommand); it
    runs on whichever engine its child landed on.  Output: one summary
    row."""

    def __init__(self, child: CpuNode, path: str, file_format: str,
                 partition_by: Sequence[str] = (), mode: str = "error",
                 options=None):
        super().__init__(child)
        self.path = path
        self.file_format = file_format
        self.partition_by = list(partition_by)
        self.mode = mode
        self.options = options

    def name(self) -> str:
        return f"CpuWriteFiles[{self.file_format}]"

    def output_schema(self) -> T.Schema:
        return _WRITE_SCHEMA

    def output_partition_count(self) -> int:
        return 1

    def execute(self) -> list[Iterator[pd.DataFrame]]:
        schema = self.child.output_schema()
        batches = ([ColumnarBatch.from_numpy(
            _df_data(df, schema), schema, _df_validity(df, schema),
            device="cpu") for df in it] for it in self.child.execute())
        total = _run_job(WriteJob(self.path, self.file_format, schema,
                                  self.partition_by, self.mode,
                                  self.options), batches)
        return [iter([pd.DataFrame({
            "num_files": pd.array([total.num_files], "Int64"),
            "num_rows": pd.array([total.num_rows], "Int64"),
            "num_bytes": pd.array([total.num_bytes], "Int64")})])]


def _run_job(job: WriteJob, tasks, metrics=None) -> WriteStats:
    """Run a write job: one task per iterable of batches, each task's
    attempt committed after its last batch, the job committed after the
    last task; a failure aborts the attempt and the job."""
    job.setup()
    stats_list = []
    try:
        for task_id, batches in enumerate(tasks):
            writer = job.task_writer(task_id)
            try:
                for batch in batches:
                    writer.write(batch)
            except BaseException:
                writer.abort()  # this attempt only
                raise
            stats_list.append(writer.commit())
    except BaseException:
        job.abort()
        raise
    return job.commit(stats_list)


def _df_data(df: pd.DataFrame, schema: T.Schema) -> dict:
    data = {}
    for f in schema.fields:
        s = df[f.name]
        if f.dtype.is_string:
            data[f.name] = np.array(
                [None if v is None or v is pd.NA else v for v in s],
                dtype=object)
        elif s.dtype.kind == "M":  # datetime64 -> int64 micros
            data[f.name] = np.where(
                s.isna().to_numpy(), 0,
                s.to_numpy().astype("datetime64[us]").astype(np.int64))
        else:
            data[f.name] = s.to_numpy(dtype=f.dtype.storage_dtype,
                                      na_value=0)
    return data


def _df_validity(df: pd.DataFrame, schema: T.Schema) -> dict:
    return {f.name: ~df[f.name].isna().to_numpy() for f in schema.fields}


class TpuWriteFilesExec(UnaryExecBase):
    """Columnar write: each task streams its batches from the device into
    the host encoder."""

    def __init__(self, node: CpuWriteFiles, child: TpuExec):
        super().__init__(child)
        self.node = node

    def output_schema(self) -> T.Schema:
        return _WRITE_SCHEMA

    def output_partition_count(self) -> int:
        return 1

    def describe(self) -> str:
        return (f"TpuWriteFilesExec[{self.node.file_format}]"
                f"({self.node.path})")

    def execute_partitions(self):
        return [self._write()]

    def _write(self) -> Iterator[ColumnarBatch]:
        node = self.node
        job = WriteJob(node.path, node.file_format,
                       self.child.output_schema(), node.partition_by,
                       node.mode, node.options)
        with self.metrics.timed():
            total = _run_job(job, self.child.execute_partitions())
        out = ColumnarBatch.from_numpy(
            {"num_files": np.array([total.num_files], np.int64),
             "num_rows": np.array([total.num_rows], np.int64),
             "num_bytes": np.array([total.num_bytes], np.int64)},
            _WRITE_SCHEMA, device=self.device())
        self.update_output_metrics(out)
        yield out
