"""Parquet scan and write (port of spark_rapids_tpu/io/parquet.py).

pyarrow owns the host side: the footer parse and the column-chunk
decode.  Row groups are pruned on footer statistics *before* any data
page is read, so a selective filter reads only the matching byte ranges;
the decoded Arrow tables upload to the device as one padded batch.  A
row group belongs to the split that holds its byte midpoint (Spark's
convention), so concurrent splits of one file never read a row group
twice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io import pushdown as PD
from spark_rapids_tpu_torch.io import rebase as RB
from spark_rapids_tpu_torch.io.scan import (ChunkCounts, FileSplit,
                                            FormatReader)


def _rg_midpoint(rg) -> int:
    """Midpoint of the row group's COMPRESSED byte range (parquet-mr's
    split-assignment rule): rg.total_byte_size is uncompressed and can
    point past EOF, which would assign the row group to no split."""
    first_col = rg.column(0)
    start = first_col.dictionary_page_offset
    if start is None:
        start = first_col.data_page_offset
    total = sum(rg.column(i).total_compressed_size
                for i in range(rg.num_columns))
    return start + total // 2


def _stats_of_row_group(rg, names: list[str]) -> dict[str, PD.ColumnStats]:
    stats: dict[str, PD.ColumnStats] = {}
    for i in range(rg.num_columns):
        col = rg.column(i)
        name = col.path_in_schema.split(".")[0]
        if name not in names:
            continue
        s = col.statistics
        if s is None:
            stats[name] = PD.ColumnStats(num_values=rg.num_rows)
            continue
        stats[name] = PD.ColumnStats(
            min=s.min if s.has_min_max else None,
            max=s.max if s.has_min_max else None,
            null_count=s.null_count if s.has_null_count else None,
            num_values=rg.num_rows)
    return stats


class ParquetFormat(FormatReader):
    extension = ".parquet"

    def __init__(self, rebase_mode: Optional[str] = None,
                 counts: Optional[ChunkCounts] = None):
        self.counts = counts or ChunkCounts()
        # None = resolve from the active session conf at read time (the
        # conf collect() installs), via the shim-variant key
        self._explicit_rebase_mode = (
            None if rebase_mode is None else RB.normalize_mode(rebase_mode))

    @property
    def rebase_mode(self) -> str:
        if self._explicit_rebase_mode is not None:
            return self._explicit_rebase_mode
        from spark_rapids_tpu_torch import config as C
        return self._mode_from_conf(C.get_active_conf())

    @staticmethod
    def _mode_from_conf(conf) -> str:
        from spark_rapids_tpu_torch.shims import current_shims
        return current_shims(conf).parquet_rebase_read_mode(conf)

    def resolve_session(self, conf) -> "ParquetFormat":
        if self._explicit_rebase_mode is not None:
            return self
        return ParquetFormat(self._mode_from_conf(conf), self.counts)

    def file_schema(self, path: str) -> T.Schema:
        import pyarrow.parquet as pq
        sch = pq.read_schema(path)
        return T.Schema(tuple(
            T.Field(f.name, T.from_arrow(f.type)) for f in sch))

    def read_split(self, split: FileSplit, read_schema: T.Schema,
                   filter_expr) -> Optional["object"]:
        import pyarrow.parquet as pq
        f = pq.ParquetFile(split.path)
        md = f.metadata
        names = [n for n in read_schema.names
                 if n in set(md.schema.to_arrow_schema().names)]
        if filter_expr is not None and \
                self.rebase_mode == "LEGACY" and \
                not RB.is_corrected_file(md.metadata, False):
            # legacy files store Julian-hybrid day numbers: row-group
            # stats cannot be compared against proleptic-Gregorian
            # filter literals — skip pruning, keep exactness.
            # EXCEPTION mode keeps pruning on purpose: the rebase check
            # runs over DECODED values only (the post-pruning row groups,
            # as Spark's isDateTimeRebaseNeededRead does), so a pruned
            # row group never raises there either.
            filter_expr = None
        keep: list[int] = []
        mine = 0
        for rg_idx in range(md.num_row_groups):
            rg = md.row_group(rg_idx)
            if rg.num_rows == 0:
                continue
            mid = _rg_midpoint(rg)
            if not (split.start <= mid < split.start + split.length):
                continue
            mine += 1
            if filter_expr is not None and PD.might_match(
                    filter_expr, _stats_of_row_group(rg, names)) is False:
                continue
            keep.append(rg_idx)
        self.counts.add(len(keep), mine)
        if not keep:
            return None
        table = f.read_row_groups(keep, columns=names or None,
                                  use_threads=False)
        return RB.apply_read_rebase(table, md.metadata, self.rebase_mode,
                                    "Parquet")


# ---------------------------------------------------------------------------
# write side
_PA_COMPRESSION = {"none": "NONE", "uncompressed": "NONE", "snappy": "SNAPPY",
                   "gzip": "GZIP", "zstd": "ZSTD", "lz4": "LZ4"}


@dataclasses.dataclass
class ParquetWriterOptions:
    compression: str = "snappy"
    # None = resolve from the session conf via the shim-variant key
    # (spark.sql.legacy.parquet.datetimeRebaseModeInWrite and friends)
    rebase_mode: Optional[str] = None


class ParquetColumnarWriter:
    """Streams batches into one parquet file: Arrow's parquet writer
    over each downloaded batch.  The footer carries the session's Spark
    version, so readers' corrected-mode detection recognizes the file."""

    def __init__(self, path: str, schema: T.Schema,
                 options: Optional[ParquetWriterOptions] = None):
        import pyarrow as pa
        import pyarrow.parquet as pq
        self.path = path
        self.schema = schema
        opts = options or ParquetWriterOptions()
        codec = _PA_COMPRESSION.get(opts.compression.lower())
        if codec is None:
            raise ValueError(
                f"unsupported parquet compression {opts.compression}")
        from spark_rapids_tpu_torch import config as C
        conf = C.get_active_conf()
        mode = opts.rebase_mode
        if mode is None:
            from spark_rapids_tpu_torch.shims import current_shims
            mode = current_shims(conf).parquet_rebase_write_mode(conf)
        self.rebase_mode = RB.normalize_mode(mode)
        if self.rebase_mode not in RB.READ_MODES:
            raise ValueError(
                f"unrecognized datetime rebase mode {mode}")
        meta = {RB.SPARK_VERSION_METADATA_KEY:
                str(conf[C.SPARK_VERSION]).encode("utf-8")}
        if self.rebase_mode == "LEGACY":
            meta[RB.SPARK_LEGACY_DATETIME_KEY] = b""
        self._arrow_schema = pa.schema(
            [pa.field(f.name, T.to_arrow(f.dtype)) for f in schema.fields])
        self._writer = pq.ParquetWriter(
            path, self._arrow_schema.with_metadata(meta),
            compression=codec.lower())
        self.rows_written = 0
        self.bytes_written = 0

    def write_batch(self, batch) -> None:
        RB.check_batch_write(batch, self.rebase_mode, "Parquet")
        table = batch.to_arrow().cast(self._arrow_schema)
        if self.rebase_mode == "LEGACY":
            table = RB.rebase_arrow_table_write(table)
        self._writer.write_table(table)
        self.rows_written += batch.num_rows

    def close(self) -> None:
        import os
        self._writer.close()
        self.bytes_written = os.path.getsize(self.path)
