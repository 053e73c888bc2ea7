"""ORC scan and write (port of spark_rapids_tpu/io/orc.py).

pyarrow's ORC reader owns the host decode.  A stripe belongs to the
split that holds its byte midpoint.  pyarrow exposes no per-stripe
statistics, so pruning is file-level only (schema existence and the
split range); the filter is still applied exactly by the FilterExec
above the scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io.scan import (ChunkCounts, FileSplit,
                                            FormatReader)


class OrcFormat(FormatReader):
    extension = ".orc"

    def __init__(self):
        self.counts = ChunkCounts()

    def file_schema(self, path: str) -> T.Schema:
        from pyarrow import orc
        f = orc.ORCFile(path)
        return T.Schema(tuple(
            T.Field(fld.name, T.from_arrow(fld.type)) for fld in f.schema))

    def read_split(self, split: FileSplit, read_schema: T.Schema,
                   filter_expr) -> Optional["object"]:
        import pyarrow as pa
        from pyarrow import orc
        f = orc.ORCFile(split.path)
        names = [n for n in read_schema.names if n in f.schema.names]
        total = f.nstripes
        if total == 0:
            return None
        # pyarrow's ORCFile exposes no stripe byte offsets, so stripes map
        # onto splits by even byte apportionment of the file — deterministic
        # and non-overlapping across a file's splits, like the midpoint rule
        per = max(1, split.file_size // total)
        keep = [i for i in range(total)
                if split.start <= i * per + per // 2
                < split.start + split.length]
        self.counts.add(len(keep), len(keep))
        if not keep:
            return None
        stripes = [f.read_stripe(i, columns=names or None) for i in keep]
        tbls = [pa.Table.from_batches([s]) if isinstance(s, pa.RecordBatch)
                else s for s in stripes]
        return pa.concat_tables(tbls)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OrcWriterOptions:
    compression: str = "snappy"


_ORC_COMPRESSION = {"none": "UNCOMPRESSED", "uncompressed": "UNCOMPRESSED",
                    "snappy": "SNAPPY", "zlib": "ZLIB", "zstd": "ZSTD",
                    "lz4": "LZ4"}


class OrcColumnarWriter:
    """Streams batches into one ORC file: Arrow's ORC writer over each
    downloaded batch."""

    def __init__(self, path: str, schema: T.Schema,
                 options: Optional[OrcWriterOptions] = None):
        import pyarrow as pa
        from pyarrow import orc
        self.path = path
        self.schema = schema
        opts = options or OrcWriterOptions()
        codec = _ORC_COMPRESSION.get(opts.compression.lower())
        if codec is None:
            raise ValueError(f"unsupported ORC compression {opts.compression}")
        self._arrow_schema = pa.schema(
            [pa.field(f.name, T.to_arrow(f.dtype)) for f in schema.fields])
        self._writer = orc.ORCWriter(path, compression=codec)
        self.rows_written = 0
        self.bytes_written = 0

    def write_batch(self, batch) -> None:
        table = batch.to_arrow().cast(self._arrow_schema)
        self._writer.write(table)
        self.rows_written += batch.num_rows

    def close(self) -> None:
        import os
        self._writer.close()
        self.bytes_written = os.path.getsize(self.path)
