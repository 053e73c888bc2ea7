"""CSV scan (port of spark_rapids_tpu/io/csv.py).

Files split at byte boundaries; each split is extended on the host to
the next line boundary (its first partial line belongs to the split
before it) and parsed by pyarrow's CSV reader with the user's schema, so
no split infers types of its own, then uploaded as one batch.

Options the GPU path does not implement (multi-character separators,
comments, custom line terminators, custom date formats) keep the scan
on the CPU at tag time (`CsvOptions.tag_unsupported`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io.scan import FileSplit, FormatReader


@dataclasses.dataclass(frozen=True)
class CsvOptions:
    sep: str = ","
    header: bool = False
    null_value: str = ""
    quote: str = '"'
    comment: str = ""           # unsupported when set
    line_sep: str = "\n"        # only \n supported
    date_format: str = ""       # non-default formats unsupported

    def tag_unsupported(self) -> list[str]:
        reasons = []
        if len(self.sep) != 1:
            reasons.append("multi-character separators are not supported")
        if self.comment:
            reasons.append("comment skipping is not supported")
        if self.line_sep != "\n":
            reasons.append("custom line separators are not supported")
        if self.date_format:
            reasons.append("custom date formats are not supported")
        return reasons


def _read_split_lines(split: FileSplit) -> bytes:
    """Read [start, start+length), snapped to line boundaries: skip the
    first partial line unless at file start; extend past the end to finish
    the last line."""
    with open(split.path, "rb") as f:
        f.seek(split.start)
        data = f.read(split.length)
        if split.start > 0:
            nl = data.find(b"\n")
            data = data[nl + 1:] if nl >= 0 else b""
        if split.start + split.length < split.file_size and data:
            tail = b""
            while True:
                chunk = f.read(65536)
                if not chunk:
                    break
                nl = chunk.find(b"\n")
                if nl >= 0:
                    tail += chunk[: nl + 1]
                    break
                tail += chunk
            data += tail
    return data


class CsvFormat(FormatReader):
    extension = ".csv"

    def __init__(self, schema: T.Schema, options: Optional[CsvOptions] = None):
        # CSV requires a user schema: inference would run per split
        self.schema = schema
        self.options = options or CsvOptions()

    def file_schema(self, path: str) -> T.Schema:
        return self.schema

    def read_split(self, split: FileSplit, read_schema: T.Schema,
                   filter_expr) -> Optional["object"]:
        import io

        import pyarrow as pa
        import pyarrow.csv as pacsv
        data = _read_split_lines(split)
        opts = self.options
        if split.start == 0 and opts.header and data:
            nl = data.find(b"\n")
            data = data[nl + 1:] if nl >= 0 else b""
        if not data:
            return None
        column_types = {f.name: T.to_arrow(f.dtype)
                        for f in self.schema.fields}
        table = pacsv.read_csv(
            io.BytesIO(data),
            read_options=pacsv.ReadOptions(
                column_names=list(self.schema.names), use_threads=False),
            parse_options=pacsv.ParseOptions(delimiter=opts.sep,
                                             quote_char=opts.quote),
            convert_options=pacsv.ConvertOptions(
                column_types=column_types,
                null_values=[opts.null_value],
                strings_can_be_null=True,
                include_columns=[n for n in read_schema.names
                                 if n in self.schema.names]))
        return table
