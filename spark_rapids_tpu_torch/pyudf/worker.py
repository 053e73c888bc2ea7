"""Out-of-process Python UDF worker (port of
spark_rapids_tpu/pyudf/worker.py; reference `python/rapids/worker.py`,
the forked pyspark worker that sets up its device memory from the
environment before any UDF runs).

A worker stays off the card: `initialize_worker_env()` empties
CUDA_VISIBLE_DEVICES unless RAPIDS_PYTHON_ON_TPU=true (the reference's
name, set from spark.rapids.python.onTpu.enabled), so a UDF that
imports torch makes no CUDA context and takes no device memory from the
executor.  The daemon sets the same variable in the worker's
environment before the process starts; this module sets it again for a
worker started by hand.  RAPIDS_PYTHON_MEM_LIMIT_BYTES bounds the
worker's address space (RLIMIT_AS).  A worker allowed on the card with
such a limit may fail its first CUDA call, since CUDA maps far more
address space than it uses; that error reaches the caller as the UDF's
error, it is not hidden.

The worker imports neither torch nor the port's kernels: only pyarrow,
pandas and cloudpickle, and whatever the UDF itself imports.

Wire protocol over stdin/stdout (all little-endian):
    request:  u32 fn_len | cloudpickled fn | u32 ipc_len | Arrow IPC
              stream of the argument batch
    response: u8 status (0=ok, 1=error) | u32 len | payload
              ok: Arrow IPC stream of the result batch
              error: utf-8 traceback
    shutdown: u32 fn_len == 0
"""
from __future__ import annotations

import os
import struct
import sys


def initialize_worker_env() -> None:
    if os.environ.get("RAPIDS_PYTHON_ON_TPU", "false").lower() != "true":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    limit = int(os.environ.get("RAPIDS_PYTHON_MEM_LIMIT_BYTES", "0"))
    if limit > 0:
        try:
            import resource
            resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
        except (ImportError, ValueError, OSError):
            pass  # best effort, like the reference's optional pool init


def _read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise EOFError("worker stdin closed")
        buf += chunk
    return buf


def _read_frame(stream) -> bytes:
    (n,) = struct.unpack("<I", _read_exact(stream, 4))
    return _read_exact(stream, n) if n else b""


def _write_response(stream, status: int, payload: bytes) -> None:
    stream.write(struct.pack("<BI", status, len(payload)))
    stream.write(payload)
    stream.flush()


def _df_to_ipc(df) -> bytes:
    import pyarrow as pa
    table = pa.Table.from_pandas(df, preserve_index=False)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def _ipc_to_df(blob: bytes):
    import pyarrow as pa
    with pa.ipc.open_stream(pa.BufferReader(blob)) as r:
        return r.read_all().to_pandas()


class ApplyUdfs:
    """The worker's side of a vectorized UDF batch: each (name, fn,
    argument columns) applied to the shipped argument columns; only the
    result columns go back."""

    def __init__(self, specs):
        self.specs = specs

    def __call__(self, frame):
        import pandas as pd
        res = {}
        for name, fn, cols in self.specs:
            vals = fn(*[frame[c] for c in cols])
            if not isinstance(vals, pd.Series):
                vals = pd.Series(vals, index=frame.index)
            res[name] = vals
        return pd.DataFrame(res, index=frame.index)


def main() -> int:
    initialize_worker_env()
    import cloudpickle
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    # whatever the UDF prints must not corrupt the protocol stream
    sys.stdout = sys.stderr
    while True:
        try:
            fn_blob = _read_frame(stdin)
        except EOFError:
            return 0
        if not fn_blob:
            return 0
        # the second frame is protocol, not UDF work: an EOF in the
        # middle of a request means the stream is out of step, so exit
        # rather than report a UDF error and go on
        try:
            ipc = _read_frame(stdin)
        except EOFError:
            return 1
        try:
            fn = cloudpickle.loads(fn_blob)
            out = fn(_ipc_to_df(ipc))
            _write_response(stdout, 0, _df_to_ipc(out))
        except Exception:  # noqa: BLE001 — the traceback goes to the caller
            import traceback
            _write_response(stdout, 1,
                            traceback.format_exc().encode("utf-8"))


if __name__ == "__main__":
    sys.exit(main() or 0)
