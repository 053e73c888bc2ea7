"""Trace annotation (port of spark_rapids_tpu/utils/tracing.py; the
reference plugin's NVTX ranges, `NvtxWithMetrics.scala:27`).

On a CUDA query `annotation(name)` pushes an NVTX range
(`torch.cuda.nvtx.range_push`/`range_pop`), which Nsight Systems and
`torch.profiler` captures show beside the card's kernels; on the CPU it
is a `torch.profiler.record_function` range.  The query's device is the
one its QueryContext was admitted on (exec/scheduler.py); a thread with
no query annotates for the CPU.  Nothing is caught: on a CUDA query an
NVTX call that raises fails the caller, so a broken annotation cannot
hide the card.  (With no tool attached NVTX records nothing and
`range_push` returns a negative depth; that is NVTX's no-op, not an
error.)  `trace_with_metrics` also feeds an operator metric, as the
reference's NvtxWithMetrics feeds a SQLMetric, and the per-query span
tracer (utils/profile.py) emits every span through `annotation`.

Left out: the reference's `start_profiler_server` starts JAX's remote
profiler service for xprof; torch has no such in-process server (its
profiler is driven from inside the program, and Nsight attaches from
outside), so the port has no counterpart.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class _NvtxRange:
    """One NVTX push/pop pair."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        torch.cuda.nvtx.range_push(self._name)
        return self

    def __exit__(self, *exc):
        torch.cuda.nvtx.range_pop()
        return False


def query_device_is_cuda() -> bool:
    """True when the calling thread's query runs on a CUDA device."""
    from spark_rapids_tpu_torch.exec import scheduler as S
    qc = S.current()
    dev = getattr(qc, "device", None) if qc is not None else None
    return dev is not None and torch.device(dev).type == "cuda"


def annotation(name: str, cuda=None):
    """An NVTX range for `name` on a CUDA query (`cuda=None` asks the
    calling thread's query), else a `torch.profiler.record_function`
    range."""
    if cuda is None:
        cuda = query_device_is_cuda()
    if cuda:
        return _NvtxRange(name)
    return torch.profiler.record_function(name)


@contextmanager
def trace_range(name: str):
    with annotation(name):
        yield


@contextmanager
def trace_with_metrics(name: str, metrics, metric_name: str):
    t0 = time.perf_counter_ns()
    with trace_range(name):
        try:
            yield
        finally:
            metrics.add(metric_name, time.perf_counter_ns() - t0)
