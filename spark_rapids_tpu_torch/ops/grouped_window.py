"""Per-group sums over key-SORTED rows — the high-cardinality grouper of
the aggregate's banded lane (port of spark_rapids_tpu/ops/grouped_window.py).

With rows sorted by group, the group id `gid` is non-decreasing, so each
group's rows are one contiguous run.  The CUDA kernel
(csrc/window_group_sums.cu) reduces each run inside a warp and adds it to
the output with one atomic per measure; the plain twin uses index_add_.
Accumulation is f32: callers gate exactness the dictionary lane's way
(|v| certificate for integers, variableFloatAgg for floats) and recover
group keys from 11-bit first-row-index limb measures, which are exact by
construction (one non-zero per group).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.ops import cuda_build
from spark_rapids_tpu_torch.ops.kernels import (
    _INT, _VP, MAX_MEASURES, _check_column, _measure_chunks, _on_cuda,
    _pointer_array)


def window_group_sums(gid, vals, *, out_cap: int, capacity: int
                      ) -> torch.Tensor:
    """Per-group f32 sums of `vals` (sequence of f32 [capacity], already
    zeroed on invalid rows) over non-decreasing int32 group ids `gid`
    (rows past the last group may repeat its id).  Returns [out_cap,
    len(vals)] f32; groups at or past out_cap, and negative ids, are
    dropped — callers pair this with a `num_groups > out_cap` check."""
    dev = gid.device
    _check_column(gid, torch.int32, capacity, dev, "window_group_sums gid")
    for i, v in enumerate(vals):
        _check_column(v, torch.float32, capacity, dev,
                      f"window_group_sums vals[{i}]")
    m = len(vals)
    if m == 0:
        return torch.zeros((out_cap, 0), dtype=torch.float32, device=dev)
    if not _on_cuda(dev, "window_group_sums"):
        return window_group_sums_plain(gid, vals, out_cap=out_cap)
    launch = cuda_build.function(
        "window_group_sums", "window_group_sums_launch",
        [_VP, _VP, _INT, _INT, _INT, _VP, _INT, _VP])
    out = torch.zeros((out_cap, m), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    off = 0
    for chunk in _measure_chunks(list(vals), MAX_MEASURES):
        with torch.cuda.device(dev):
            err = launch(gid.data_ptr(), _pointer_array(chunk), len(chunk),
                         capacity, out_cap, out[:, off:].data_ptr(), m,
                         stream)
        cuda_build.check(err, "window_group_sums launch")
        window_group_sums.launches += 1
        off += len(chunk)
    return out


window_group_sums.launches = 0


def window_group_sums_plain(gid, vals, *, out_cap: int) -> torch.Tensor:
    """Plain PyTorch twin of `window_group_sums` (f32 index_add_)."""
    keep = (gid >= 0) & (gid < out_cap)
    seg = torch.where(keep, gid, out_cap).to(torch.int64)
    stacked = torch.stack(list(vals), dim=1)
    out = torch.zeros((out_cap + 1, len(vals)), dtype=torch.float32,
                      device=gid.device).index_add_(0, seg, stacked)
    return out[:out_cap]
