"""Per-group sums over key-SORTED rows — the high-cardinality grouper of
the aggregate's banded lane (port of spark_rapids_tpu/ops/grouped_window.py).

With rows sorted by group, the group id `gid` is non-decreasing, so each
group's rows are one contiguous run.  The CUDA kernel
(csrc/window_group_sums.cu) reduces each run inside a 1,024-row tile and
stores it once; a run that crosses tiles is summed, in tile order, by the
tile where it ends, from partials that the earlier tiles flag as ready.
Absent ids are written as 0, so no cell is zero-filled first or added to
with an atomic.  The plain twin uses index_add_.
Accumulation is f32: callers gate exactness the dictionary lane's way
(|v| certificate for integers, variableFloatAgg for floats) and recover
group keys from 11-bit first-row-index limb measures, which are exact by
construction (one non-zero per group).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.ops import cuda_build
from spark_rapids_tpu_torch.ops.kernels import (
    _INT, _VP, MAX_MEASURES, _chunks, _column_pointers, _device_scope,
    _on_cuda, _pointer_array, _raw_stream)

#: rows per block of csrc/window_group_sums.cu (kTileRows)
WINDOW_TILE_ROWS = 1024

# device index -> [int32 tile flags, f32 tail partials, last epoch]
_TILE_STATE: dict = {}


def _tile_state(dev: torch.device, tiles: int) -> tuple:
    """The device's tile flags and tail-partial scratch (room for `tiles`
    tiles of MAX_MEASURES) and a new epoch for one launch.  The flags are
    zeroed only when they are made, and every launch flags with an epoch
    no earlier launch used; launches on one stream reuse both in turn."""
    state = _TILE_STATE.get(dev.index)
    if state is None or state[0].numel() < tiles or state[2] >= 2**31 - 2:
        size = max(tiles, 1024 if state is None else 2 * state[0].numel())
        state = _TILE_STATE[dev.index] = [
            torch.zeros(size, dtype=torch.int32, device=dev),
            torch.empty(size * MAX_MEASURES, dtype=torch.float32,
                        device=dev), 0]
    state[2] += 1
    return state[0], state[1], state[2]


def window_group_sums(gid, vals, *, out_cap: int, capacity: int
                      ) -> torch.Tensor:
    """Per-group f32 sums of `vals` (sequence of f32 [capacity], already
    zeroed on invalid rows) over non-decreasing int32 group ids `gid`
    (rows past the last group may repeat its id; ids may skip values).
    Returns [out_cap, len(vals)] f32, 0 for absent ids; groups at or past
    out_cap, and negative ids, are dropped — callers pair this with a
    `num_groups > out_cap` check.  On the card every call gives the same
    bits."""
    dev = gid.device
    ptrs, vec = _column_pointers("window_group_sums", capacity, dev, gid,
                                 torch.int32, vals, first_name="gid")
    m = len(vals)
    if m == 0:
        return torch.zeros((out_cap, 0), dtype=torch.float32, device=dev)
    if not _on_cuda(dev, "window_group_sums"):
        return window_group_sums_plain(gid, vals, out_cap=out_cap)
    launch = cuda_build.function(
        "window_group_sums", "window_group_sums_launch",
        [_VP, _VP, _INT, _INT, _INT, _VP, _INT, _VP, _VP, _INT, _INT, _VP])
    # every cell is written by the kernel: no zero fill
    out = torch.empty((out_cap, m), dtype=torch.float32, device=dev)
    tiles = -(-capacity // WINDOW_TILE_ROWS)
    stream = _raw_stream(dev)
    out_ptr = out.data_ptr()
    off = 0
    with _device_scope(dev):
        for chunk in _chunks(ptrs[1:], MAX_MEASURES):
            ptr_array = _pointer_array(chunk)
            flags, tail, epoch = _tile_state(dev, tiles)
            err = launch(ptrs[0], ptr_array.buffer_info()[0], len(chunk),
                         capacity, out_cap, out_ptr + 4 * off, m,
                         tail.data_ptr(), flags.data_ptr(), epoch, int(vec),
                         stream)
            cuda_build.check(err, "window_group_sums launch")
            window_group_sums.launches += 1
            off += len(chunk)
    return out


window_group_sums.launches = 0


def window_group_sums_plain(gid, vals, *, out_cap: int) -> torch.Tensor:
    """Plain PyTorch twin of `window_group_sums` (index_add_ in the
    measures' dtype: f32 as the kernel takes them, or float64 for an
    oracle whose order of addition does not show)."""
    keep = (gid >= 0) & (gid < out_cap)
    seg = torch.where(keep, gid, out_cap).to(torch.int64)
    stacked = torch.stack(list(vals), dim=1)
    out = torch.zeros((out_cap + 1, len(vals)), dtype=stacked.dtype,
                      device=gid.device).index_add_(0, seg, stacked)
    return out[:out_cap]
