"""Hand-written CUDA kernels for the engine's hot ops, with their plain
PyTorch twins (port of spark_rapids_tpu/ops/pallas_kernels.py).

Every wrapper here takes the plain version only for tensors that lie on the
CPU; for CUDA tensors it launches its kernel (csrc/*.cu, built on first
use) or raises.  Each wrapper counts its kernel launches in a plain integer
attribute (`q1_fused.launches`, `grouped_sum.launches`), so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from spark_rapids_tpu_torch.ops import cuda_build

#: rows per CUDA block in q1_fused.cu (256 threads x 32 rows); the plain
#: version takes its f32 partials over the same row ranges
Q1_BLOCK_ROWS = 8192
_Q1_SLOTS, _Q1_MEASURES = 8, 6

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _check_column(x: torch.Tensor, dtype: torch.dtype, n: int, dev,
                  what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype or x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{what}: expected {dtype}[{n}], got "
                         f"{x.dtype}{list(x.shape)}")
    if x.device != dev:
        raise ValueError(f"{what}: on {x.device}, expected {dev}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _int32_vector(n, dev) -> torch.Tensor:
    """A row count (Python int or tensor) as a contiguous int32 vector on
    `dev` — never read back to the host."""
    if isinstance(n, torch.Tensor):
        if n.device != dev:
            raise ValueError(f"num_rows on {n.device}, expected {dev}")
        return n.to(torch.int32).reshape(-1).contiguous()
    # a fill kernel, not a host-to-device copy (which would wait for the
    # stream)
    return torch.full((1,), int(n), dtype=torch.int32, device=dev)


def _on_cuda(dev: torch.device, what: str) -> bool:
    """True for CUDA tensors, False for CPU ones (the plain version's
    only use); anything else raises."""
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {dev}")


# ---------------------------------------------------------------------------
# TPC-H Q1 in one pass
def q1_fused(flag, status, qty, price, disc, tax, ship, num_rows, *,
             capacity: int, cutoff: int, batch_rows: int = 0
             ) -> torch.Tensor:
    """TPC-H Q1 scan -> filter -> project -> group-reduce in one pass.

    `batch_rows` > 0 runs the STACKED multi-batch form: the columns hold
    B = capacity // batch_rows batches back to back and `num_rows` is a
    (B,) vector.  Returns the (8, 6) float64 table: rows are the group
    slots flag*2+status (6 and 7 are zero padding), columns the sums of
    qty, price, disc_price, charge and disc, and the count.  Per-block f32
    partials are combined in float64."""
    if batch_rows <= 0:
        batch_rows = capacity
    if capacity <= 0 or capacity % batch_rows or capacity >= 1 << 31:
        raise ValueError(f"capacity {capacity} must be a positive multiple "
                         f"of batch_rows {batch_rows} below 2^31")
    dev = flag.device
    for x, dt, nm in ((flag, torch.int32, "flag"),
                      (status, torch.int32, "status"),
                      (qty, torch.float32, "qty"),
                      (price, torch.float32, "price"),
                      (disc, torch.float32, "disc"),
                      (tax, torch.float32, "tax"),
                      (ship, torch.int32, "ship")):
        _check_column(x, dt, capacity, dev, f"q1_fused {nm}")
    nums = _int32_vector(num_rows, dev)
    if nums.numel() != capacity // batch_rows:
        raise ValueError(f"q1_fused: num_rows has {nums.numel()} entries "
                         f"for {capacity // batch_rows} batches")
    if not _on_cuda(dev, "q1_fused"):
        return q1_fused_plain(flag, status, qty, price, disc, tax, ship,
                              nums, capacity=capacity, cutoff=cutoff,
                              batch_rows=batch_rows)
    launch = cuda_build.function(
        "q1_fused", "q1_fused_launch",
        [_VP] * 8 + [_INT, _INT, _INT, _VP, _VP])
    n_blocks = -(-capacity // Q1_BLOCK_ROWS)
    partials = torch.empty((n_blocks, _Q1_SLOTS, _Q1_MEASURES),
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(flag.data_ptr(), status.data_ptr(), qty.data_ptr(),
                     price.data_ptr(), disc.data_ptr(), tax.data_ptr(),
                     ship.data_ptr(), nums.data_ptr(), capacity,
                     batch_rows, int(cutoff), partials.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "q1_fused launch")
    q1_fused.launches += 1
    return partials.to(torch.float64).sum(dim=0)


q1_fused.launches = 0


def q1_fused_plain(flag, status, qty, price, disc, tax, ship, num_rows, *,
                   capacity: int, cutoff: int, batch_rows: int
                   ) -> torch.Tensor:
    """Plain PyTorch twin of `q1_fused` (same contract; f32 partials over
    the kernel's Q1_BLOCK_ROWS row ranges, combined in float64)."""
    dev = flag.device
    row = torch.arange(capacity, device=dev)
    batch = row // batch_rows
    keep = ((row - batch * batch_rows)
            < num_rows.to(torch.int64)[batch]) & (ship <= cutoff)
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    gid = flag * 2 + status
    # a select, not a multiply: NaN in a filtered row must not reach a sum
    in_table = keep & (gid >= 0) & (gid < 6)
    slot = torch.where(in_table, gid, 7).to(torch.int64)
    vals = torch.stack([qty, price, disc_price, charge, disc,
                        torch.ones_like(qty)], dim=1)
    vals = torch.where(in_table[:, None], vals, 0.0)
    n_blocks = -(-capacity // Q1_BLOCK_ROWS)
    acc = torch.zeros((n_blocks * _Q1_SLOTS, _Q1_MEASURES),
                      dtype=torch.float32, device=dev)
    acc.index_add_(0, (row // Q1_BLOCK_ROWS) * _Q1_SLOTS + slot, vals)
    table = acc.view(n_blocks, _Q1_SLOTS, _Q1_MEASURES).to(
        torch.float64).sum(dim=0)
    table[6:] = 0.0
    return table


def build_q1_kernel_fused(capacity: int, cutoff: int):
    """Drop-in alternative to models.tpch.build_q1_kernel with the same
    output contract, backed by `q1_fused`."""

    def q1_step(flag, status, qty, extprice, disc, tax, shipdate,
                num_rows):
        table = q1_fused(flag, status, qty, extprice, disc, tax, shipdate,
                         num_rows, capacity=capacity, cutoff=cutoff).T
        g = torch.arange(8, device=table.device)
        cnt = table[5].to(torch.int32)
        return (g // 2, g % 2, table[0], table[1], table[2], table[3],
                table[4], cnt)

    return q1_step


# ---------------------------------------------------------------------------
# grouped sum/count over dictionary key ids
def _measure_chunks(vals, limit: int):
    return [list(vals[i:i + limit]) for i in range(0, len(vals), limit)]


def _pointer_array(tensors):
    return (_VP * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


#: measures per launch (kMaxMeasures in grouped_sum.cu and
#: window_group_sums.cu); wider inputs take several launches
MAX_MEASURES = 64


def grouped_sum(keys, vals, num_rows, *, n_groups: int, capacity: int):
    """Sums and counts per dictionary key id: `keys` int32 [capacity] in
    [0, n_groups), `vals` a sequence of f32 [capacity].  Rows at or past
    `num_rows`, and rows whose key is out of range, are dropped.  Returns
    ([n_groups, len(vals)] float64 sums of f32 accumulations, [n_groups]
    int32 counts, exact)."""
    dev = keys.device
    _check_column(keys, torch.int32, capacity, dev, "grouped_sum keys")
    for i, v in enumerate(vals):
        _check_column(v, torch.float32, capacity, dev,
                      f"grouped_sum vals[{i}]")
    if n_groups <= 0:
        raise ValueError(f"grouped_sum: n_groups {n_groups} must be > 0")
    nrows = _int32_vector(num_rows, dev)
    if not _on_cuda(dev, "grouped_sum"):
        return grouped_sum_plain(keys, vals, nrows, n_groups=n_groups,
                                 capacity=capacity)
    launch = cuda_build.function(
        "grouped_sum", "grouped_sum_launch",
        [_VP, _VP, _INT, _VP, _INT, _INT, _VP, _INT, _VP,
         ctypes.POINTER(ctypes.c_int), _VP])
    m = len(vals)
    sums = torch.zeros((n_groups, m), dtype=torch.float32, device=dev)
    counts = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    used_shared = ctypes.c_int(0)
    chunks = _measure_chunks(list(vals), MAX_MEASURES) or [[]]
    off = 0
    for ci, chunk in enumerate(chunks):
        out = sums[:, off:] if m else sums
        with torch.cuda.device(dev):
            err = launch(keys.data_ptr(), _pointer_array(chunk), len(chunk),
                         nrows.data_ptr(), capacity, n_groups,
                         out.data_ptr(), max(m, 1),
                         counts.data_ptr() if ci == 0 else None,
                         ctypes.byref(used_shared), stream)
        cuda_build.check(err, "grouped_sum launch")
        grouped_sum.launches += 1
        off += len(chunk)
    grouped_sum.last_used_shared = bool(used_shared.value)
    return sums.to(torch.float64), counts


grouped_sum.launches = 0
grouped_sum.last_used_shared = None


#: rows per f32 partial table in grouped_sum_plain
GROUPED_SUM_BLOCK_ROWS = 1 << 14


def grouped_sum_plain(keys, vals, num_rows, *, n_groups: int,
                      capacity: int):
    """Plain PyTorch twin of `grouped_sum`: counts by bincount; sums by
    f32 index_add_ into one partial table per GROUPED_SUM_BLOCK_ROWS rows
    (bounding each f32 accumulation the way the kernel's per-block tables
    do), then an f32 sum over the partials."""
    dev = keys.device
    row = torch.arange(capacity, device=dev)
    k = torch.where(row < num_rows.reshape(-1)[0], keys, n_groups)
    in_range = (k >= 0) & (k < n_groups)
    seg = torch.where(in_range, k, n_groups).to(torch.int64)
    counts = torch.bincount(seg, minlength=n_groups + 1)[:n_groups].to(
        torch.int32)
    if not vals:
        return torch.zeros((n_groups, 0), dtype=torch.float64,
                           device=dev), counts
    stacked = torch.where(in_range[:, None], torch.stack(list(vals), 1),
                          0.0)
    n_blocks = -(-capacity // GROUPED_SUM_BLOCK_ROWS)
    slot = (row // GROUPED_SUM_BLOCK_ROWS) * (n_groups + 1) + seg
    partials = torch.zeros((n_blocks * (n_groups + 1), len(vals)),
                           dtype=torch.float32, device=dev)
    partials.index_add_(0, slot, stacked)
    sums = partials.view(n_blocks, n_groups + 1, len(vals)).sum(dim=0)
    return sums[:n_groups].to(torch.float64), counts
