"""Hand-written CUDA kernels for the engine's hot ops, with their plain
PyTorch twins (port of spark_rapids_tpu/ops/pallas_kernels.py).

Every wrapper here takes the plain version only for tensors that lie on the
CPU; for CUDA tensors it launches its kernel (csrc/*.cu, built on first
use) or raises.  Each wrapper counts its kernel launches in a plain integer
attribute (`q1_fused.launches`, `grouped_sum.launches`), so a run can show
that it went through the kernel.

Wrappers are called from several threads at once (prefetch producers,
concurrent sessions).  Every launch goes on the caller's current stream;
the state a wrapper reuses across launches (grouped_sum's tier-A ticket
and scratch, window_group_sums' tile flags) is kept per device and
stream, and taking it and enqueuing the launch happen under the device's
launch lock (`launch_lock`), so no other thread can grow and free a
scratch block between a launch's pointer and its enqueue.  Launch counts
are bumped under a lock too (`count_launch`).

With kernel attribution on (utils/kernelprof.py), each launch runs in
its kernel's catalog entry (`KP.hand_watch`, keyed by the launch's
shape), with the analytic cost `chip_smoke.py`'s `bound()` uses: the
bytes the launch must move and its f32 operations.
"""
from __future__ import annotations

import array
import contextlib
import ctypes
import threading

import torch

from spark_rapids_tpu_torch.ops import cuda_build
from spark_rapids_tpu_torch.utils import kernelprof as KP

#: rows per CUDA block in q1_fused.cu (256 threads x 32 rows); the plain
#: version takes its f32 partials over the same row ranges
Q1_BLOCK_ROWS = 8192
_Q1_SLOTS, _Q1_MEASURES = 8, 6

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = torch.float32


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


_LOCKS_LOCK = threading.Lock()
_LAUNCH_LOCKS: dict = {}  # device index -> lock
_COUNT_LOCK = threading.Lock()


def launch_lock(dev: torch.device) -> threading.Lock:
    """The lock a wrapper holds from taking its reused device state to
    enqueuing the launch that uses it (one per device)."""
    lock = _LAUNCH_LOCKS.get(dev.index)
    if lock is None:
        with _LOCKS_LOCK:
            lock = _LAUNCH_LOCKS.setdefault(dev.index, threading.Lock())
    return lock


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`, atomically with respect to other
    threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _host_rows(num_rows, capacity: int) -> int:
    """Live rows for a launch's analytic cost: the sum of `num_rows`
    where the host holds it, else `capacity` (reading a device count
    would sync)."""
    if isinstance(num_rows, torch.Tensor):
        return capacity
    if isinstance(num_rows, (list, tuple)):
        return min(capacity, sum(int(n) for n in num_rows))
    return min(capacity, int(num_rows))


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
    kw = KP.hand_watch("q1_fused", (capacity, batch_rows), dev)
    if kw.wants_cost():
        live = _host_rows(num_rows, capacity)
        # rows past num_rows[b] are padding: the kernel reads none
        kw.cost(nbytes=live * 28 + nums.numel() * 4
                + n_blocks * _Q1_SLOTS * _Q1_MEASURES * 4, flops=live * 10)
    with torch.cuda.device(dev), kw:
        err = launch(flag.data_ptr(), status.data_ptr(), qty.data_ptr(),
                     price.data_ptr(), disc.data_ptr(), tax.data_ptr(),
                     ship.data_ptr(), nums.data_ptr(), capacity,
                     batch_rows, int(cutoff), partials.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "q1_fused launch")
    count_launch(q1_fused)
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
def _chunks(items, limit: int) -> list:
    """`items` in consecutive lists of at most `limit`."""
    return [list(items[i:i + limit]) for i in range(0, len(items), limit)]


def _pointer_array(ptrs) -> array.array:
    """The device pointers as a host array of 64-bit words; pass its
    `buffer_info()[0]` and keep it alive over the call."""
    return array.array("Q", ptrs or [0])


def _raw_stream(dev: torch.device) -> int:
    """The device's current CUDA stream as an integer handle."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return get(dev.index)


def _column_pointers(what: str, n: int, dev, first, first_dtype, vals,
                     first_name: str = "keys") -> tuple[list, bool]:
    """Checks that `first` (of `first_dtype`) and every f32 in `vals` is a
    contiguous 1-D tensor of length `n` on `dev`, with a message only for
    the column at fault (the loop is on the host path of every launch).
    Returns their data pointers and whether all are 16-byte aligned."""
    shape = (n,)
    where = dev.index if dev.type == "cuda" else -1

    def fits(x, dt) -> bool:
        return (isinstance(x, torch.Tensor) and x.dtype is dt
                and x.shape == shape and x.get_device() == where
                and x.is_contiguous())

    if not fits(first, first_dtype):
        _check_column(first, first_dtype, n, dev, f"{what} {first_name}")
    ptrs = [first.data_ptr()]
    bits = ptrs[0]
    for x in vals:
        if (x.__class__ is not torch.Tensor or x.dtype is not _F32
                or x.shape != shape or x.get_device() != where
                or not x.is_contiguous()):
            for i, y in enumerate(vals):
                if not fits(y, _F32):
                    _check_column(y, _F32, n, dev, f"{what} vals[{i}]")
        p = x.data_ptr()
        ptrs.append(p)
        bits |= p
    return ptrs, bits & 15 == 0


def _device_scope(dev: torch.device):
    """The device's context, entered only when it is not current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


#: measures per launch (kMaxMeasures in grouped_sum.cu and
#: window_group_sums.cu); wider inputs take several launches
MAX_MEASURES = 64
#: shared memory one block may opt into on an H100 (227 KB)
H100_SMEM_OPTIN = 232_448
#: warps per block of the lane-private tier: at least this many, at most 8
LANE_TABLE_MIN_WARPS = 4
_WARPS = 8  # tiers B and C run 256-thread blocks

# (device index, stream) -> [SM count, opt-in smem per block, tier-A
# ticket (int32 [1], zeroed once; each launch leaves it at 0), tier-A
# partial scratch]
_GS_DEVICE: dict = {}
_ROW_COUNTS: dict = {}  # (device index, stream, n) -> int32 [1] holding n


def grouped_sum_tier(n_groups: int, n_measures: int,
                     smem_optin: int = H100_SMEM_OPTIN) -> str:
    """Which table layout grouped_sum.cu uses for a [n_groups,
    n_measures + 1] table: "A" lane-private copies (4 warps' worth fit in
    shared memory), "B" one copy per warp or block (one copy fits), "C"
    the global table (past shared memory)."""
    table = n_groups * (n_measures + 1) * 4
    if table * 32 * LANE_TABLE_MIN_WARPS <= smem_optin:
        return "A"
    if table <= smem_optin:
        return "B"
    return "C"


def grouped_sum_plan(n_groups: int, n_measures: int, capacity: int,
                     sms: int, smem_optin: int = H100_SMEM_OPTIN) -> tuple:
    """(tier, blocks, threads, table copies, dynamic shared bytes) of one
    grouped_sum.cu launch."""
    tier = grouped_sum_tier(n_groups, n_measures, smem_optin)
    table = n_groups * (n_measures + 1) * 4
    if tier == "A":
        # one persistent block per SM, fewer when there are few rows
        warps = min(_WARPS, smem_optin // (table * 32))
        blocks = min(sms, -(-capacity // (warps * 32 * 8)))
        return tier, blocks, warps * 32, warps * 32, warps * 32 * table
    threads = _WARPS * 32
    if tier == "B":
        copies = min(_WARPS, smem_optin // table)
        per_sm = max(1, min(_WARPS, (smem_optin + 1024)
                            // (copies * table + 1024)))
        blocks = min(sms * per_sm, -(-capacity // (threads * 4)))
        return tier, blocks, threads, copies, copies * table
    return tier, min(sms * _WARPS, -(-capacity // threads)), threads, 0, 0


def _grouped_sum_device(dev: torch.device, stream: int) -> list:
    """The (`dev`, `stream`) entry of _GS_DEVICE, made on first use;
    making it also raises the kernels' shared-memory limit on that device.
    Launches on one stream reuse the ticket and scratch in turn; the
    caller holds launch_lock(dev)."""
    state = _GS_DEVICE.get((dev.index, stream))
    if state is None:
        init = cuda_build.function("grouped_sum", "grouped_sum_init",
                                   [ctypes.POINTER(ctypes.c_int)] * 2)
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            cuda_build.check(init(ctypes.byref(sms), ctypes.byref(smem)),
                             "grouped_sum init")
        state = _GS_DEVICE[(dev.index, stream)] = [
            sms.value, smem.value,
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.float32, device=dev)]
    return state


def _lane_table_scratch(state: list, n: int) -> torch.Tensor:
    if state[3].numel() < n:
        state[3] = torch.empty(n, dtype=state[3].dtype,
                               device=state[3].device)
    return state[3]


_TIER_CODE = {"A": 0, "B": 1, "C": 2}


def _row_count(n, dev, stream: int) -> torch.Tensor:
    """`num_rows` as an int32 [1] on the device; a Python int is filled
    once per device, stream and value and then reused (kernels only read
    it)."""
    if isinstance(n, torch.Tensor):
        return _int32_vector(n, dev)
    key = (dev.index, stream, int(n))
    t = _ROW_COUNTS.get(key)
    if t is None:
        if len(_ROW_COUNTS) >= 256:
            _ROW_COUNTS.clear()
        t = _ROW_COUNTS[key] = _int32_vector(int(n), dev)
    return t


def grouped_sum(keys, vals, num_rows, *, n_groups: int, capacity: int):
    """Sums and counts per dictionary key id: `keys` int32 [capacity] in
    [0, n_groups), `vals` a sequence of f32 [capacity].  Rows at or past
    `num_rows`, and rows whose key is out of range, are dropped.  Returns
    ([n_groups, len(vals)] float64 sums of f32 accumulations, [n_groups]
    int32 counts, exact).  On the card, tiers A and B (see
    grouped_sum_tier) give the same bits on every call."""
    dev = keys.device
    ptrs, vec = _column_pointers("grouped_sum", capacity, dev, keys,
                                 torch.int32, vals)
    if n_groups <= 0:
        raise ValueError(f"grouped_sum: n_groups {n_groups} must be > 0")
    if not _on_cuda(dev, "grouped_sum"):
        return grouped_sum_plain(keys, vals, _int32_vector(num_rows, dev),
                                 n_groups=n_groups, capacity=capacity)
    launch = cuda_build.function(
        "grouped_sum", "grouped_sum_launch",
        [_INT, _VP, _VP, _INT, _VP, _INT, _INT, _INT, _INT, _INT, _INT,
         _INT, _VP, _INT, _VP, _INT, _VP, _VP, _VP])
    stream = _raw_stream(dev)
    m = len(ptrs) - 1
    sums = torch.empty((n_groups, m), dtype=torch.float64, device=dev)
    counts, tiers, off = None, [], 0
    with _device_scope(dev), launch_lock(dev):
        state = _grouped_sum_device(dev, stream)
        sms, smem_optin, ticket = state[0], state[1], state[2]
        nrows = _row_count(num_rows, dev, stream)
        for chunk in _chunks(ptrs[1:], MAX_MEASURES) or [[]]:
            mc = len(chunk)
            ptr_array = _pointer_array(chunk)
            tier, blocks, threads, copies, smem = grouped_sum_plan(
                n_groups, mc, capacity, sms, smem_optin)
            cnt = None
            if tier == "A":
                # per-block rows padded to a multiple of 4 floats
                scratch = _lane_table_scratch(
                    state, blocks * (-(-n_groups * (mc + 1) // 4) * 4))
                stride = 0
                if counts is None:
                    cnt = counts = torch.empty(n_groups, dtype=torch.int32,
                                               device=dev)
            elif tier == "B":
                scratch = torch.empty((blocks, n_groups, mc + 1),
                                      dtype=torch.float32, device=dev)
                stride = 0
            else:
                stride = max(4, -(-mc // 4) * 4)
                scratch = torch.zeros((n_groups, stride),
                                      dtype=torch.float32, device=dev)
                if counts is None:
                    cnt = counts = torch.zeros(n_groups, dtype=torch.int32,
                                               device=dev)
            kw = KP.hand_watch("grouped_sum",
                               (capacity, n_groups, mc, tier), dev)
            if kw.wants_cost():
                rows = _host_rows(num_rows, capacity)
                kw.cost(nbytes=capacity * 4 + rows * mc * 4
                        + n_groups * (mc + 1) * 4, flops=rows * (mc + 1))
            with kw:
                err = launch(_TIER_CODE[tier], ptrs[0],
                             ptr_array.buffer_info()[0], mc,
                             nrows.data_ptr(), capacity, n_groups, blocks,
                             threads, copies, smem, int(vec),
                             scratch.data_ptr(), stride,
                             sums.data_ptr() + 8 * off, max(m, 1),
                             None if cnt is None else cnt.data_ptr(),
                             ticket.data_ptr(), stream)
            cuda_build.check(err, "grouped_sum launch")
            count_launch(grouped_sum)
            tiers.append(tier)
            if tier == "B":
                # float64 combine of the per-block partials; counts exact
                sums[:, off:off + mc] = torch.sum(
                    scratch[:, :, :mc], dim=0, dtype=torch.float64)
                if counts is None:
                    counts = torch.sum(scratch.view(torch.int32)[:, :, mc],
                                       dim=0, dtype=torch.int32)
            elif tier == "C":
                sums[:, off:off + mc] = scratch[:, :mc]
            off += mc
    grouped_sum.last_tiers = tiers
    return sums, counts


grouped_sum.launches = 0
grouped_sum.last_tiers = None


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
