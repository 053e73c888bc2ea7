"""spark_rapids_tpu_torch's kernel modules against spark_rapids_tpu's Pallas
kernels.

On the CPU each wrapper runs its plain twin; the reference runs its Pallas
kernel in interpret mode.  Inputs are made with numpy from a seed and
handed to both.  Counts must match exactly; f32 sums within rtol 1e-5
(the two accumulate in different orders).  tests/test_torch_gpu.py holds
each CUDA kernel against its plain twin on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops.grouped_window import \
    window_group_sums as ref_window_group_sums
from spark_rapids_tpu.ops.pallas_kernels import (grouped_sum_pallas,
                                                 q1_fused_pallas)
from spark_rapids_tpu_torch.models.tpch import (LINEITEM_SCHEMA,
                                                Q1_CUTOFF_DAYS,
                                                gen_lineitem_arrays)
from spark_rapids_tpu_torch.ops import grouped_window as GW
from spark_rapids_tpu_torch.ops import kernels as K

def _q1_inputs(seed, capacity):
    cols = gen_lineitem_arrays(np.random.default_rng(seed), capacity)
    return [cols[c] for c in LINEITEM_SCHEMA.names]


def _q1_both(arrays, num_rows, capacity, batch_rows):
    ref = np.asarray(q1_fused_pallas(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(num_rows),
        capacity=capacity, cutoff=Q1_CUTOFF_DAYS, batch_rows=batch_rows,
        interpret=True))
    got = K.q1_fused(*[torch.from_numpy(a) for a in arrays],
                     torch.from_numpy(np.asarray(num_rows, np.int32)),
                     capacity=capacity, cutoff=Q1_CUTOFF_DAYS,
                     batch_rows=batch_rows).numpy()
    return ref, got


def _assert_q1_equal(ref, got):
    assert got.shape == (8, 6) and got.dtype == np.float64
    np.testing.assert_array_equal(got[:, 5], ref[:, 5])
    np.testing.assert_allclose(got[:, :5], ref[:, :5], rtol=1e-5)


@pytest.mark.parametrize("case", ["stacked_4x1024", "capacity_64",
                                  "nan_in_filtered_row"])
def test_q1_fused_matches_pallas(case):
    if case == "stacked_4x1024":
        cap, batch_rows = 4096, 1024
        arrays = _q1_inputs(1, cap)
        num_rows = np.array([1024, 1000, 17, 0], np.int32)
    elif case == "capacity_64":
        cap, batch_rows = 64, 0
        arrays = _q1_inputs(2, cap)
        num_rows = np.array([37], np.int32)
    else:
        cap, batch_rows = 2048, 0
        arrays = _q1_inputs(3, cap)
        num_rows = np.array([2000], np.int32)
        price, ship = arrays[3], arrays[6]
        filtered = np.nonzero(ship > Q1_CUTOFF_DAYS)[0]
        price[filtered[:5]] = np.nan       # filtered out by shipdate
        price[2010] = np.nan               # past num_rows
        arrays[2][2020] = np.inf
    ref, got = _q1_both(arrays, num_rows, cap, batch_rows)
    assert np.isfinite(got).all()
    _assert_q1_equal(ref, got)


@pytest.mark.parametrize("n_groups,n_measures", [
    (37, 2),    # out-of-range keys, rows past num_rows
    (151, 2),   # the largest table of the lane-private tier at M = 2
])
def test_grouped_sum_matches_pallas(n_groups, n_measures):
    rng = np.random.default_rng(4)
    n, g = 1 << 11, n_groups
    keys = rng.integers(-2, g + 3, n).astype(np.int32)  # incl. out of range
    vals = [rng.random(n).astype(np.float32),
            rng.integers(0, 50, n).astype(np.float32)][:n_measures]
    nrows = n - 17
    ref_s, ref_c = grouped_sum_pallas(
        jnp.asarray(keys), tuple(jnp.asarray(v) for v in vals), nrows,
        n_groups=g, capacity=n, interpret_kernel=True)
    got_s, got_c = K.grouped_sum(torch.from_numpy(keys),
                                 [torch.from_numpy(v) for v in vals], nrows,
                                 n_groups=g, capacity=n)
    assert got_s.dtype == torch.float64 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-5)


@pytest.mark.parametrize("n_groups,n_measures,tier", [
    (26, 14, "A"),      # Q1's dictionary-lane table
    (151, 2, "A"),      # 4 lane-private warps still fit
    (152, 2, "B"),
    (300, 14, "B"),
    (3874, 14, "B"),    # one table in 227 KB
    (3875, 14, "C"),
    (32769, 14, "C"),
])
def test_grouped_sum_tier(n_groups, n_measures, tier):
    """The table layout each shape gets on an H100 (227 KB of shared
    memory a block), and the launch that goes with it."""
    assert K.grouped_sum_tier(n_groups, n_measures) == tier
    got, blocks, threads, copies, smem = K.grouped_sum_plan(
        n_groups, n_measures, 1 << 23, 132)
    assert got == tier and 0 < blocks <= 132 * 8 and threads % 32 == 0
    assert smem <= K.H100_SMEM_OPTIN
    if tier == "A":
        assert blocks == 132 and threads >= 32 * K.LANE_TABLE_MIN_WARPS
        assert smem == threads * n_groups * (n_measures + 1) * 4
    elif tier == "B":
        assert smem == copies * n_groups * (n_measures + 1) * 4


def _window_ids(case, rng, n):
    """(gid, out_cap, whether the reference's assumption holds: a sorted
    gid that grows by at most 1 per row)."""
    if case == "past_out_cap":
        return np.sort(rng.integers(0, 400, n)).astype(np.int32), 300, True
    if case == "one_run":
        return np.full(n, 7, np.int32), 100, True
    if case == "leading_minus_one":
        gid = np.sort(rng.integers(0, 700, n))
        gid[:100] = -1
        return gid.astype(np.int32), 512, False
    # gaps of 40 ids, and ids past out_cap
    return (np.arange(n) // 10 * 41).astype(np.int32), 6000, False


@pytest.mark.parametrize("case", ["past_out_cap", "one_run",
                                  "leading_minus_one", "gaps"])
def test_window_group_sums_matches_pallas(case):
    rng = np.random.default_rng(5)
    n = 1 << 11
    gid, out_cap, ref_holds = _window_ids(case, rng, n)
    vals = [rng.random(n).astype(np.float32) for _ in range(3)]
    if ref_holds:
        ref = np.asarray(ref_window_group_sums(
            jnp.asarray(gid), tuple(jnp.asarray(v) for v in vals),
            out_cap=out_cap, capacity=n, interpret_kernel=True))
    else:  # float64 sums by numpy
        keep = (gid >= 0) & (gid < out_cap)
        ref = np.stack([np.bincount(gid[keep], weights=v[keep],
                                    minlength=out_cap)[:out_cap]
                        for v in vals], axis=1)
    got = GW.window_group_sums(torch.from_numpy(gid),
                               [torch.from_numpy(v) for v in vals],
                               out_cap=out_cap, capacity=n)
    assert got.shape == (out_cap, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    present = np.zeros(out_cap, bool)
    present[gid[(gid >= 0) & (gid < out_cap)]] = True
    assert not got.numpy()[~present].any()


def test_wrapper_state_is_safe_under_eight_threads():
    """The state the wrappers reuse across launches, taken the way a
    launch takes it (under the device's launch lock), from eight threads
    at once over CPU tensors: every window_group_sums epoch is unique on
    its flag array (a grown array is new and zeroed, so its epochs start
    again), the tier-A scratch a thread holds is never swapped before its
    "launch" is done, and launch counts are exact."""
    import threading
    dev = torch.device("cpu")
    n_threads, calls = 8, 200
    epochs: list = []
    errors: list = []
    state = [0, 0, torch.zeros(1, dtype=torch.int32),
             torch.empty(0, dtype=torch.float32)]
    GW._TILE_STATE.pop((dev.index, 0), None)

    class _Wrapper:
        launches = 0

    barrier = threading.Barrier(n_threads, timeout=30)

    def worker(seed: int):
        rng = np.random.default_rng(seed)
        mine = []
        try:
            barrier.wait()
            for _ in range(calls):
                tiles = int(rng.integers(1, 3000))
                n = int(rng.integers(1, 5000))
                with K.launch_lock(dev):
                    flags, tail, epoch = GW._tile_state(dev, tiles)
                    assert flags.numel() >= tiles
                    assert tail.numel() >= tiles * K.MAX_MEASURES
                    scratch = K._lane_table_scratch(state, n)
                    assert scratch.numel() >= n
                    # the "kernel" writes its scratch: no other thread
                    # may grow it (and free this block) meanwhile
                    scratch[:n] = seed
                    assert bool((scratch[:n] == seed).all())
                    assert state[3] is scratch
                    K.count_launch(_Wrapper)
                mine.append((flags, epoch))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))
        epochs.extend(mine)

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert len(epochs) == n_threads * calls
    # the flag tensors stay alive in `epochs`, so their ids are distinct
    keys = {(id(flags), epoch) for flags, epoch in epochs}
    assert len(keys) == len(epochs), "two launches took one epoch"
    assert _Wrapper.launches == n_threads * calls
    GW._TILE_STATE.pop((dev.index, 0), None)
