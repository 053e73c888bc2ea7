"""spark_rapids_tpu_torch's CUDA kernels against their plain PyTorch twins
on an NVIDIA card.  Skips without one (a CUDA kernel has no CPU mode).

This file imports neither JAX nor spark_rapids_tpu, so it also runs on a
GPU machine without them:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.models.tpch import (LINEITEM_SCHEMA,
                                                Q1_CUTOFF_DAYS,
                                                gen_lineitem_arrays)
from spark_rapids_tpu_torch.ops import grouped_window as GW
from spark_rapids_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain(cuda_device):
    """Each CUDA kernel against its plain twin on the card (counts exact,
    f32 sums rtol 1e-5 over these small shapes)."""
    dev = cuda_device
    cols = gen_lineitem_arrays(np.random.default_rng(6), 1 << 16)
    # NaN in a padding row (batch 1 holds 100 rows) and in a filtered row
    # must reach no sum
    cols["l_quantity"][(1 << 14) + 200] = np.nan
    cut = np.flatnonzero(cols["l_shipdate"][:1 << 14] > Q1_CUTOFF_DAYS)[0]
    cols["l_extendedprice"][cut] = np.nan
    arrays = [torch.from_numpy(cols[n]).to(dev)
              for n in LINEITEM_SCHEMA.names]
    nums = torch.tensor([1 << 14, 100, 0, 5000], dtype=torch.int32,
                        device=dev)
    before = K.q1_fused.launches
    got = K.q1_fused(*arrays, nums, capacity=1 << 16, cutoff=Q1_CUTOFF_DAYS,
                     batch_rows=1 << 14)
    want = K.q1_fused_plain(*arrays, nums, capacity=1 << 16,
                            cutoff=Q1_CUTOFF_DAYS, batch_rows=1 << 14)
    assert K.q1_fused.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, 5], want[:, 5], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)

    gen = torch.Generator(device=dev).manual_seed(7)
    n = 1 << 16
    vals = [torch.rand(n, generator=gen, device=dev) for _ in range(3)]
    for g in (37, 40000):  # shared-memory and global-atomics branches
        keys = torch.randint(-2, g + 3, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        s, c = K.grouped_sum(keys, vals, n - 9, n_groups=g, capacity=n)
        ws, wc = K.grouped_sum_plain(
            keys, vals, torch.full((1,), n - 9, dtype=torch.int32,
                                   device=dev), n_groups=g, capacity=n)
        assert K.grouped_sum.last_used_shared == (g == 37)
        torch.testing.assert_close(c, wc, rtol=0, atol=0)
        torch.testing.assert_close(s, ws, rtol=1e-5, atol=1e-9)

    gid = torch.sort(torch.randint(-1, 5000, (n,), generator=gen,
                                   device=dev))[0].to(torch.int32)
    got = GW.window_group_sums(gid, vals, out_cap=4000, capacity=n)
    want = GW.window_group_sums_plain(gid, vals, out_cap=4000)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
