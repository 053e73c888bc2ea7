"""The port's twin of the repository's `__graft_entry__.py` entry
points.

entry():             the single-batch TPC-H Q1 step: Q1's scan, filter,
                     project and group-reduce over one 2,048-row lineitem
                     batch through `models/tpch.py build_q1_kernel` (the
                     q1_fused CUDA kernel backs it under
                     spark.rapids.tpu.pallas.q1.enabled).
dryrun_multichip(n): the distributed query step over an n-slot mesh:
                     per-slot scan -> filter/project -> murmur3 all-to-all
                     over the mesh -> per-slot group-by-sum (the
                     grouped_sum kernel) and the murmur3 hash-grouping
                     lane, checked in numpy.

The reference's version provisions a virtual CPU mesh of JAX devices and
routes around broken accelerator plugins; a single-controller torch mesh
needs none of that.  Both run on the card unless the caller passes
device="cpu"; "cuda" without a card raises.
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, args): the Q1 step and its arguments, as the reference's
    `entry()` returns them."""
    from spark_rapids_tpu_torch.models.tpch import build_q1_kernel, gen_lineitem
    batch = gen_lineitem(np.random.default_rng(0), 2048, device=device)
    fn = build_q1_kernel(batch.capacity, device=batch.device)
    args = tuple(batch.column(n).data for n in (
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate")) + (
        torch.tensor(batch.num_rows, dtype=torch.int32, device=batch.device),)
    return fn, args


def dryrun_mesh(n_devices: int, device="cuda"):
    """An n-slot mesh over the visible devices of `device`'s type, with
    as many slots per device as it takes."""
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    kind = torch.device(device).type
    visible = (torch.cuda.device_count()
               if kind == "cuda" and torch.cuda.is_available() else 1)
    return make_mesh(n_devices, device=device,
                     slots_per_device=-(-n_devices // visible))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the distributed step over an n-slot mesh and check it in
    numpy: rows conserved, every key's sum and count equal to the golden,
    the hash-grouping lane's group count exact and collision-free.
    Returns the step's figures."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.vector import ColumnVector
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.ops.sort_encode import hash_sort_bounds
    from spark_rapids_tpu_torch.parallel.collective_exchange import (
        exchange_local, stack_batches)

    mesh = dryrun_mesh(n_devices, device)
    n = mesh.size
    schema = T.Schema.of(("k", T.INT64), ("v", T.FLOAT32))
    cap = 64
    rng = np.random.default_rng(0)
    np_cols = [{"k": rng.integers(0, 37, 48).astype(np.int64),
                "v": rng.normal(size=48).astype(np.float32)}
               for _ in range(n)]
    expected = sum(int((c["v"] > -3.0).sum()) for c in np_cols)
    batches = [ColumnarBatch.from_numpy(c, schema, capacity=cap,
                                        device=mesh.home) for c in np_cols]
    ((kd, kv, _), (vd, vv, _)), num_rows = stack_batches(batches, cap)
    dev = kd.device
    # per-slot filter (v > -3) and project (v * 2), compacted in row order
    live = torch.arange(cap, device=dev)[None, :] < num_rows[:, None]
    keep = live & (vd > -3.0) & vv
    cnt = keep.sum(1).to(torch.int32)
    idx = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    ok = torch.arange(cap, device=dev)[None, :] < cnt[:, None]
    local = [(torch.gather(kd, 1, idx), torch.gather(kv, 1, idx) & ok, None),
             (torch.gather(vd, 1, idx) * 2.0, torch.gather(vv, 1, idx) & ok,
              None)]
    # every slot may receive every row: the worst-case receive capacity
    out_cap = n * cap
    ((ekd, ekv, _), (evd, _, _)), total = exchange_local(
        local, cnt, schema, (0,), mesh, cap, out_cap=out_cap)
    launches0 = K.grouped_sum.launches
    sums = np.zeros(38)
    cnts = np.zeros(38, np.int64)
    got_groups, collided = 0, False
    for d in range(n):
        valid = torch.arange(out_cap, device=dev) < total[d]
        gid = torch.where(valid & ekv[d], ekd[d] % 37, 37).to(torch.int32)
        s, c = K.grouped_sum(gid, [evd[d]], total[d], n_groups=38,
                             capacity=out_cap)
        sums += s[:, 0].cpu().numpy()
        cnts += c.cpu().numpy()
        # the engine's murmur3 hash-grouping lane on the received rows:
        # equal keys share a slot after the exchange, so the slots'
        # distinct-group counts add up to the global count
        _perm, _sv, bounds, coll = hash_sort_bounds(
            [(ColumnVector(T.INT64, ekd[d], ekv[d] & valid), True, True)],
            valid)
        got_groups += int(bounds.sum())
        collided |= bool(coll)
    total_rows = int(total.sum())
    assert total_rows == expected, (total_rows, expected)
    kept_keys = np.concatenate([c["k"][c["v"] > -3.0] for c in np_cols])
    kept_vals = np.concatenate([c["v"][c["v"] > -3.0] for c in np_cols])
    exp_sums = np.zeros(38)
    np.add.at(exp_sums, kept_keys % 37,
              kept_vals.astype(np.float32) * np.float32(2.0))
    np.testing.assert_allclose(sums, exp_sums, rtol=1e-4, atol=1e-4)
    exp_cnts = np.bincount(kept_keys % 37, minlength=38)
    np.testing.assert_array_equal(cnts[:37], exp_cnts[:37])
    expected_groups = len(np.unique(kept_keys))
    assert got_groups == expected_groups, (got_groups, expected_groups)
    assert not collided, "hash-grouping collision"
    print(f"dryrun_multichip({n}): exchanged {total_rows} rows across "
          f"{n}-slot mesh over {len(mesh.groups)} device(s), groupby-sums "
          f"exact, hash-grouping lane {got_groups} groups OK")
    return {"slots": n, "devices": len(mesh.groups), "rows": total_rows,
            "groups": got_groups,
            "grouped_sum_launches": K.grouped_sum.launches - launches0}


if __name__ == "__main__":
    dryrun_multichip(8, device="cpu")
    fn, args = entry(device="cpu")
    print("entry(): q1 step,", len(fn(*args)), "output columns")
