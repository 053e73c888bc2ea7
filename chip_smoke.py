#!/usr/bin/env python3
"""GPU smoke run of spark_rapids_tpu_torch: TPC-H Q1 and Q6 at scale factor 10
(59,986,052 lineitem rows, TPC-H spec 4.2.5) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (exit code 1, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from spark_rapids_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch twin on the card at the
     main path's shapes (counts exact; f32 sums rtol 1e-5 for q1_fused
     and 1e-4 for grouped_sum and window_group_sums, which add in another
     order than the twin's; exact for window_group_sums at the shape of
     planner Q1's partial aggregate, whose integer sums f32 holds
     exactly), check that grouped_sum's tiers A and B and
     window_group_sums give the same bits on a second call, and time the
     wrapper (`ms`), the kernel alone (`device_ms`, torch.profiler's CUDA
     time over a batch of launches), the plain twin and, where one
     exists, the single PyTorch call that computes the same function;
  4. run Q1 through the exec tree, q1_plan(...).collect(), over 8 batches
     under the TPC bench conf, against a float64 numpy golden (keys and
     counts exact, sums and averages rtol 1e-3: f32 accumulation), with
     each kernel's launches counted over a cold and a hot collect; then
     time the cold collect of a second plan instance, which splits the
     first cold collect into the process's first use of the torch ops
     and the plan's own probe and deopt re-run;
  5. run the stacked Q1 step, build_q1_fused_kernel, on the same data
     against the same golden (rtol 1e-5);
  6. run TPC-H Q1 and Q6 as a user submits them, through the planner,
     collect(accelerate(QUERIES[n](sources(tables, 16), run), conf)),
     over all 16 columns of SF10 lineitem (tpch_bench.sf10_lineitem_frame)
     under the TPC bench conf with spark.rapids.sql.test.enabled, so a
     CPU island anywhere in the plan raises: the exec tree must be the
     planner's (partial aggregate with the filter fused, exchanges of 16
     partitions), the results must hold against a float64 numpy golden
     (keys and counts exact, sums and averages rtol 1e-3: the banded
     lane adds in f32), and window_group_sums must launch during the Q1
     collects; accelerate (with the upload) and collect are timed apart,
     cold and hot;
  7. print the kernels line and, last, the device line.
Without a CUDA device, or without the package beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
Q1_NAMES = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_price", "avg_disc", "count_order"]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, kernel: str, reps: int) -> float:
    """Mean device time of one launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `reps` calls of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    require(bool(times), f"the profiler saw no {kernel} launch")
    return sum(times) / len(times) / 1e3


def same_bits(a, b, what: str) -> None:
    for x, y in zip(a, b):
        if not x.equal(y):
            raise RuntimeError(f"{what}: a second call gave other bits")


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def golden_q1(batches_np) -> dict:
    """float64 numpy Q1 per group slot flag*2+status: sums, avgs, count."""
    acc = np.zeros((6, 6))
    for cols in batches_np:
        keep = cols["l_shipdate"] <= 10471
        g = (cols["l_returnflag"] * 2 + cols["l_linestatus"])[keep]
        qty = cols["l_quantity"][keep].astype(np.float64)
        price = cols["l_extendedprice"][keep].astype(np.float64)
        disc = cols["l_discount"][keep].astype(np.float64)
        tax = cols["l_tax"][keep].astype(np.float64)
        dp = price * (1.0 - disc)
        ch = dp * (1.0 + tax)
        for j, w in enumerate((qty, price, dp, ch, disc, None)):
            acc[:, j] += np.bincount(g, weights=w, minlength=6)[:6]
    return {"sums": acc[:, :5], "count": acc[:, 5]}


Q1_TREE = ["SortExec", "CoalesceBatchesExec", "ShuffleExchangeExec",
           "HashAggregateExec", "ShuffleExchangeExec", "HashAggregateExec",
           "LocalBatchSource"]
Q6_TREE = ["HashAggregateExec", "ShuffleExchangeExec", "HashAggregateExec",
           "LocalBatchSource"]


def tree(plan) -> list:
    """(class name, describe()) of every exec, in tree order."""
    return [(type(plan).__name__, plan.describe())] + [
        t for c in plan.children for t in tree(c)]


def golden_planner(a: dict, days) -> tuple[dict, float]:
    """float64 numpy Q1 per (returnflag, linestatus) code pair present,
    in key order, and Q6's revenue, over sf10_lineitem_frame's arrays."""
    keep = a["l_shipdate"] <= days("1998-09-02")
    g = (a["l_returnflag"].astype(np.int64) * 2 + a["l_linestatus"])[keep]
    qty, price = a["l_quantity"][keep], a["l_extendedprice"][keep]
    disc, tax = a["l_discount"][keep], a["l_tax"][keep]
    dp = price * (1.0 - disc)
    cols = [np.bincount(g, weights=w, minlength=6)
            for w in (qty, price, dp, dp * (1.0 + tax), disc)]
    cnt = np.bincount(g, minlength=6)
    live = np.flatnonzero(cnt)
    q1 = {"keys": [("ANR"[i // 2], "FO"[i % 2]) for i in live],
          "count": cnt[live],
          "want": np.column_stack([c[live] for c in cols[:4]]
                                  + [cols[0][live] / cnt[live],
                                     cols[1][live] / cnt[live],
                                     cols[4][live] / cnt[live]])}
    sel = ((a["l_shipdate"] >= days("1994-01-01"))
           & (a["l_shipdate"] < days("1995-01-01"))
           & (a["l_discount"] >= 0.05) & (a["l_discount"] <= 0.07)
           & (a["l_quantity"] < 24.0))
    return q1, float(np.sum(a["l_extendedprice"][sel]
                            * a["l_discount"][sel]))


def planner_phase(torch, dev, seed: int, GW) -> dict:
    """Phase 6: planner Q1 and Q6 at SF10 (see the module docstring)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    t0 = time.perf_counter()
    frame, arrays = TB.sf10_lineitem_frame(seed)
    tables = {"lineitem": frame}
    print(f"planner data: {len(frame)} lineitem rows, 16 columns, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    q1_gold, q6_gold = golden_planner(arrays, TD.days)
    del arrays
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    n = TB.SF10_PARTITIONS
    out = {"rel": 0.0}
    GW.window_group_sums.launches = 0
    for q in (1, 6):
        for run in ("cold", "hot"):
            cpu_plan = QUERIES[q](TD.sources(tables, n), None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = accelerate(cpu_plan, conf, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            df = collect(plan, conf)
            t2 = time.perf_counter()
            got = tree(plan)
            require([name for name, _ in got] == (Q1_TREE if q == 1
                                                  else Q6_TREE),
                    f"planner q{q} exec tree: {got}")
            exchanges = [d for name, d in got
                         if name == "ShuffleExchangeExec"]
            require(exchanges == (
                [f"ShuffleExchangeExec(RangePartitioning, n={n})",
                 f"ShuffleExchangeExec(HashPartitioning, n={n})"] if q == 1
                else ["ShuffleExchangeExec(SinglePartitioning, n=1)"]),
                f"planner q{q} exchanges: {exchanges}")
            require("fused=[Filter]" in got[-2][1],
                    f"planner q{q} partial aggregate: {got[-2][1]}")
            if q == 1:
                require(list(zip(df["l_returnflag"], df["l_linestatus"]))
                        == q1_gold["keys"], "planner Q1 group keys differ")
                require(np.array_equal(df["count_order"].to_numpy(),
                                       q1_gold["count"]),
                        "planner Q1 counts differ")
                vals = df[Q1_NAMES[:7]].to_numpy(np.float64)
                rel = float(np.max(np.abs(vals - q1_gold["want"])
                                   / np.abs(q1_gold["want"])))
                out["q1_launches"] = GW.window_group_sums.launches
            else:
                require(len(df) == 1, "planner Q6 is one row")
                rel = abs(float(df["revenue"][0]) - q6_gold) / abs(q6_gold)
            require(rel <= 1e-3, f"planner q{q} rel err {rel}")
            out["rel"] = max(out["rel"], rel)
            print(f"planner q{q} SF10 {run}: accelerate {t1 - t0:.3f} s "
                  f"(with the upload), collect {t2 - t1:.3f} s, rel err "
                  f"{rel:.3g}", flush=True)
            del cpu_plan, plan, df
    require(out["q1_launches"] >= 1,
            "window_group_sums never launched in planner Q1")
    print(f"planner SF10 against the float64 golden: keys and counts "
          f"exact, max rel err {out['rel']:.3g}; planner Q1 "
          f"window_group_sums launches {out['q1_launches']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
        from spark_rapids_tpu_torch.models import tpch
        from spark_rapids_tpu_torch.models import tpch_bench as TB
        from spark_rapids_tpu_torch.ops import cuda_build
        from spark_rapids_tpu_torch.ops import grouped_window as GW
        from spark_rapids_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the spark_rapids_tpu_torch package is not "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. card
    print(TB.card(), flush=True)

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # data: SF10 lineitem in 8 batches of capacity 2^23
    t0 = time.perf_counter()
    sizes, batches_np, batches = TB.sf10_lineitem(args.seed, dev)
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    gold = golden_q1(batches_np)
    stacked, nums = TB.stacked_columns(batches, sizes, dev)
    print(f"data: {TB.SF10_ROWS} rows in {TB.N_BATCHES} batches, "
          f"{datagen_s:.1f} s", flush=True)

    # 3. kernels against their plain twins at the main path's shapes
    kernels: dict = {}
    cap = TB.N_BATCHES * TB.BATCH_CAP

    def q1_call():
        return K.q1_fused(*stacked, nums, capacity=cap, cutoff=10471,
                          batch_rows=TB.BATCH_CAP)

    def q1_plain():
        return K.q1_fused_plain(*stacked, nums, capacity=cap, cutoff=10471,
                                batch_rows=TB.BATCH_CAP)

    got, want = q1_call(), q1_plain()
    require(torch.equal(got[:, 5], want[:, 5]), "q1_fused counts differ")
    q1_err = (got - want).abs().max().item()
    q1_rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    require(q1_rel <= 1e-5, f"q1_fused vs plain rel err {q1_rel}")
    # rows past num_rows[b] are padding: the function reads none of them
    live_rows = sum(sizes)
    b_ms, b_by = bound(live_rows * 28 + nums.numel() * 4
                       + -(-cap // K.Q1_BLOCK_ROWS) * 48 * 4, live_rows * 10)
    kernels["q1_fused"] = {
        "name": "q1_fused", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/q1_fused.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:127",
        "max_abs_err": q1_err, "max_rel_err": q1_rel, "rtol": 1e-5,
        "ms": cuda_ms(torch, q1_call, 20),
        "device_ms": device_ms(torch, q1_call, "q1_fused_kernel", 10),
        "plain_ms": cuda_ms(torch, q1_plain, 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{TB.N_BATCHES}x2^23 stacked"}

    def grouped_case(keys, vals, nrows, n_groups, tier, reps):
        def call():
            return K.grouped_sum(keys, vals, nrows, n_groups=n_groups,
                                 capacity=keys.numel())

        got_s, got_c = call()
        require(K.grouped_sum.last_tiers == [tier],
                f"grouped_sum at G={n_groups} took tiers "
                f"{K.grouped_sum.last_tiers}, expected {tier}")
        if tier in ("A", "B"):
            same_bits((got_s, got_c), call(), f"grouped_sum tier {tier}")
        nr = torch.full((1,), nrows, dtype=torch.int32, device=dev)
        want_s, want_c = K.grouped_sum_plain(
            keys, vals, nr, n_groups=n_groups, capacity=keys.numel())
        require(torch.equal(got_c, want_c), "grouped_sum counts differ")
        err = (got_s - want_s).abs().max().item()
        rel = ((got_s - want_s).abs()
               / want_s.abs().clamp_min(1.0)).max().item()
        require(rel <= 1e-4, f"grouped_sum vs plain rel err {rel}")
        m = len(vals)
        kept = ((keys >= 0) & (keys < n_groups)
                & (torch.arange(keys.numel(), device=dev) < nrows))
        n_kept = int(kept.sum().item())
        b_ms, b_by = bound(keys.numel() * 4 + n_kept * m * 4
                           + n_groups * (m + 1) * 4, n_kept * (m + 1))
        seg = torch.where(kept, keys, n_groups).to(torch.int64)
        lib_vals = torch.where(kept[:, None], torch.stack(vals, 1), 0.0)

        def library():
            torch.zeros((n_groups + 1, m), device=dev).index_add_(
                0, seg, lib_vals)
            torch.bincount(seg, minlength=n_groups + 1)

        return {
            "max_abs_err": err, "max_rel_err": rel, "rtol": 1e-4,
            "tier": tier, "ms": cuda_ms(torch, call, reps),
            "device_ms": device_ms(torch, call, "grouped_sum", reps),
            "plain_ms": cuda_ms(torch, lambda: K.grouped_sum_plain(
                keys, vals, nr, n_groups=n_groups,
                capacity=keys.numel()), reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, library, reps)}

    # Q1's dictionary-lane shape: composite slot (flag window 4+1 x status
    # window 4+1) = 25 slots + the masked slot, 14 measures
    b0 = batches[0]
    keep0 = (b0.column("l_shipdate").data <= 10471) & b0.row_mask()
    slot = torch.where(keep0, b0.column("l_returnflag").data * 5
                       + b0.column("l_linestatus").data, 25).to(torch.int32)
    q, p, d, t = (b0.column(n).data for n in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    dp64 = p.double() * (1.0 - d.double())
    val_cols = [q, p, dp64.float(), (dp64 * (1.0 + t.double())).float(),
                q, p, d]
    flag = keep0.float()
    q1_vals = []
    for v in val_cols:
        q1_vals += [torch.where(keep0, v, 0.0), flag]
    gs = grouped_case(slot, q1_vals, TB.BATCH_CAP, 26, "A", 20)
    gs.update(name="grouped_sum", route="cuda",
              source="spark_rapids_tpu_torch/csrc/grouped_sum.cu",
              replaces="spark_rapids_tpu/ops/pallas_kernels.py:291",
              shape="2^23 rows, G=26, M=14")
    kernels["grouped_sum"] = gs
    g_rng = torch.Generator(device=dev).manual_seed(args.seed)
    wide_keys = torch.randint(0, 32769, (TB.BATCH_CAP,), generator=g_rng,
                              device=dev, dtype=torch.int32)
    gs_wide = grouped_case(wide_keys, q1_vals, TB.BATCH_CAP, 32769, "C", 5)
    gs_wide["shape"] = "2^23 rows, G=32769, M=14"
    # a table past the lane-private tier: one table per warp
    mid_keys = torch.remainder(wide_keys, 300)
    gs_mid = grouped_case(mid_keys, q1_vals, TB.BATCH_CAP, 300, "B", 10)
    gs_mid["shape"] = "2^23 rows, G=300, M=14"

    def window_case(gid, vals, out_cap, reps):
        def call():
            return GW.window_group_sums(gid, vals, out_cap=out_cap,
                                        capacity=gid.numel())

        got = call()
        same_bits((got,), (call(),), "window_group_sums")
        want = GW.window_group_sums_plain(gid, vals, out_cap=out_cap)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        require(rel <= 1e-4, f"window_group_sums vs plain rel err {rel}")
        m, n = len(vals), gid.numel()
        b_ms, b_by = bound(n * 4 + n * m * 4 + out_cap * m * 4, n * m)
        seg = torch.where((gid >= 0) & (gid < out_cap), gid,
                          out_cap).to(torch.int64)
        lib_vals = torch.stack(vals, 1)
        return {
            "max_abs_err": err, "max_rel_err": rel, "rtol": 1e-4,
            "ms": cuda_ms(torch, call, reps),
            "device_ms": device_ms(torch, call, "window_group_sums", reps),
            "plain_ms": cuda_ms(torch, lambda: GW.window_group_sums_plain(
                gid, vals, out_cap=out_cap), reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, lambda: torch.zeros(
                (out_cap + 1, m), device=dev).index_add_(0, seg, lib_vals),
                reps)}

    # Q1's merge shape: 8 partials x 6 groups sorted into a 16384-row
    # batch, 17 measures (4 Sum x 2, 3 Average x 2, 1 Count, 2 limbs)
    merge_cap, live = 1 << 14, TB.N_BATCHES * 6
    gid = torch.clamp(torch.arange(merge_cap, device=dev) // TB.N_BATCHES,
                      max=5).to(torch.int32)
    row_live = torch.arange(merge_cap, device=dev) < live
    mvals = [torch.where(row_live, torch.rand(merge_cap, generator=g_rng,
                                              device=dev) * 1e6, 0.0)
             for _ in range(17)]
    wg = window_case(gid, mvals, merge_cap, 50)
    wg.update(name="window_group_sums", route="cuda",
              source="spark_rapids_tpu_torch/csrc/window_group_sums.cu",
              replaces="spark_rapids_tpu/ops/grouped_window.py:72",
              shape="2^14 rows (48 live), 6 groups, M=17")
    kernels["window_group_sums"] = wg
    big_gid = torch.sort(torch.randint(0, 1 << 20, (1 << 22,),
                                       generator=g_rng, device=dev))[0].to(
        torch.int32)
    big_vals = [torch.rand(1 << 22, generator=g_rng, device=dev)
                for _ in range(17)]
    wg_big = window_case(big_gid, big_vals, 1 << 20, 10)
    wg_big["shape"] = "2^22 rows, ~10^6 groups, M=17"
    # planner Q1's partial aggregate: one partition of 3,749,129 live rows
    # at capacity 2^22 in 4 runs that cross ~900 tiles each; small
    # integers keep every f32 sum exact, so kernel and twin must agree
    # to the bit
    part_rows = 3_749_129
    iota = torch.arange(1 << 22, device=dev)
    run_gid = torch.clamp(iota * 4 // part_rows, max=3).to(torch.int32)
    run_vals = [torch.where(iota < part_rows, torch.randint(
        0, 16, (1 << 22,), generator=g_rng, device=dev), 0).float()
        for _ in range(17)]
    wg_runs = window_case(run_gid, run_vals, 1 << 14, 10)
    require(wg_runs["max_abs_err"] == 0.0,
            "window_group_sums at planner Q1's shape is not exact")
    wg_runs["shape"] = "2^22 rows (3,749,129 live), 4 runs, out_cap 2^14, M=17"
    for k in list(kernels.values()) + [gs_mid, gs_wide, wg_big, wg_runs]:
        print(f"kernel {k.get('name', '')} [{k['shape']}]: max_abs_err "
              f"{k['max_abs_err']:.3g} max_rel_err {k['max_rel_err']:.3g} "
              f"(rtol {k['rtol']}), ms {k['ms']:.4f}, device_ms "
              f"{k['device_ms']:.4f}, plain_ms "
              f"{k['plain_ms']:.4f}, bound_ms {k['bound_ms']:.4f} "
              f"({k['bound_by']}), library_ms {k['library_ms']}",
              flush=True)
    del wide_keys, mid_keys, big_gid, big_vals, q1_vals, mvals, run_vals

    # 4. engine Q1 through the exec tree
    with C.session(C.RapidsConf(TB.BENCH_CONF)):
        plan = tpch.q1_plan(LocalBatchSource([batches], device=dev))
        K.grouped_sum.launches = 0
        GW.window_group_sums.launches = 0
        K.q1_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df = plan.collect().to_pandas()
        cold_s = time.perf_counter() - t0
        deopted = plan.child._banded_disabled
        t0 = time.perf_counter()
        df_hot = plan.collect().to_pandas()
        hot_s = time.perf_counter() - t0
        engine_launches = {"grouped_sum": K.grouped_sum.launches,
                           "window_group_sums":
                               GW.window_group_sums.launches,
                           "q1_fused": K.q1_fused.launches}
        # a second plan in the now warm process: its cold collect pays the
        # plan's own first-batch probe and deopt re-run, but not the
        # process's first use of each torch op on the path
        fresh = tpch.q1_plan(LocalBatchSource([batches], device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df_fresh = fresh.collect().to_pandas()
        fresh_cold_s = time.perf_counter() - t0
    print(f"engine q1_plan SF10: cold {cold_s:.3f} s (first plan in the "
          f"process), cold {fresh_cold_s:.3f} s (second plan), hot "
          f"{hot_s:.3f} s, banded lane deopted: {deopted}, launches "
          f"{engine_launches}", flush=True)
    require(engine_launches["grouped_sum"] >= TB.N_BATCHES,
            "grouped_sum launched fewer than once per batch")
    require(engine_launches["window_group_sums"] >= 1,
            "window_group_sums never launched")
    exp_keys = [(g // 2, g % 2) for g in range(6)]
    cnt = gold["count"]
    engine_rel = 0.0
    for frame in (df, df_hot, df_fresh):
        require(list(zip(frame["l_returnflag"], frame["l_linestatus"]))
                == exp_keys, "Q1 group keys differ")
        require(np.array_equal(frame["count_order"].to_numpy(),
                               cnt.astype(np.int64)), "Q1 counts differ")
        want = np.column_stack([gold["sums"][:, :4],
                                gold["sums"][:, 0] / cnt,
                                gold["sums"][:, 1] / cnt,
                                gold["sums"][:, 4] / cnt])
        got = frame[Q1_NAMES[:7]].to_numpy(np.float64)
        engine_rel = max(engine_rel,
                         float(np.max(np.abs(got - want) / np.abs(want))))
    require(engine_rel <= 1e-3, f"Q1 engine rel err {engine_rel}")
    print(f"engine q1_plan SF10 against the float64 golden: keys and "
          f"counts exact, max rel err {engine_rel:.3g}", flush=True)

    # 5. the stacked Q1 step
    step = tpch.build_q1_fused_kernel(cap, TB.BATCH_CAP, device=dev)
    K.q1_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = step(*stacked, nums).cpu().numpy()
    step_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(*stacked, nums).cpu()
    step_hot_s = time.perf_counter() - t0
    step_launches = K.q1_fused.launches
    require(step_launches >= 1, "q1_fused never launched")
    require(np.array_equal(table[:6, 5], cnt), "stacked Q1 counts differ")
    step_rel = float(np.max(np.abs(table[:6, :5] - gold["sums"])
                            / np.abs(gold["sums"])))
    require(step_rel <= 1e-5, f"stacked Q1 rel err {step_rel}")
    print(f"stacked q1 step SF10: cold {step_cold_s:.4f} s, hot "
          f"{step_hot_s:.4f} s, rel err {step_rel:.3g}, q1_fused "
          f"launches {step_launches}", flush=True)

    # 6. planner Q1 and Q6
    planner = planner_phase(torch, dev, args.seed, GW)

    kernels["q1_fused"]["launches"] = step_launches
    kernels["grouped_sum"]["launches"] = engine_launches["grouped_sum"]
    kernels["window_group_sums"]["launches"] = \
        engine_launches["window_group_sums"]
    kernels["window_group_sums"]["planner_q1_launches"] = \
        planner["q1_launches"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "planner_q1_launches")
    line = {"kernels": [{k: v[k] for k in keys if k in v}
                        for v in kernels.values()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
