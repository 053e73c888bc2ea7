#!/usr/bin/env python3
"""Where the time goes in spark_rapids_tpu_torch's TPC-H Q1 at scale
factor 10 on one NVIDIA card.

    python3 scripts/profile_torch_q1.py [--seed N]

Builds the SF10 lineitem batches of models/tpch_bench.py, as
chip_smoke.py does, and profiles with torch.profiler (CPU and CUDA
activities) the first, cold q1_plan(...).collect() of the process (which
also learns the banded-lane deopt), one hot collect and one stacked Q1
step; then, through the planner, one hot collect of TPC-H Q1 over the 16
partitions of tpch_bench.sf10_lineitem_frame (accelerated once, collected
once cold first).  Prints the card, the wall time of each profiled run, the
device-busy time (sum of kernel time) and idle share, the top device
kernels and the top host events by self time.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOP = 20  # rows printed per table


def profiled(torch, fn, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    by_name: dict = {}
    host: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # kernels, memcpy, memset
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        else:  # torch ops and CUDA runtime calls, by self time
            ms, n = host.get(e.name, (0.0, 0))
            host[e.name] = (ms + e.self_cpu_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    n_ops = sum(n for _, n in by_name.values())
    print(f"== {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.3f}, device ops {n_ops}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:TOP]:
        print(f"  {ms:9.3f} ms  x{n:5d}  {name[:100]}")
    print("   host events by self time:")
    for name, (ms, n) in sorted(host.items(), key=lambda kv: -kv[1][0]
                                )[:TOP]:
        print(f"  {ms:9.3f} ms  x{n:5d}  {name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_q1: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.ops import cuda_build
    dev = torch.device("cuda", 0)
    print(TB.card())
    cuda_build.build()
    sizes, _, batches = TB.sf10_lineitem(args.seed, dev)
    with C.session(C.RapidsConf(TB.BENCH_CONF)):
        plan = tpch.q1_plan(LocalBatchSource([batches], device=dev))
        profiled(torch, lambda: plan.collect(), "q1_plan_cold")
        plan.collect()
        profiled(torch, lambda: plan.collect(), "q1_plan_hot")
    stacked, nums = TB.stacked_columns(batches, sizes, dev)
    step = tpch.build_q1_fused_kernel(TB.N_BATCHES * TB.BATCH_CAP,
                                      TB.BATCH_CAP, device=dev)
    step(*stacked, nums)
    profiled(torch, lambda: step(*stacked, nums).cpu(), "stacked_step")
    del batches, stacked, step, plan

    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    frame, _ = TB.sf10_lineitem_frame(args.seed)
    conf = C.RapidsConf(TB.BENCH_CONF)
    planner = accelerate(QUERIES[1](TD.sources(
        {"lineitem": frame}, TB.SF10_PARTITIONS), None), conf, device=dev)
    collect(planner, conf)
    profiled(torch, lambda: collect(planner, conf), "planner_q1_hot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
