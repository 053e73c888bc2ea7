#!/usr/bin/env python3
"""chip_smoke.py's phase 14 alone on one NVIDIA card: the I/O layer and
the planner's sort-merge join, repartition, cached columnar scan and
sort aggregate.  Runs phase 6 (planner Q1 and Q6 at SF10 over
CpuSource, for its goldens and times), then 14a (the same lineitem
columns written as Parquet by the port's writer, partitioned by
l_returnflag and l_linestatus, and Q1 and Q6 read back through
read_parquet), then over TPC-H at chip_smoke's JOIN_SF 14b (the eight
tables written as Parquet, ORC and CSV, Q3, Q5 and Q9 over them) and 14c
(Q3 with sort-merge joins, with the replacement on and off; Q1 over a
round-robin repartition, over a cached columnar copy of lineitem and
with a sort aggregate), each against its float64 golden, and every
kernel call of the phase against its twin.  Prints the card's name and
power limit first.

    python3 scripts/torch_io_phase.py [--seed N]
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_io_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops import grouped_window as GW
    from spark_rapids_tpu_torch.ops import kernels as K
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    grouped_case, window_case = CS.kernel_cases(torch, dev, GW, K)
    t0 = time.perf_counter()
    planner = CS.planner_phase(torch, dev, args.seed, GW)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    io_a = CS.io_scan_phase(torch, dev, planner, GW, K)
    del planner
    CS.plan_cases("14a", {i["label"]: i for i in io_a["queries"].values()},
                  window_case, grouped_case)
    print(f"phase 14a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tables, arrays = TB.sf10_tables(args.seed, sf=CS.JOIN_SF)
    gold = CS.golden_joins(arrays, TD)
    gold_parts = CS.golden_parts(arrays, tables["customer"], TD, TB)
    gold_q1 = CS.golden_planner({**arrays, "l_tax": tables["lineitem"][
        "l_tax"].to_numpy()}, TD.days)[0]
    del arrays
    print(f"data and goldens: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    io_b = CS.io_files_phase(torch, dev, tables, gold, gold_parts, GW, K)
    print(f"phase 14b: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    gaps = CS.plan_gaps_phase(torch, dev, tables, gold, gold_q1, GW, K)
    print(f"phase 14c: {time.perf_counter() - t0:.1f} s", flush=True)
    CS.plan_cases("14b and 14c",
                  {i["label"]: i for i in list(io_b["queries"].values())
                   + list(gaps.values())}, window_case, grouped_case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
