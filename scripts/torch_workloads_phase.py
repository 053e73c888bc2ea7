#!/usr/bin/env python3
"""chip_smoke.py's phase 13 for TPCx-BB and Mortgage alone on one NVIDIA
card (scripts/torch_tpcds_phase.py --queries rest runs its TPC-DS
part): the 30 TPCx-BB queries of spark_rapids_tpu_torch/models/
tpcxbb.py (or those `--queries` names) and Mortgage's etl_plan and
summary_plan.  The check holds the card's results against the CPU
engine at chip_smoke's WL_CHECK_SCALE and WL_CHECK_SEED (20,000
store_sales rows, seed 3) and WL_CHECK_LOANS (1,000 loans x 24
months); then each query runs over
`tpcxbb.gen_tables(default_rng(seed), scale)` (by default chip_smoke's
WL_SCALE) and each plan over `--loans` x 24 months,
16 partitions, one new plan each, with chip_smoke.ds_query's measures
and checks.  A query that fails is named with its error and the next
one runs; the script then exits 1 and names every query that failed.
Prints the card's name and power limit first, then one line per query.

    python3 scripts/torch_workloads_phase.py [--seed N] [--scale ROWS]
        [--loans N] [--skip-check] [--queries all|none|q01,q02]
        [--no-mortgage]
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
    ap.add_argument("--scale", type=int, default=None,
                    help="store_sales rows of TPCx-BB's run (default "
                    "chip_smoke's WL_SCALE; SF1 is 2880404)")
    ap.add_argument("--loans", type=int, default=None,
                    help="Mortgage's loans (default 1000000)")
    ap.add_argument("--skip-check", action="store_true",
                    help="skip the check against the CPU engine")
    ap.add_argument("--queries", default="all",
                    help="TPCx-BB's queries: all, none, or names, "
                    "comma-separated")
    ap.add_argument("--no-mortgage", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_workloads_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpcxbb as X
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops import grouped_window as GW
    from spark_rapids_tpu_torch.ops import kernels as K
    queries = {"all": sorted(X.QUERIES), "none": []}.get(
        args.queries, args.queries.split(","))
    mortgage = not args.no_mortgage
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    if not args.skip_check:
        t0 = time.perf_counter()
        if queries:
            CS.check_queries(torch, dev, CS.workload("tpcxbb"),
                             ("workload", CS.WL_CHECK_SEED, CS.WL_CHECK_SCALE),
                             queries, f"{CS.WL_CHECK_SCALE} store_sales rows")
        if mortgage:
            CS.check_queries(
                torch, dev, CS.workload("mortgage"),
                ("mortgage", args.seed, CS.WL_CHECK_LOANS,
                 CS.MORTGAGE_MONTHS),
                ("etl_plan", "summary_plan"),
                f"{CS.WL_CHECK_LOANS} loans x {CS.MORTGAGE_MONTHS} months")
        print(f"phase 13a: {time.perf_counter() - t0:.1f} s", flush=True)
    failed: list = []
    t0 = time.perf_counter()
    CS.workloads_scale_phase(
        torch, dev, args.seed, GW, K, args.scale or CS.WL_SCALE,
        args.loans or CS.MORTGAGE_LOANS, xbb_queries=queries,
        mortgage=mortgage, failed=failed)
    print(f"scale run: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"{len(failed)} queries failed:\n" + "\n".join(failed),
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
