#!/usr/bin/env python3
"""chip_smoke.py's TPC-DS phases alone on one NVIDIA card: phase 11 (the
18 queries of chip_smoke.DS_SLICE, with a window, a ROLLUP or a UNION
ALL) and the TPC-DS part of phase 13 (the other 85), over the queries
of spark_rapids_tpu_torch/models/tpcds_queries.py that `--queries`
names.  The check holds the card's results against the CPU engine at
20,000 store_sales rows, seed 3 (13a's, the reference fixture's); then
each query runs over `tpcds_bench.sf10_tables(seed, scale)` (by default
chip_smoke's WL_SCALE; `--scale 2880404` for SF1, `--scale 28800991`
for SF10) at 16 partitions, one new plan per query,
with chip_smoke.ds_query's measures and checks: accelerate and collect
apart, plan runs, peak device memory, lanes, launches, device memory
back to its value before the query, the widest input of every
WindowExec and ExpandExec and the widest call of each kernel against
their CPU twins (the kernels' device times from CUDA events).  A query
that fails is named with its error and the next one runs; the script
then exits 1 and names every query that failed.  Prints the card's name
and power limit first, then one line per query.

    python3 scripts/torch_tpcds_phase.py [--seed N] [--scale ROWS]
        [--skip-check] [--queries rest|all|q67,q70]
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
                    help="store_sales rows of the run (default "
                    "chip_smoke's WL_SCALE; SF1 is 2880404, SF10 28800991)")
    ap.add_argument("--skip-check", action="store_true",
                    help="skip the check against the CPU engine")
    ap.add_argument("--queries", default=None,
                    help="the 18 of phase 11 (default), rest (the other "
                    "85), all (103), or names, comma-separated")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_tpcds_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops import grouped_window as GW
    from spark_rapids_tpu_torch.ops import kernels as K
    picked = {None: list(CS.DS_SLICE), "rest": CS.ds_rest(),
              "all": list(CS.DS_SLICE) + CS.ds_rest()}.get(args.queries)
    if picked is None:
        picked = args.queries.split(",")
    queries = sorted(picked, key=CS.query_order)
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    if not args.skip_check:
        t0 = time.perf_counter()
        CS.check_queries(torch, dev, CS.workload("tpcds"),
                         ("workload", CS.WL_CHECK_SEED, CS.WL_CHECK_SCALE),
                         queries, f"{CS.WL_CHECK_SCALE} store_sales rows")
        print(f"check: {time.perf_counter() - t0:.1f} s", flush=True)
    failed: list = []
    t0 = time.perf_counter()
    CS.ds_phase(torch, dev, args.seed, GW, K, args.scale or CS.WL_SCALE,
                queries, failed)
    print(f"scale run: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"{len(failed)} queries failed:\n" + "\n".join(failed),
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
