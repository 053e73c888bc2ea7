#!/usr/bin/env python3
"""chip_smoke.py's phase 11 alone on one NVIDIA card: the 18 TPC-DS
queries of spark_rapids_tpu_torch/models/tpcds_queries.py.  11a holds
the card's results at 100,000 store_sales rows against the CPU engine;
11b runs them over `tpcds_bench.sf10_tables(seed, scale)` (by default
chip_smoke's DS_SCALE, a quarter of SF10's 28,800,991 store_sales rows;
`--scale 28800991` for SF10) at 16 partitions, one new plan per query,
and holds
the widest input of every WindowExec and ExpandExec, and the widest
call of each kernel, against their CPU twins (chip_smoke.ds_phase).
Prints the card's name and power limit first, then one line per query.

    python3 scripts/torch_tpcds_phase.py [--seed N] [--scale ROWS]
        [--skip-check] [--queries q67,q70]
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
                    help="11b's store_sales rows (default chip_smoke's "
                    "DS_SCALE; SF10 is 28800991)")
    ap.add_argument("--skip-check", action="store_true",
                    help="run 11b only")
    ap.add_argument("--queries", default=None,
                    help="11b's queries, comma-separated (default all)")
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
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    if not args.skip_check:
        t0 = time.perf_counter()
        CS.ds_check_phase(torch, dev, args.seed)
        print(f"phase 11a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    CS.ds_phase(torch, dev, args.seed, GW, K, args.scale or CS.DS_SCALE,
                args.queries.split(",") if args.queries else None)
    print(f"phase 11b: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
