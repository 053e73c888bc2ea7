#!/usr/bin/env python3
"""chip_smoke.py's phase 17, the observability layer, alone on one NVIDIA
card: the eight TPC-H tables at `--sf` (phases 7-9's, SF1 by default),
their float64 goldens and 14b's files (lineitem, orders, customer,
supplier and partsupp as Parquet, part as ORC, nation and region as
CSV), the kernels built, then phase 17: Q5 unprofiled (17e's first
run), then 17a: planner Q1 and Q5 over the files, the exec-tree Q1 and
the stacked Q1 step unprofiled and profiled (the same bits), the hand
kernels' warm catalog means against each kernel timed alone; 17c: Q3
over four executors; 17b: the same Q3 under OOM injection and a
budget, with the out-of-core lanes (their runs spill) and without them
(the device store spills); 17d: two streams (Q1 and Q3,
and Q5) under the telemetry sampler and its HTTP endpoint; 17e: Q5
unprofiled twice more, with the layer off.  Prints the card's name and
power limit first, then what chip_smoke.py prints for phase 17, and
each part's lap.

    python3 scripts/torch_profile_phase.py [--sf 1] [--seed 0]

The profiles' Chrome traces and event log are written under
`.profile_smoke/` in the checkout (git-ignored) and removed at the end;
`--keep DIR` copies them to DIR first.  It raises on any failure (exit
code 1).
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
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--keep", default="",
                    help="copy the traces and the event log here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_phase: no CUDA device", file=sys.stderr)
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
    t0 = time.perf_counter()
    tables, arrays = TB.sf10_tables(args.seed, sf=args.sf)
    q1, q6 = CS.golden_planner({**arrays, "l_tax": tables["lineitem"][
        "l_tax"].to_numpy()}, TD.days)
    gold = {1: q1, 6: q6, **CS.golden_joins(arrays, TD),
            **CS.golden_parts(arrays, tables["customer"], TD, TB),
            **CS.golden_rest(arrays, tables, TD, TB)}
    del arrays
    CS.write_tpch_files(torch, dev, tables)
    print(f"data, goldens and files at {CS.sf_of(tables)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        t0 = time.perf_counter()
        out = CS.profile_phase(torch, dev, tables, gold, GW, K, {},
                               args.seed, keep=args.keep)
    finally:
        CS.io_reset()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; parts "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["laps"].items())
          + f"; launches {out['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
