#!/usr/bin/env python3
"""chip_smoke.py's phase 18, the UDF layer, alone on one NVIDIA card:
the eight TPC-H tables at `--sf` (phases 7-9's, SF1 by default) and
their float64 goldens, the kernels built, then phase 18: 18a, TPCx-BB
q18 and q27 at SF1 (2,880,404 store_sales rows, 1,440,202 product
reviews) with the UDF compiler on and off; 18b, the six pandas execs
through the planner over lineitem, the vectorized UDFs in the worker
daemon's two processes, a worker killed in the middle of a batch; 18c,
the API audit, the five versions' shuffle managers, plugin.activate()
with planner Q1 and Q6, Q3 through the spark301 shuffle manager over
four executors, Q6's input exported as tensors and a linear regression
trained on them, then deactivate().  Prints the card's name and power
limit first, then what chip_smoke.py prints for phase 18, each part's
lap, and the kernels' launches in every plan of the phase.

    python3 scripts/torch_udf_phase.py [--sf 1] [--seed 0]

It raises on any failure (exit code 1).
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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_udf_phase: no CUDA device", file=sys.stderr)
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
    gold = {1: q1, 6: q6, **CS.golden_joins(arrays, TD)}
    del arrays
    print(f"data and goldens at {CS.sf_of(tables)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = CS.udf_phase(torch, dev, tables, gold, (args.seed, args.sf), GW, K,
                       CS.kernel_cases(torch, dev, GW, K))
    print(f"phase 18: {time.perf_counter() - t0:.1f} s; launches "
          f"{out['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
