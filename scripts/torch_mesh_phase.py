#!/usr/bin/env python3
"""chip_smoke.py's phase 19, distribution, alone on the visible NVIDIA
cards: the eight TPC-H tables at `--sf` (phases 7-9's, SF1 by default)
and the float64 goldens of Q1, Q3, Q5 and Q9, the kernels built, then
phase 19: 19a, the four queries over a mesh of chip_smoke.MESH_SLOTS
slots (all on one card when there is one) with the SPMD lane on; 19b,
graft_entry.dryrun_multichip and entry()'s Q1 step.  Prints the card's
name and power limit first, then what chip_smoke.py prints for phase 19
and the kernels' launches in every part.

    python3 scripts/torch_mesh_phase.py [--sf 1] [--seed 0]

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
        print("torch_mesh_phase: no CUDA device", file=sys.stderr)
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
    q1, _ = CS.golden_planner({**arrays, "l_tax": tables["lineitem"][
        "l_tax"].to_numpy()}, TD.days)
    gold = {1: q1, **CS.golden_joins(arrays, TD),
            **CS.golden_parts(arrays, tables["customer"], TD, TB)}
    del arrays
    print(f"data and goldens at {CS.sf_of(tables)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = CS.mesh_phase(torch, dev, tables, gold, GW, K,
                        CS.kernel_cases(torch, dev, GW, K))
    print(f"phase 19: {time.perf_counter() - t0:.1f} s; launches "
          f"{out['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
