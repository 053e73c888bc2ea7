#!/usr/bin/env python3
"""chip_smoke.py's phase 10 alone on one NVIDIA card: the ETL plans of
spark_rapids_tpu_torch/models/etl_bench.py (X1-X4) over
`tpch_bench.sf10_tables(seed)` at SF10, 16 partitions, with their float64
goldens and checks (chip_smoke.etl_phase).  Prints the card's name and
power limit first, then one line per plan (accelerate, cold and hot
collect, plan runs, peak device memory, launches).

    python3 scripts/torch_etl_phase.py [--seed N]
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
        print("torch_etl_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.ops import grouped_window as GW
    from spark_rapids_tpu_torch.ops import kernels as K
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    tables, arrays = TB.sf10_tables(args.seed)
    gold = CS.golden_etl(arrays, tables, args.seed)
    del arrays
    print(f"data and goldens: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    CS.etl_phase(torch, dev, tables, gold, GW, K)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
