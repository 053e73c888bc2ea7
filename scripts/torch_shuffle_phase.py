#!/usr/bin/env python3
"""chip_smoke.py's phase 16, the shuffle manager lane, alone on one NVIDIA
card: the eight TPC-H tables at `--sf` (phases 7-9's, SF1 by default) and
their float64 goldens, the kernels built, 16a's queries once through
the local lane (as phases 7-9 run them before phase 16 in
chip_smoke.py: the process's first use of each op, and the collects the
manager lane compares with), then 16a-16f (Q3, Q5, Q9 and
Q18 over four executors of the card; Q5 over TCP with zstd; Q3 under
peer kill; Q3 with speculation against a slow executor; a second
process's map output over TCP with lz4, then that process killed in a
read; the brute-force joins).  Prints the card's name and power limit
first, then what chip_smoke.py prints for phase 16, and each part's lap.

    python3 scripts/torch_shuffle_phase.py [--sf 1] [--seed 0]

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
        print("torch_shuffle_phase: no CUDA device", file=sys.stderr)
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
    print(f"data and goldens at {CS.sf_of(tables)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for q in CS.SHUFFLE_QUERIES:
        df, sub, sec = CS.submit_tpch(torch, dev, q, tables,
                                      CS.tpch_conf(q), f"local q{q}")
        rel = CS.check_tpch(q, df, gold, sub)
        print(f"local lane q{q}: accelerate {sec['accelerate']:.3f} s, "
              f"collect {sec['collect']:.3f} s, rel err {rel:.3g}",
              flush=True)
        del df, sub
    t0 = time.perf_counter()
    out = CS.shuffle_phase(torch, dev, tables, gold, GW, K,
                           CS.kernel_cases(torch, dev, GW, K), args.seed)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s; parts "
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["laps"].items())
          + f"; launches {out['launches']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
