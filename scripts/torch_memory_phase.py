#!/usr/bin/env python3
"""chip_smoke.py's phase 12 alone on one NVIDIA card: the memory layer
over TPC-H at chip_smoke's JOIN_SF.  Runs Q9 and Q18 unbudgeted (as
phases 8-9 do, against their float64 goldens, for their results and
peaks), then phase 12 (chip_smoke.memory_phase): Q18, Q9 and a SortExec
over lineitem under spark.rapids.memory.hbmBudgetBytes = a quarter of
each one's unbudgeted peak, results equal to the unbudgeted ones and the
out-of-core lanes engaged; Q5 under seeded OOM injection against phase
7's golden; every kernel call of the phase held against its twin.
Prints the card's name and power limit first.

    python3 scripts/torch_memory_phase.py [--seed N]
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
        print("torch_memory_phase: no CUDA device", file=sys.stderr)
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
    tables, arrays = TB.sf10_tables(args.seed, sf=CS.JOIN_SF)
    gold = CS.golden_joins(arrays, TD)
    gold_parts = CS.golden_parts(arrays, tables["customer"], TD, TB)
    gold_rest = CS.golden_rest(arrays, tables, TD, TB)
    del arrays
    print(f"data and goldens: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    parts = CS.join_phase(torch, dev, tables, {9: gold_parts[9]}, GW, K,
                          runs=("cold",))
    rest = CS.join_phase(
        torch, dev, tables, {18: gold_rest[18]}, GW, K,
        check=CS.check_rest_query, runs=("cold",),
        trees={18: [CS.TREE_CODES[c] for c in CS.REST_TREES[18].split()]})
    print(f"unbudgeted Q9 and Q18: {time.perf_counter() - t0:.1f} s",
          flush=True)
    grouped_case, window_case = CS.kernel_cases(torch, dev, GW, K)
    t0 = time.perf_counter()
    mem = CS.memory_phase(
        torch, dev, tables,
        {q: {"frame": ph["frames"][q],
             "peak": ph["peak_gb_by_query"][q] * 2**30,
             "seconds": sum(ph["seconds"][f"q{q}_cold"].values())}
         for q, ph in ((18, rest), (9, parts))},
        {18: lambda df: CS.check_rest_query(18, df, gold_rest[18]),
         9: lambda df: CS.check_part_query(9, df, gold_parts[9])},
        gold[5], GW, K)
    CS.plan_cases("12", mem["runs"], window_case, grouped_case)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
