#!/usr/bin/env python3
"""The TPC-H throughput test (TPC-H spec 5.3.4) alone on one NVIDIA card,
as chip_smoke.py's phase 15a runs it: `--streams` threads, each
submitting the 22 queries in its order (the power-test order, rotated
by an equal share for each further stream), one new plan each, under the
TPC bench conf with test.enabled and the runtime's defaults (prefetch
pipeline, admission scheduler and watchdog on), over the eight TPC-H
tables at `--sf`, written first as files into chip_smoke.py's IO_DIR
(Parquet, part as ORC, nation and region as CSV) and read by every
query, so that each scan prefetches; removed at the end.  Every result is held against its
float64 golden (chip_smoke.check_tpch) unless `--skip-check`.  Prints the
card's name and power limit first, then each query's accelerate and
collect, each stream's wall, the streams' wall together, the scheduler's
and the pipeline's counters and the kernels' launches.  With `--single`,
one stream of the 22 in the power order runs first, for comparison.
With `--phase`, the streams run as all of chip_smoke.py's phase 15
(15a-15e: the throughput test, admission and the result cache, the
watchdog, AQE, the kernel wrappers under threads; needs the goldens).

    python3 scripts/torch_runtime_phase.py --sf 1 --streams 2 --single
    python3 scripts/torch_runtime_phase.py --sf 1 --phase
    python3 scripts/torch_runtime_phase.py --sf 10 --streams 3

The spec's minimum stream counts: 2 at SF1, 3 at SF10 (5.3.4).  A query
that fails (an out-of-memory error, say) is named and its stream goes on
to its next query; the script then exits 1.
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
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--single", action="store_true",
                    help="run one stream of the 22 first")
    ap.add_argument("--skip-check", action="store_true",
                    help="no goldens: results are not checked")
    ap.add_argument("--phase", action="store_true",
                    help="run all of chip_smoke.py's phase 15")
    ap.add_argument("--queries", default="",
                    help="comma-separated TPC-H query numbers (default all)")
    ap.add_argument("--conf", action="append", default=[],
                    help="key=value added to every query's conf")
    args = ap.parse_args()
    queries = ({int(q) for q in args.queries.split(",")} if args.queries
               else None)
    extra = dict(kv.split("=", 1) for kv in args.conf)
    if args.phase and args.skip_check:
        ap.error("--phase checks every result: drop --skip-check")
    import torch
    if not torch.cuda.is_available():
        print("torch_runtime_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.ops import cuda_build
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    t0 = time.perf_counter()
    tables, arrays = TB.sf10_tables(args.seed, sf=args.sf)
    gold = None
    if not args.skip_check:
        q1, q6 = CS.golden_planner({**arrays, "l_tax": tables["lineitem"][
            "l_tax"].to_numpy()}, TD.days)
        gold = {1: q1, 6: q6, **CS.golden_joins(arrays, TD),
                **CS.golden_parts(arrays, tables["customer"], TD, TB),
                **CS.golden_rest(arrays, tables, TD, TB)}
    del arrays
    print(f"data{'' if gold is None else ' and goldens'} at "
          f"{CS.sf_of(tables)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    try:
        return run(args, torch, dev, tables, gold, queries, extra)
    finally:
        CS.io_reset()


def run(args, torch, dev, tables, gold, queries, extra) -> int:
    """The streams (and with --phase all of phase 15) over `tables`
    written as files; 1 if a query failed."""
    import chip_smoke as CS
    from spark_rapids_tpu_torch.exec import pipeline as PL
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.ops import grouped_window as GW
    from spark_rapids_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    CS.write_tpch_files(torch, dev, tables)
    print(f"files at {CS.sf_of(tables)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    failed = []
    single_s = 0.0
    runs = ([1] if args.single else []) + ([] if args.phase
                                           else [args.streams])
    for streams in runs:
        CS.reset_launches(GW, K)
        S.QueryScheduler.get().reset_stats()
        PL.reset_pipeline_stats()
        try:
            out = CS.throughput_test(torch, dev, tables, gold, streams, GW,
                                     K, queries, extra)
        except Exception as e:  # noqa: BLE001 — named, then exit 1
            failed.append(f"{streams} streams: {e!r}")
            print(f"runtime {streams} streams FAILED: {e!r}", flush=True)
            torch.cuda.empty_cache()
            continue
        collects = sum(v["collect"] for v in out["queries"].values())
        if streams == 1:
            single_s = collects
        print(f"runtime {streams} streams at {CS.sf_of(tables)} "
              f"(conf {extra}): stream "
              f"walls " + ", ".join(f"{w:.1f}" for _, w in sorted(
                  out["stream_wall"].items()))
              + f" s, together {out['wall']:.1f} s, collects "
              f"{collects:.1f} s, accelerates "
              f"{sum(v['accelerate'] for v in out['queries'].values()):.1f}"
              f" s; scheduler {S.QueryScheduler.get().stats()}; pipeline "
              f"{PL.pipeline_stats()}; launches {CS.launch_counts(GW, K)}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
    if args.phase:
        t0 = time.perf_counter()
        out = CS.runtime_phase(torch, dev, tables, gold, GW, K,
                               CS.kernel_cases(torch, dev, GW, K), single_s,
                               streams=args.streams)
        print(f"phase 15: {time.perf_counter() - t0:.1f} s; launches "
              f"{out['launches']}", flush=True)
    if failed:
        print("failed: " + "; ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
