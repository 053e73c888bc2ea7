#!/usr/bin/env python3
"""What a prefetch producer costs on one NVIDIA card, and where the port
runs one.  The port prefetches at the file scan alone
(spark_rapids_tpu_torch/exec/pipeline.py); the reference also prefetches
at coalesce and on both sides of the local exchange.  This script
measures, in one process:

  1. one pull of a one-batch iterator made inline, through a
     PrefetchIterator, and through a bare thread and queue (mean wall
     and process CPU over 300 pulls);
  2. ten TPC-DS queries at 20,000 store_sales rows (chip_smoke.py 13a's
     tables) and TPC-H Q18 and Q16 at SF1, in memory, one new plan each,
     under three settings: the pipeline off, the port's default (on: the
     file scan prefetches, so these plans start no producer), and "every
     break", where this script wraps coalesce's output, the exchange's
     map input and its reduce readers in maybe_prefetch as the reference
     does;
  3. TPC-H Q18 and Q3 at SF1 over the tables as files (chip_smoke.py
     14b's formats), the pipeline off and on.

Each setting's collects are timed with the process's and the calling
thread's CPU time; every result must equal the pipeline-off run's
(floats within rtol 1e-5, the rest exact).  Prints the card's name and
power limit first.

    python3 scripts/torch_prefetch_cost.py [--reps N]
"""
import argparse
import gc
import queue
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TPCDS = ("q3", "q7", "q19", "q42", "q52", "q55", "q96", "q26", "q5", "q27")
PULLS = 300


@contextmanager
def every_break():
    """Prefetch at coalesce and on both sides of the local exchange, as
    the reference does, for the duration."""
    from spark_rapids_tpu_torch.exec.coalesce import CoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.pipeline import maybe_prefetch
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    coalesce = CoalesceBatchesExec.process_partition
    exchange = ShuffleExchangeExec.execute_partitions

    def coalesce_ahead(self, batches):
        return maybe_prefetch(coalesce(self, batches), label="coalesce")

    def exchange_ahead(self):
        child_parts = self.child.execute_partitions
        self.child.execute_partitions = lambda: [maybe_prefetch(
            (b for it in child_parts() for b in it), label="exchange-map")]
        try:
            readers = exchange(self)  # runs the whole map side
        finally:
            del self.child.execute_partitions
        return [maybe_prefetch(r, label="exchange-reduce") for r in readers]

    CoalesceBatchesExec.process_partition = coalesce_ahead
    ShuffleExchangeExec.execute_partitions = exchange_ahead
    try:
        yield
    finally:
        CoalesceBatchesExec.process_partition = coalesce
        ShuffleExchangeExec.execute_partitions = exchange


def pull_cost(torch, dev) -> None:
    from spark_rapids_tpu_torch.exec.pipeline import PrefetchIterator

    def source():
        yield torch.ones(1024, device=dev) + 1

    def threaded():
        q: queue.Queue = queue.Queue(2)

        def produce():
            for x in source():
                q.put(x)
            q.put(None)
        t = threading.Thread(target=produce)
        t.start()
        yield from iter(q.get, None)
        t.join()

    ways = {"inline": source,
            "PrefetchIterator": lambda: PrefetchIterator(source(), depth=2),
            "bare thread": threaded}
    for _ in range(2):
        for name, make in ways.items():
            torch.cuda.synchronize(dev)
            t0, c0 = time.perf_counter(), time.process_time()
            for _ in range(PULLS):
                for x in make():
                    x.sum()
            torch.cuda.synchronize(dev)
            print(f"pull {name}: "
                  f"{(time.perf_counter() - t0) / PULLS * 1e6:.1f} us wall, "
                  f"{(time.process_time() - c0) / PULLS * 1e6:.1f} us "
                  f"process CPU", flush=True)


def timed(torch, dev, label: str, setting: str, fn):
    """fn() under `setting` ("off", "on" or "every"): its result and one
    printed line of wall, process CPU, calling-thread CPU and the
    pipeline's counters."""
    from spark_rapids_tpu_torch.exec import pipeline as PL
    gc.collect()
    torch.cuda.synchronize(dev)
    PL.reset_pipeline_stats()
    t0, c0, m0 = time.perf_counter(), time.process_time(), time.thread_time()
    with every_break() if setting == "every" else _nothing():
        out = fn(setting != "off")
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = PL.pipeline_stats()
    print(f"{label} {setting}: wall {wall:.3f} s, process CPU "
          f"{time.process_time() - c0:.3f} s, calling thread CPU "
          f"{time.thread_time() - m0:.3f} s, producers {st['producers']}, "
          f"stalls {st['stalls']}, consumer wait "
          f"{st['wait_ns'] / 1e9:.2f} s", flush=True)
    return out


@contextmanager
def _nothing():
    yield


def same(want: list, got: list, label: str) -> None:
    """Each frame of `got` equal to `want`'s: floats within rtol 1e-5
    (the f32 lanes' atomics add in no fixed order), the rest exact."""
    import pandas as pd
    for a, b in zip(want, got, strict=True):
        pd.testing.assert_frame_equal(
            a.reset_index(drop=True), b.reset_index(drop=True), rtol=1e-5,
            obj=label)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_prefetch_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    print(TB.card(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build()
    pull_cost(torch, dev)

    ds_tables = CS.workload_tables(CS.WL_CHECK_SEED, CS.WL_CHECK_SCALE)
    wl = CS.workload("tpcds")

    def tpcds(pipe: bool) -> list:
        conf = C.RapidsConf({**DB.BENCH_CONF, C.TEST_ENABLED.key: True,
                             C.PIPELINE_ENABLED.key: pipe})

        def run(plan):
            return collect(accelerate(plan, conf, device=dev), conf)
        return [run(wl.queries[q](wl.sources(ds_tables, 16), run))
                for q in TPCDS]

    tables, _ = TB.sf10_tables(0, sf=1.0)

    def tpch(queries, files: bool):
        def go(pipe: bool) -> list:
            return [CS.submit_tpch(
                torch, dev, q, tables,
                CS.tpch_conf(q, **{C.PIPELINE_ENABLED.key: pipe}), "",
                source=CS.file_sources(TD.SCHEMAS, TD.SCHEMAS)
                if files else None)[0] for q in queries]
        return go

    tpcds(False)  # warm: the process's first use of each op
    cases = [("tpcds10 at 20,000 rows", tpcds, ("off", "on", "every")),
             ("tpch q18,q16 SF1 in memory", tpch((18, 16), False),
              ("off", "on", "every"))]
    for label, fn, settings in cases:
        want = None
        for _ in range(args.reps):
            for setting in settings:
                got = timed(torch, dev, label, setting, fn)
                if want is None:
                    want = got
                same(want, got, f"{label} {setting}")
    CS.write_tpch_files(torch, dev, tables)
    try:
        fn = tpch((18, 3), True)
        want = None
        for _ in range(args.reps):
            for setting in ("off", "on"):
                got = timed(torch, dev, "tpch q18,q3 SF1 over files",
                            setting, fn)
                if want is None:
                    want = got
                same(want, got, f"tpch over files {setting}")
    finally:
        CS.io_reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
