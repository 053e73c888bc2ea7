#!/usr/bin/env python3
"""Where the time goes in spark_rapids_tpu_torch's join queries (TPC-H
Q3, Q4 and Q5 by default; Q7-Q10 with --queries 7,8,9,10) at scale
factor 10 on one NVIDIA card.

    python3 scripts/profile_torch_joins.py [--seed N] [--queries 3,4,5]
        [--partitions 16] [--no-profiler]

Builds the eight tables of models/tpch_bench.py `sf10_tables`, as
chip_smoke.py's phases 7 and 8 do, and for each query accelerates once and
collects once cold, then:
  1. collects once more with every exec's batch iterators timed (the
     device synchronized after each batch, so device work lands on the
     exec that queued it): per exec its inclusive and exclusive wall
     time and its output batches, and per HashJoinExec its lane, its
     build side's rows and capacity, and its probe batches and their
     summed capacity;
  2. profiles one hot collect with torch.profiler (CPU and CUDA
     activities): wall, device busy, idle share, the top device kernels
     and the top host events by self time (scripts/profile_torch_q1.py's
     table).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def timed_tree(torch, plan):
    """Wrap every exec's execute_partitions so the call and each batch
    it yields are timed (device synchronized).  Returns {exec:
    [inclusive s, batches]} and a restore function."""
    stats: dict = {}
    originals = []

    def walk(node):
        yield node
        for c in node.children:
            yield from walk(c)

    def timed(node, it):
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                stats[node][0] += time.perf_counter() - t0
                return
            torch.cuda.synchronize()
            stats[node][0] += time.perf_counter() - t0
            stats[node][1] += 1
            yield b

    # collect() pulls the root's execute_columnar; a parent pulls its
    # children's execute_partitions
    for node in walk(plan):
        if node in stats:  # a shared subtree (CommonSubplanExec) again
            continue
        stats[node] = [0.0, 0]
        if node is plan:
            orig = node.execute_columnar
            node.execute_columnar = (
                lambda node=node, orig=orig: timed(node, orig()))
            originals.append((node, "execute_columnar"))
        else:
            # an exchange runs its whole map side when asked for its
            # partitions: that call is timed too
            def partitions(node=node, orig=node.execute_partitions):
                t0 = time.perf_counter()
                its = orig()
                torch.cuda.synchronize()
                stats[node][0] += time.perf_counter() - t0
                return [timed(node, it) for it in its]
            node.execute_partitions = partitions
            originals.append((node, "execute_partitions"))

    def restore():
        for node, attr in originals:
            delattr(node, attr)
    return stats, restore


def probe_stats(J):
    """Per HashJoinExec: its probe batches' count and summed capacity,
    and its build batch's rows and capacity, recorded as it runs."""
    seen: dict = {}
    match = J.HashJoinExec._match

    def counting(self, build, probe, want_bmatched):
        s = seen.setdefault(self, {"probe_batches": 0, "probe_cap": 0})
        s["probe_batches"] += 1
        s["probe_cap"] += probe.capacity
        s["build_rows"], s["build_cap"] = build.num_rows, build.capacity
        return match(self, build, probe, want_bmatched)
    J.HashJoinExec._match = counting

    def restore():
        J.HashJoinExec._match = match
    return seen, restore


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", default="3,4,5")
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--no-profiler", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_joins: no CUDA device", file=sys.stderr)
        return 2
    from profile_torch_q1 import profiled

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    dev = torch.device("cuda", 0)
    print(TB.card(), flush=True)
    cuda_build.build()
    t0 = time.perf_counter()
    tables, _ = TB.sf10_tables(args.seed)
    print(f"sf10_tables: {time.perf_counter() - t0:.1f} s", flush=True)
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    for q in map(int, args.queries.split(",")):
        plan = accelerate(QUERIES[q](TD.sources(tables, args.partitions),
                                     None), conf, device=dev)
        t0 = time.perf_counter()
        collect(plan, conf)
        print(f"== q{q}: cold collect {time.perf_counter() - t0:.3f} s",
              flush=True)
        stats, restore = timed_tree(torch, plan)
        probes, restore_probes = probe_stats(J)
        t0 = time.perf_counter()
        collect(plan, conf)
        wall = time.perf_counter() - t0
        restore()
        restore_probes()
        print(f"== q{q}: timed collect {wall:.3f} s (device synchronized "
              f"per batch); per exec: inclusive s, exclusive s, batches",
              flush=True)

        def show(node, depth):
            incl, n = stats[node]
            # a join pulls its build side past the coalesce the planner
            # put above it, as the reference's does
            pulled = ([node._probe, node._build]
                      if isinstance(node, J.HashJoinExec) else node.children)
            excl = incl - sum(stats[c][0] for c in pulled)
            extra = ""
            if isinstance(node, J.HashJoinExec):
                extra = f"  lane={node.lane} {probes.get(node, {})}"
            print(f"  {incl:9.3f} {excl:9.3f} {n:5d}  "
                  f"{'  ' * depth}{node.describe()[:90]}{extra}",
                  flush=True)
            for c in node.children:
                show(c, depth + 1)
        show(plan, 0)
        if not args.no_profiler:
            profiled(torch, lambda: collect(plan, conf), f"q{q}_hot")
        del plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
