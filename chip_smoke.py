#!/usr/bin/env python3
"""GPU smoke run of spark_rapids_tpu_torch: TPC-H Q1 and Q3-Q10 at scale
factor 10 (59,986,052 lineitem rows in phases 4-6, TPC-H spec 4.2.5) on
one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (exit code 1, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from spark_rapids_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch twin on the card at the
     main path's shapes (counts exact; f32 sums rtol 1e-5 for q1_fused
     and 1e-4 for grouped_sum and window_group_sums, which add in another
     order than the twin's; window_group_sums exact on every measure of
     integers whose absolute sum is below 2^24, which f32 holds exactly,
     and at planner Q1's partial aggregate's shape on all of them),
     check that grouped_sum's tiers A and B and window_group_sums give
     the same bits on a second call, and time the
     wrapper (`ms`), the kernel alone (`device_ms`, torch.profiler's CUDA
     time over a batch of launches), the plain twin and, where one
     exists, the single PyTorch call that computes the same function;
  4. run Q1 through the exec tree, q1_plan(...).collect(), over 8 batches
     under the TPC bench conf, against a float64 numpy golden (keys and
     counts exact, sums and averages rtol 1e-3: f32 accumulation), with
     each kernel's launches counted over a cold and a hot collect; then
     time the cold collect of a second plan instance, which splits the
     first cold collect into the process's first use of the torch ops
     and the plan's own probe and deopt re-run;
  5. run the stacked Q1 step, build_q1_fused_kernel, on the same data
     against the same golden (rtol 1e-5);
  6. run TPC-H Q1 and Q6 as a user submits them, through the planner,
     collect(accelerate(QUERIES[n](sources(tables, 16), run), conf)),
     over all 16 columns of SF10 lineitem (tpch_bench.sf10_lineitem_frame)
     under the TPC bench conf with spark.rapids.sql.test.enabled, so a
     CPU island anywhere in the plan raises: the exec tree must be the
     planner's (partial aggregate with the filter fused, exchanges of 16
     partitions), the results must hold against a float64 numpy golden
     (keys and counts exact, sums and averages rtol 1e-3: the banded
     lane adds in f32), and window_group_sums must launch during the Q1
     collects; accelerate (with the upload) and collect are timed apart,
     cold and hot;
  7. run TPC-H Q3, Q4 and Q5 (joins: HashJoinExec, SortedTopNExec) the
     same way over the eight TPC-H tables at SF10, linked by dbgen's
     keys (tpch_bench.sf10_tables), 16 partitions: the exec trees must
     be the planner's, every join's lane and its probe batches are
     named and the kernels' launches counted, and the results must hold
     against a float64 numpy golden built from index arrays (keys,
     dates, counts and order exact; revenues rtol 1e-3); accelerate and
     collect are timed apart, cold and hot, and each query's peak
     device memory printed; then the inputs of the widest
     window_group_sums call of each query's hot collect are held
     against the twin as in phase 3 (rtol 1e-4, exact on measures of
     integers whose sums f32 holds exactly) and timed (`device_ms`
     from the profiler, or where it records no device activity from
     CUDA events queued behind a sleep kernel);
  8. run TPC-H Q7, Q8, Q9 and Q10 (Year, CASE WHEN, Contains, Divide,
     part and partsupp, Q10's seven group keys) as phase 7 runs Q3-Q5,
     against float64 goldens (keys, years, names, counts and order
     exact; revenues, profits and market shares rtol 1e-3), with the
     same window_group_sums checks; then time LIKE '%green%' over 2^20
     p_name values, which must select the rows Contains does;
  9. print the kernels line and, last, the device line.
Every phase prints its wall time.  Without a CUDA device, or without
the package beside it, it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
Q1_NAMES = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_price", "avg_disc", "count_order"]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call of fn(), each call between two CUDA
    events queued behind a sleep kernel: the stream is busy while the
    host queues the call, so the events bracket the device work alone
    (the wrapper's host time is hidden)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)  # ~1 ms of the card's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def device_ms(torch, fn, kernel: str, reps: int, strict: bool = True):
    """Mean device time of one launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `reps` calls of fn().
    Where the profiler sees no such launch, raise if `strict`, else
    print what it saw and return None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    times = [e.time_range.elapsed_us() for e in events
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not times and not strict:
        names = sorted({e.name[:60] for e in events})[:8]
        print(f"device_ms of {kernel}: not measured, the profiler saw "
              f"{len(events)} events, "
              f"{sum(e.device_type == DeviceType.CUDA for e in events)} "
              f"on the device ({names})", flush=True)
        return None
    require(bool(times), f"the profiler saw no {kernel} launch")
    return sum(times) / len(times) / 1e3


def kernel_text(name: str, k: dict) -> str:
    """One kernel measurement as a line of text."""
    events = (f" (events behind a sleep kernel: {k['event_ms']:.4f})"
              if "event_ms" in k else "")
    return (f"kernel {name} [{k['shape']}]: max_abs_err "
            f"{k['max_abs_err']:.3g} max_rel_err {k['max_rel_err']:.3g} "
            f"(rtol {k['rtol']}), ms {k['ms']:.4f}, device_ms "
            f"{k['device_ms']:.4f}{events}, plain_ms {k['plain_ms']:.4f}, "
            f"bound_ms {k['bound_ms']:.4f} ({k['bound_by']}), library_ms "
            f"{k['library_ms']}")


def same_bits(a, b, what: str) -> None:
    for x, y in zip(a, b):
        if not x.equal(y):
            raise RuntimeError(f"{what}: a second call gave other bits")


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def golden_q1(batches_np) -> dict:
    """float64 numpy Q1 per group slot flag*2+status: sums, avgs, count."""
    acc = np.zeros((6, 6))
    for cols in batches_np:
        keep = cols["l_shipdate"] <= 10471
        g = (cols["l_returnflag"] * 2 + cols["l_linestatus"])[keep]
        qty = cols["l_quantity"][keep].astype(np.float64)
        price = cols["l_extendedprice"][keep].astype(np.float64)
        disc = cols["l_discount"][keep].astype(np.float64)
        tax = cols["l_tax"][keep].astype(np.float64)
        dp = price * (1.0 - disc)
        ch = dp * (1.0 + tax)
        for j, w in enumerate((qty, price, dp, ch, disc, None)):
            acc[:, j] += np.bincount(g, weights=w, minlength=6)[:6]
    return {"sums": acc[:, :5], "count": acc[:, 5]}


Q1_TREE = ["SortExec", "CoalesceBatchesExec", "ShuffleExchangeExec",
           "HashAggregateExec", "ShuffleExchangeExec", "HashAggregateExec",
           "LocalBatchSource"]
Q6_TREE = ["HashAggregateExec", "ShuffleExchangeExec", "HashAggregateExec",
           "LocalBatchSource"]


def tree(plan) -> list:
    """(class name, describe()) of every exec, in tree order."""
    return [(type(plan).__name__, plan.describe())] + [
        t for c in plan.children for t in tree(c)]


def golden_planner(a: dict, days) -> tuple[dict, float]:
    """float64 numpy Q1 per (returnflag, linestatus) code pair present,
    in key order, and Q6's revenue, over sf10_lineitem_frame's arrays."""
    keep = a["l_shipdate"] <= days("1998-09-02")
    g = (a["l_returnflag"].astype(np.int64) * 2 + a["l_linestatus"])[keep]
    qty, price = a["l_quantity"][keep], a["l_extendedprice"][keep]
    disc, tax = a["l_discount"][keep], a["l_tax"][keep]
    dp = price * (1.0 - disc)
    cols = [np.bincount(g, weights=w, minlength=6)
            for w in (qty, price, dp, dp * (1.0 + tax), disc)]
    cnt = np.bincount(g, minlength=6)
    live = np.flatnonzero(cnt)
    q1 = {"keys": [("ANR"[i // 2], "FO"[i % 2]) for i in live],
          "count": cnt[live],
          "want": np.column_stack([c[live] for c in cols[:4]]
                                  + [cols[0][live] / cnt[live],
                                     cols[1][live] / cnt[live],
                                     cols[4][live] / cnt[live]])}
    sel = ((a["l_shipdate"] >= days("1994-01-01"))
           & (a["l_shipdate"] < days("1995-01-01"))
           & (a["l_discount"] >= 0.05) & (a["l_discount"] <= 0.07)
           & (a["l_quantity"] < 24.0))
    return q1, float(np.sum(a["l_extendedprice"][sel]
                            * a["l_discount"][sel]))


def planner_phase(torch, dev, seed: int, GW) -> dict:
    """Phase 6: planner Q1 and Q6 at SF10 (see the module docstring)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    t0 = time.perf_counter()
    frame, arrays = TB.sf10_lineitem_frame(seed)
    tables = {"lineitem": frame}
    print(f"planner data: {len(frame)} lineitem rows, 16 columns, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    q1_gold, q6_gold = golden_planner(arrays, TD.days)
    del arrays
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    n = TB.SF10_PARTITIONS
    out = {"rel": 0.0}
    GW.window_group_sums.launches = 0
    for q in (1, 6):
        for run in ("cold", "hot"):
            cpu_plan = QUERIES[q](TD.sources(tables, n), None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = accelerate(cpu_plan, conf, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            df = collect(plan, conf)
            t2 = time.perf_counter()
            got = tree(plan)
            require([name for name, _ in got] == (Q1_TREE if q == 1
                                                  else Q6_TREE),
                    f"planner q{q} exec tree: {got}")
            exchanges = [d for name, d in got
                         if name == "ShuffleExchangeExec"]
            require(exchanges == (
                [f"ShuffleExchangeExec(RangePartitioning, n={n})",
                 f"ShuffleExchangeExec(HashPartitioning, n={n})"] if q == 1
                else ["ShuffleExchangeExec(SinglePartitioning, n=1)"]),
                f"planner q{q} exchanges: {exchanges}")
            require("fused=[Filter]" in got[-2][1],
                    f"planner q{q} partial aggregate: {got[-2][1]}")
            if q == 1:
                require(list(zip(df["l_returnflag"], df["l_linestatus"]))
                        == q1_gold["keys"], "planner Q1 group keys differ")
                require(np.array_equal(df["count_order"].to_numpy(),
                                       q1_gold["count"]),
                        "planner Q1 counts differ")
                vals = df[Q1_NAMES[:7]].to_numpy(np.float64)
                rel = float(np.max(np.abs(vals - q1_gold["want"])
                                   / np.abs(q1_gold["want"])))
                out["q1_launches"] = GW.window_group_sums.launches
            else:
                require(len(df) == 1, "planner Q6 is one row")
                rel = abs(float(df["revenue"][0]) - q6_gold) / abs(q6_gold)
            require(rel <= 1e-3, f"planner q{q} rel err {rel}")
            out["rel"] = max(out["rel"], rel)
            print(f"planner q{q} SF10 {run}: accelerate {t1 - t0:.3f} s "
                  f"(with the upload), collect {t2 - t1:.3f} s, rel err "
                  f"{rel:.3g}", flush=True)
            del cpu_plan, plan, df
    require(out["q1_launches"] >= 1,
            "window_group_sums never launched in planner Q1")
    print(f"planner SF10 against the float64 golden: keys and counts "
          f"exact, max rel err {out['rel']:.3g}; planner Q1 "
          f"window_group_sums launches {out['q1_launches']}", flush=True)
    return out


#: exec trees of the join queries at 16 partitions, in tree order
JOIN_TREES = {
    3: ["SortedTopNExec", "HashAggregateExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "CoalesceBatchesExec", "FilterExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "CoalesceBatchesExec",
        "FilterExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "CoalesceBatchesExec", "FilterExec",
        "LocalBatchSource"],
    4: ["SortExec", "CoalesceBatchesExec", "HashAggregateExec",
        "HashJoinExec", "ShuffleExchangeExec", "CoalesceBatchesExec",
        "FilterExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "CoalesceBatchesExec", "FilterExec",
        "LocalBatchSource"],
    5: ["SortExec", "CoalesceBatchesExec", "HashAggregateExec",
        "HashJoinExec", "HashJoinExec", "ShuffleExchangeExec",
        "HashJoinExec", "ShuffleExchangeExec", "HashJoinExec",
        "ShuffleExchangeExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "CoalesceBatchesExec", "FilterExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "LocalBatchSource", "CoalesceBatchesExec", "HashJoinExec",
        "ShuffleExchangeExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "CoalesceBatchesExec", "FilterExec",
        "LocalBatchSource"],
    7: ["SortExec", "CoalesceBatchesExec", "HashAggregateExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "HashJoinExec", "ShuffleExchangeExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "CoalesceBatchesExec", "FilterExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "ProjectExec",
        "CommonSubplanExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "ProjectExec", "CommonSubplanExec",
        "LocalBatchSource"],
    8: ["SortExec", "CoalesceBatchesExec", "ProjectExec", "HashAggregateExec",
        "HashJoinExec", "ShuffleExchangeExec", "HashJoinExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "HashJoinExec", "ShuffleExchangeExec", "HashJoinExec",
        "ShuffleExchangeExec", "CoalesceBatchesExec", "FilterExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "CoalesceBatchesExec", "FilterExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "HashJoinExec", "ShuffleExchangeExec",
        "ProjectExec", "CommonSubplanExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "CoalesceBatchesExec",
        "FilterExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "ProjectExec", "CommonSubplanExec",
        "LocalBatchSource"],
    9: ["SortExec", "CoalesceBatchesExec", "HashAggregateExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "HashJoinExec", "ShuffleExchangeExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "CoalesceBatchesExec", "FilterExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "LocalBatchSource"],
    10: ["SortedTopNExec", "HashAggregateExec", "HashJoinExec",
        "ShuffleExchangeExec", "HashJoinExec", "ShuffleExchangeExec",
        "HashJoinExec", "ShuffleExchangeExec", "LocalBatchSource",
        "CoalesceBatchesExec", "ShuffleExchangeExec", "CoalesceBatchesExec",
        "FilterExec", "LocalBatchSource", "CoalesceBatchesExec",
        "ShuffleExchangeExec", "CoalesceBatchesExec", "FilterExec",
        "LocalBatchSource", "CoalesceBatchesExec", "ShuffleExchangeExec",
        "LocalBatchSource"],
}
JOIN_RTOL = 1e-3


def golden_joins(a: dict, TD) -> dict:
    """float64 numpy Q3, Q4 and Q5 over sf10_tables' arrays, from index
    arrays: order_row maps an order key to its row, c_custkey and
    s_suppkey are row + 1, and sums are bincounts with weights."""
    okey, odate = a["o_orderkey"], a["o_orderdate"]
    n_orders = len(okey)
    order_row = np.full(int(okey.max()) + 1, -1, np.int32)
    order_row[okey] = np.arange(n_orders, dtype=np.int32)
    lo = order_row[a["l_orderkey"]]
    cust = a["o_custkey"] - 1
    rev = a["l_extendedprice"] * (1.0 - a["l_discount"])
    out = {}
    # Q3: BUILDING customers' orders before the date, lines shipped after
    d = TD.days("1995-03-15")
    o_ok = (odate < d) & (a["c_mktsegment"][cust]
                          == TD.SEGMENTS.index("BUILDING"))
    l_ok = (a["l_shipdate"] > d) & o_ok[lo]
    r3 = np.bincount(lo[l_ok], weights=rev[l_ok], minlength=n_orders)
    hit = np.flatnonzero(np.bincount(lo[l_ok], minlength=n_orders))
    top = hit[np.lexsort((odate[hit], -r3[hit]))][:11]
    out[3] = {"orderkey": okey[top], "orderdate": odate[top],
              "revenue": r3[top]}
    # Q4: orders of the quarter with a line received after its commit
    late = np.bincount(lo[a["l_commitdate"] < a["l_receiptdate"]],
                       minlength=n_orders) > 0
    sel = ((odate >= TD.days("1993-07-01"))
           & (odate < TD.days("1993-10-01")) & late)
    cnt = np.bincount(a["o_orderpriority"][sel],
                      minlength=len(TD.PRIORITIES))
    out[4] = {"priority": [p for p, c in zip(TD.PRIORITIES, cnt) if c],
              "count": cnt[cnt > 0]}
    # Q5: 1994's lines whose supplier shares the customer's nation, in
    # ASIA
    sn = a["s_nationkey"][a["l_suppkey"] - 1]
    ok = ((odate >= TD.days("1994-01-01")) & (odate < TD.days("1995-01-01")))
    ok = (ok[lo] & (sn == a["c_nationkey"][cust[lo]])
          & (a["n_regionkey"][sn] == TD.REGIONS.index("ASIA")))
    r5 = np.bincount(sn[ok], weights=rev[ok], minlength=len(TD.NATIONS))
    live = np.flatnonzero(np.bincount(sn[ok], minlength=len(TD.NATIONS)))
    live = live[np.argsort(-r5[live], kind="stable")]
    out[5] = {"nation": [TD.NATIONS[i][0] for i in live],
              "revenue": r5[live]}
    return out


def check_join_query(q: int, df, gold: dict) -> float:
    """Raise unless `df` is query q's golden answer; return the largest
    relative error of its revenues.  Q3: ten distinct orders, each the
    golden's row at its rank or a row whose revenue is within JOIN_RTOL
    of that rank's (a near-tie may swap, the 11th row included), with
    its date exact; Q4: priorities and counts exact; Q5: nations and
    their order exact."""
    if q == 4:
        require(list(df["o_orderpriority"]) == gold["priority"],
                f"Q4 priorities {list(df['o_orderpriority'])}")
        require(np.array_equal(df["order_count"].to_numpy(np.int64),
                               gold["count"]), "Q4 counts differ")
        return 0.0
    if q == 5:
        require(list(df["n_name"]) == gold["nation"],
                f"Q5 nations {list(df['n_name'])} != {gold['nation']}")
        want = gold["revenue"]
        got = df["revenue"].to_numpy(np.float64)
    else:
        keys = df["l_orderkey"].to_numpy(np.int64)
        require(len(keys) == min(10, len(gold["orderkey"]))
                and len(set(keys)) == len(keys), f"Q3 rows {keys}")
        require(np.all(df["o_shippriority"].to_numpy() == 0),
                "Q3 shippriority")
        g = gold["revenue"]
        want = []
        for i, k in enumerate(keys):
            j = np.flatnonzero(gold["orderkey"] == k)
            require(len(j) == 1, f"Q3 rank {i}: order {k} is not the "
                    f"golden's {gold['orderkey'][:10]}")
            j = int(j[0])
            require(abs(g[j] - g[i]) <= JOIN_RTOL * abs(g[i]),
                    f"Q3 rank {i}: order {k} is the golden's rank {j}")
            require(int(df["o_orderdate"].iloc[i]) == gold["orderdate"][j],
                    f"Q3 order {k} date")
            want.append(g[j])
        want = np.asarray(want)
        got = df["revenue"].to_numpy(np.float64)
    rel = float(np.max(np.abs(got - want) / np.abs(want))) if len(want) \
        else 0.0
    require(rel <= JOIN_RTOL, f"Q{q} revenue rel err {rel}")
    return rel


def year_of(days: np.ndarray) -> np.ndarray:
    """Calendar years of DATE32 days."""
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _grouped(codes: np.ndarray, weights: np.ndarray):
    """(distinct codes, their sums): a float64 group-by."""
    keys, inv = np.unique(codes, return_inverse=True)
    return keys, np.bincount(inv, weights=weights, minlength=len(keys))


def golden_parts(a: dict, customer, TD, TB) -> dict:
    """float64 numpy Q7, Q8, Q9 and Q10 over sf10_tables' arrays, from
    index arrays as golden_joins: p_partkey, c_custkey and s_suppkey
    are row + 1, and the partsupp rows of part p are 4 (p - 1) + i.
    Q10's printed customer strings come from the `customer` frame."""
    okey, odate = a["o_orderkey"], a["o_orderdate"]
    order_row = np.full(int(okey.max()) + 1, -1, np.int64)
    order_row[okey] = np.arange(len(okey))
    lo = order_row[a["l_orderkey"]]
    l_odate = odate[lo]
    cust = a["o_custkey"][lo] - 1
    cn = a["c_nationkey"][cust]
    sn = a["s_nationkey"][a["l_suppkey"] - 1]
    vol = a["l_extendedprice"] * (1.0 - a["l_discount"])
    names = [n for n, _ in TD.NATIONS]
    nat = {n: i for i, n in enumerate(names)}
    out = {}
    # Q7: FRANCE and GERMANY shipping to each other, 1995-1996
    ship = a["l_shipdate"]
    fr, ge = nat["FRANCE"], nat["GERMANY"]
    ok = ((ship >= TD.days("1995-01-01")) & (ship <= TD.days("1996-12-31"))
          & (((sn == fr) & (cn == ge)) | ((sn == ge) & (cn == fr))))
    codes, rev = _grouped((sn[ok] * 25 + cn[ok]) * 10_000
                          + year_of(ship[ok]), vol[ok])
    rows = [(names[c // 250_000], names[c // 10_000 % 25], c % 10_000)
            for c in codes.tolist()]
    order = sorted(range(len(rows)), key=rows.__getitem__)
    out[7] = {"keys": [rows[i] for i in order], "revenue": rev[order]}
    # Q8: BRAZIL's share of AMERICA's ECONOMY ANODIZED STEEL, 1995-1996
    econ = (TD.TYPE_S1.index("ECONOMY") * 25 + TD.TYPE_S2.index("ANODIZED")
            * 5 + TD.TYPE_S3.index("STEEL"))
    ok = ((a["p_type"][a["l_partkey"] - 1] == econ)
          & (l_odate >= TD.days("1995-01-01"))
          & (l_odate <= TD.days("1996-12-31"))
          & (a["n_regionkey"][cn] == TD.REGIONS.index("AMERICA")))
    years, total = _grouped(year_of(l_odate[ok]), vol[ok])
    _, brazil = _grouped(year_of(l_odate[ok]),
                         np.where(sn[ok] == nat["BRAZIL"], vol[ok], 0.0))
    out[8] = {"year": years, "share": brazil / total}
    # Q9: green parts' profit by supplier nation and year; a line joins
    # every partsupp row of its (part, supplier), so the sum runs over
    # the 4 supplier numbers that give its supplier
    lp = a["l_partkey"]
    ok = a["p_green"][lp - 1]
    cost = np.zeros(len(lp))
    rows_hit = np.zeros(len(lp))
    for i in range(4):
        hit = TB.part_suppkey(lp, i, len(a["s_nationkey"])) == a["l_suppkey"]
        cost += np.where(hit, a["ps_supplycost"][(lp - 1) * 4 + i], 0.0)
        rows_hit += hit
    amount = vol * rows_hit - cost * a["l_quantity"]
    codes, profit = _grouped(sn[ok] * 10_000 + year_of(l_odate[ok]),
                             amount[ok])
    rows = [(names[c // 10_000], c % 10_000) for c in codes.tolist()]
    order = sorted(range(len(rows)),
                   key=lambda i: (rows[i][0], -rows[i][1]))
    out[9] = {"keys": [rows[i] for i in order], "profit": profit[order]}
    # Q10: the 20 customers with the most revenue from lines returned
    # (flag R) of the orders of 1993's fourth quarter
    ok = ((l_odate >= TD.days("1993-10-01"))
          & (l_odate < TD.days("1994-01-01")) & (a["l_returnflag"] == 2))
    n_cust = len(a["c_nationkey"])
    r10 = np.bincount(cust[ok], weights=vol[ok], minlength=n_cust)
    hit = np.flatnonzero(np.bincount(cust[ok], minlength=n_cust))
    top = hit[np.lexsort((hit, -r10[hit]))][:21]
    rows = customer.iloc[top]
    out[10] = {"custkey": top + 1, "revenue": r10[top],
               "nation": [names[i] for i in a["c_nationkey"][top]],
               "acctbal": a["c_acctbal"][top],
               **{c: rows[c].astype(str).tolist() for c in (
                   "c_name", "c_phone", "c_address", "c_comment")}}
    return out


def check_part_query(q: int, df, gold: dict) -> float:
    """Raise unless `df` is query q's golden answer; return the largest
    relative error of its sums.  Q7-Q9: every key, year and the order
    exact; Q10: twenty distinct customers, each the golden's row at its
    rank or one whose revenue is within JOIN_RTOL of that rank's (a
    near-tie may swap), with its name, balance, phone, nation, address
    and comment exact."""
    if q == 7:
        got_keys = list(zip(df["supp_nation"], df["cust_nation"],
                            df["l_year"].astype(int)))
        require(got_keys == gold["keys"], f"Q7 keys {got_keys}")
        want, got = gold["revenue"], df["revenue"].to_numpy(np.float64)
    elif q == 8:
        require(list(df["o_year"].astype(int)) == gold["year"].tolist(),
                f"Q8 years {list(df['o_year'])}")
        want, got = gold["share"], df["mkt_share"].to_numpy(np.float64)
    elif q == 9:
        got_keys = list(zip(df["nation"], df["o_year"].astype(int)))
        require(got_keys == gold["keys"], "Q9 nations and years differ")
        want, got = gold["profit"], df["sum_profit"].to_numpy(np.float64)
    else:
        keys = df["c_custkey"].to_numpy(np.int64)
        require(len(keys) == min(20, len(gold["custkey"]))
                and len(set(keys)) == len(keys), f"Q10 rows {keys}")
        g = gold["revenue"]
        want = []
        for i, k in enumerate(keys):
            j = np.flatnonzero(gold["custkey"] == k)
            require(len(j) == 1, f"Q10 rank {i}: customer {k} is not the "
                    f"golden's {gold['custkey'][:20]}")
            j = int(j[0])
            require(abs(g[j] - g[i]) <= JOIN_RTOL * abs(g[i]),
                    f"Q10 rank {i}: customer {k} is the golden's rank {j}")
            row = df.iloc[i]
            require(float(row["c_acctbal"]) == gold["acctbal"][j]
                    and row["n_name"] == gold["nation"][j]
                    and all(row[c] == gold[c][j] for c in (
                        "c_name", "c_phone", "c_address", "c_comment")),
                    f"Q10 customer {k}: printed columns differ")
            want.append(g[j])
        want = np.asarray(want)
        got = df["revenue"].to_numpy(np.float64)
    require(len(got) == len(want), f"Q{q} has {len(got)} rows, the golden "
            f"{len(want)}")
    # a share of 0 must come out as 0
    rel = float(np.max(np.abs(got - want) / np.maximum(
        np.abs(want), np.finfo(np.float64).tiny))) if len(want) else 0.0
    require(rel <= JOIN_RTOL, f"Q{q} rel err {rel}")
    return rel


def recording(calls: list, GW):
    """A stand-in for the aggregate's window_group_sums that passes each
    call on and keeps a copy of the inputs of the widest CUDA call (the
    first of the largest capacity) in `calls`: [gid, vals, out_cap]."""
    def call(gid, vals, *, out_cap: int, capacity: int):
        if gid.is_cuda and (not calls or capacity > calls[0].numel()):
            calls[:] = [gid.clone(), [v.clone() for v in vals], out_cap]
        return GW.window_group_sums(gid, vals, out_cap=out_cap,
                                    capacity=capacity)
    return call


def recording_grouped(calls: list, K):
    """The same for the aggregate's grouped_sum (the dictionary lane):
    [keys, vals, num_rows, n_groups] of the widest CUDA call."""
    def call(keys, vals, num_rows, *, n_groups: int, capacity: int):
        if keys.is_cuda and (not calls or capacity > calls[0].numel()):
            calls[:] = [keys.clone(), [v.clone() for v in vals],
                        int(num_rows), n_groups]
        return K.grouped_sum(keys, vals, num_rows, n_groups=n_groups,
                             capacity=capacity)
    return call


def join_phase(torch, dev, tables, gold: dict, GW, K) -> dict:
    """Phases 7 and 8: the TPC-H queries of `gold` ({query: golden}) at
    SF10 over `tables` (see the module docstring).  out["calls"][q]
    holds the inputs of the widest window_group_sums call of query q's
    hot collect."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    n = TB.SF10_PARTITIONS
    out = {"rel": 0.0, "window_group_sums": {}, "grouped_sum": {},
           "calls": {}, "grouped_calls": {}, "peak_gb_by_query": {}}
    torch.cuda.reset_peak_memory_stats(dev)
    for q in gold:
        torch.cuda.reset_peak_memory_stats(dev)
        for run in ("cold", "hot"):
            calls: list = []
            gcalls: list = []
            if run == "hot":
                AGG.window_group_sums = recording(calls, GW)
                AGG.grouped_sum = recording_grouped(gcalls, K)
            cpu_plan = QUERIES[q](TD.sources(tables, n), None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = accelerate(cpu_plan, conf, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            GW.window_group_sums.launches = 0
            K.grouped_sum.launches = 0
            J.sort_merge_lane.launches = J.dense_lane.launches = 0
            df = collect(plan, conf)
            t2 = time.perf_counter()
            launches = {"window_group_sums": GW.window_group_sums.launches,
                        "grouped_sum": K.grouped_sum.launches}
            probes = {"sort-merge": J.sort_merge_lane.launches,
                      "dense": J.dense_lane.launches}
            AGG.window_group_sums = GW.window_group_sums
            AGG.grouped_sum = K.grouped_sum
            if calls:
                out["calls"][q] = calls
            if gcalls:
                out["grouped_calls"][q] = gcalls
            got = tree(plan)
            require([name for name, _ in got] == JOIN_TREES[q],
                    f"q{q} exec tree: {got}")
            exchanges = {d for name, d in got
                         if name == "ShuffleExchangeExec"}
            require(exchanges == {
                f"ShuffleExchangeExec(HashPartitioning, n={n})"},
                f"q{q} exchanges: {exchanges}")
            lanes = [j.lane for j in walk(plan)
                     if isinstance(j, J.HashJoinExec)]
            require(all(lanes), f"q{q}: a join never ran: {lanes}")
            rel = (check_join_query(q, df, gold[q]) if q < 7
                   else check_part_query(q, df, gold[q]))
            out["rel"] = max(out["rel"], rel)
            for k, v in launches.items():
                out[k][f"q{q}_{run}"] = v
            print(f"join q{q} SF10 {run}: accelerate {t1 - t0:.3f} s "
                  f"(with the upload), collect {t2 - t1:.3f} s, rel err "
                  f"{rel:.3g}, join lanes {lanes}, probe batches "
                  f"{probes}, launches {launches}", flush=True)
            del cpu_plan, plan, df
        out["peak_gb_by_query"][q] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
    out["peak_gb"] = max(out["peak_gb_by_query"].values())
    peaks = {k: round(v, 2) for k, v in out["peak_gb_by_query"].items()}
    print(f"join queries {list(gold)} SF10 against the float64 golden: "
          f"keys, dates, counts and order exact, max rel err "
          f"{out['rel']:.3g}; peak device memory {out['peak_gb']:.2f} GiB "
          f"(by query {peaks})", flush=True)
    return out


def like_case(torch, dev, part, green: np.ndarray) -> dict:
    """LIKE '%green%' over the first 2^20 p_name values on the card:
    the same rows as Contains and as sf10_tables' green mask, and the
    time of each."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.base import make_eval_context
    from spark_rapids_tpu_torch.exprs.base import col, lit
    from spark_rapids_tpu_torch.exprs.string_fns import Contains, Like
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    rows = min(1 << 20, len(part))
    schema = T.Schema.of(("p_name", T.STRING))
    batch = batch_from_df(part[["p_name"]].iloc[:rows], schema, device=dev)
    ctx = make_eval_context(batch.columns, batch.capacity, rows)
    like = Like(col("p_name"), lit("%green%")).bind(schema)
    contains = Contains(col("p_name"), lit("green")).bind(schema)
    got = like.eval(ctx).data[:rows]
    require(torch.equal(got, contains.eval(ctx).data[:rows]),
            "LIKE '%green%' and Contains differ")
    require(np.array_equal(got.cpu().numpy(), green[:rows]),
            "LIKE '%green%' differs from the p_name green mask")
    return {"rows": rows, "char_cap": batch.columns[0].char_cap,
            "ms": cuda_ms(torch, lambda: like.eval(ctx), 5),
            "contains_ms": cuda_ms(torch, lambda: contains.eval(ctx), 5)}


def walk(plan):
    yield plan
    for c in plan.children:
        yield from walk(c)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
        from spark_rapids_tpu_torch.models import tpch
        from spark_rapids_tpu_torch.models import tpch_bench as TB
        from spark_rapids_tpu_torch.ops import cuda_build
        from spark_rapids_tpu_torch.ops import grouped_window as GW
        from spark_rapids_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the spark_rapids_tpu_torch package is not "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s wall", flush=True)
        clock[0] = now

    # 1. card
    print(TB.card(), flush=True)
    lap("1 (card)")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    lap("2 (build)")

    # data: SF10 lineitem in 8 batches of capacity 2^23
    t0 = time.perf_counter()
    sizes, batches_np, batches = TB.sf10_lineitem(args.seed, dev)
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    gold = golden_q1(batches_np)
    stacked, nums = TB.stacked_columns(batches, sizes, dev)
    print(f"data: {TB.SF10_ROWS} rows in {TB.N_BATCHES} batches, "
          f"{datagen_s:.1f} s", flush=True)

    # 3. kernels against their plain twins at the main path's shapes
    kernels: dict = {}
    cap = TB.N_BATCHES * TB.BATCH_CAP

    def q1_call():
        return K.q1_fused(*stacked, nums, capacity=cap, cutoff=10471,
                          batch_rows=TB.BATCH_CAP)

    def q1_plain():
        return K.q1_fused_plain(*stacked, nums, capacity=cap, cutoff=10471,
                                batch_rows=TB.BATCH_CAP)

    got, want = q1_call(), q1_plain()
    require(torch.equal(got[:, 5], want[:, 5]), "q1_fused counts differ")
    q1_err = (got - want).abs().max().item()
    q1_rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    require(q1_rel <= 1e-5, f"q1_fused vs plain rel err {q1_rel}")
    # rows past num_rows[b] are padding: the function reads none of them
    live_rows = sum(sizes)
    b_ms, b_by = bound(live_rows * 28 + nums.numel() * 4
                       + -(-cap // K.Q1_BLOCK_ROWS) * 48 * 4, live_rows * 10)
    kernels["q1_fused"] = {
        "name": "q1_fused", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/q1_fused.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:127",
        "max_abs_err": q1_err, "max_rel_err": q1_rel, "rtol": 1e-5,
        "ms": cuda_ms(torch, q1_call, 20),
        "device_ms": device_ms(torch, q1_call, "q1_fused_kernel", 10),
        "plain_ms": cuda_ms(torch, q1_plain, 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{TB.N_BATCHES}x2^23 stacked"}

    def grouped_case(keys, vals, nrows, n_groups, tier, reps, strict=True):
        def call():
            return K.grouped_sum(keys, vals, nrows, n_groups=n_groups,
                                 capacity=keys.numel())

        got_s, got_c = call()
        if tier is None:  # a main-path call: whichever tier it takes
            (tier,) = set(K.grouped_sum.last_tiers)
        require(K.grouped_sum.last_tiers == [tier],
                f"grouped_sum at G={n_groups} took tiers "
                f"{K.grouped_sum.last_tiers}, expected {tier}")
        if tier in ("A", "B"):
            same_bits((got_s, got_c), call(), f"grouped_sum tier {tier}")
        nr = torch.full((1,), nrows, dtype=torch.int32, device=dev)
        want_s, want_c = K.grouped_sum_plain(
            keys, vals, nr, n_groups=n_groups, capacity=keys.numel())
        require(torch.equal(got_c, want_c), "grouped_sum counts differ")
        err = (got_s - want_s).abs().max().item()
        rel = ((got_s - want_s).abs()
               / want_s.abs().clamp_min(1.0)).max().item()
        require(rel <= 1e-4, f"grouped_sum vs plain rel err {rel}")
        m = len(vals)
        kept = ((keys >= 0) & (keys < n_groups)
                & (torch.arange(keys.numel(), device=dev) < nrows))
        n_kept = int(kept.sum().item())
        b_ms, b_by = bound(keys.numel() * 4 + n_kept * m * 4
                           + n_groups * (m + 1) * 4, n_kept * (m + 1))
        seg = torch.where(kept, keys, n_groups).to(torch.int64)
        lib_vals = torch.where(kept[:, None], torch.stack(vals, 1), 0.0)

        def library():
            torch.zeros((n_groups + 1, m), device=dev).index_add_(
                0, seg, lib_vals)
            torch.bincount(seg, minlength=n_groups + 1)

        prof_ms = device_ms(torch, call, "grouped_sum", reps, strict)
        ev_ms = event_ms(torch, call, reps)
        return {
            "max_abs_err": err, "max_rel_err": rel, "rtol": 1e-4,
            "tier": tier, "ms": cuda_ms(torch, call, reps),
            "device_ms": ev_ms if prof_ms is None else prof_ms,
            "device_ms_by": "events" if prof_ms is None else "profiler",
            "event_ms": ev_ms,
            "plain_ms": cuda_ms(torch, lambda: K.grouped_sum_plain(
                keys, vals, nr, n_groups=n_groups,
                capacity=keys.numel()), reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, library, reps)}

    # Q1's dictionary-lane shape: composite slot (flag window 4+1 x status
    # window 4+1) = 25 slots + the masked slot, 14 measures
    b0 = batches[0]
    keep0 = (b0.column("l_shipdate").data <= 10471) & b0.row_mask()
    slot = torch.where(keep0, b0.column("l_returnflag").data * 5
                       + b0.column("l_linestatus").data, 25).to(torch.int32)
    q, p, d, t = (b0.column(n).data for n in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    dp64 = p.double() * (1.0 - d.double())
    val_cols = [q, p, dp64.float(), (dp64 * (1.0 + t.double())).float(),
                q, p, d]
    flag = keep0.float()
    q1_vals = []
    for v in val_cols:
        q1_vals += [torch.where(keep0, v, 0.0), flag]
    gs = grouped_case(slot, q1_vals, TB.BATCH_CAP, 26, "A", 20)
    gs.update(name="grouped_sum", route="cuda",
              source="spark_rapids_tpu_torch/csrc/grouped_sum.cu",
              replaces="spark_rapids_tpu/ops/pallas_kernels.py:291",
              shape="2^23 rows, G=26, M=14")
    kernels["grouped_sum"] = gs
    g_rng = torch.Generator(device=dev).manual_seed(args.seed)
    wide_keys = torch.randint(0, 32769, (TB.BATCH_CAP,), generator=g_rng,
                              device=dev, dtype=torch.int32)
    gs_wide = grouped_case(wide_keys, q1_vals, TB.BATCH_CAP, 32769, "C", 5)
    gs_wide["shape"] = "2^23 rows, G=32769, M=14"
    # a table past the lane-private tier: one table per warp
    mid_keys = torch.remainder(wide_keys, 300)
    gs_mid = grouped_case(mid_keys, q1_vals, TB.BATCH_CAP, 300, "B", 10)
    gs_mid["shape"] = "2^23 rows, G=300, M=14"

    def window_case(gid, vals, out_cap, reps, strict=True):
        def call():
            return GW.window_group_sums(gid, vals, out_cap=out_cap,
                                        capacity=gid.numel())

        before = GW.window_group_sums.launches
        got = call()
        require(GW.window_group_sums.launches
                == before + -(-len(vals) // K.MAX_MEASURES),
                "window_group_sums did not launch its kernel")
        same_bits((got,), (call(),), "window_group_sums")
        want = GW.window_group_sums_plain(gid, vals, out_cap=out_cap)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        require(rel <= 1e-4, f"window_group_sums vs plain rel err {rel}")
        for j, v in enumerate(vals):
            # integers whose absolute sum is below 2^24 add exactly in f32
            # in any order
            if (bool((v == v.round()).all().item())
                    and v.abs().double().sum().item() < 2**24):
                require(torch.equal(got[:, j], want[:, j]),
                        f"window_group_sums measure {j} of integers is "
                        f"not exact")
        m, n = len(vals), gid.numel()
        b_ms, b_by = bound(n * 4 + n * m * 4 + out_cap * m * 4, n * m)
        seg = torch.where((gid >= 0) & (gid < out_cap), gid,
                          out_cap).to(torch.int64)
        lib_vals = torch.stack(vals, 1)
        prof_ms = device_ms(torch, call, "window_group_sums", reps, strict)
        ev_ms = event_ms(torch, call, reps)
        return {
            "max_abs_err": err, "max_rel_err": rel, "rtol": 1e-4,
            "ms": cuda_ms(torch, call, reps),
            # the profiler's, or where it records nothing the events'
            "device_ms": ev_ms if prof_ms is None else prof_ms,
            "device_ms_by": "events" if prof_ms is None else "profiler",
            "event_ms": ev_ms,
            "plain_ms": cuda_ms(torch, lambda: GW.window_group_sums_plain(
                gid, vals, out_cap=out_cap), reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, lambda: torch.zeros(
                (out_cap + 1, m), device=dev).index_add_(0, seg, lib_vals),
                reps)}

    # Q1's merge shape: 8 partials x 6 groups sorted into a 16384-row
    # batch, 17 measures (4 Sum x 2, 3 Average x 2, 1 Count, 2 limbs)
    merge_cap, live = 1 << 14, TB.N_BATCHES * 6
    gid = torch.clamp(torch.arange(merge_cap, device=dev) // TB.N_BATCHES,
                      max=5).to(torch.int32)
    row_live = torch.arange(merge_cap, device=dev) < live
    mvals = [torch.where(row_live, torch.rand(merge_cap, generator=g_rng,
                                              device=dev) * 1e6, 0.0)
             for _ in range(17)]
    wg = window_case(gid, mvals, merge_cap, 50)
    wg.update(name="window_group_sums", route="cuda",
              source="spark_rapids_tpu_torch/csrc/window_group_sums.cu",
              replaces="spark_rapids_tpu/ops/grouped_window.py:72",
              shape="2^14 rows (48 live), 6 groups, M=17")
    kernels["window_group_sums"] = wg
    big_gid = torch.sort(torch.randint(0, 1 << 20, (1 << 22,),
                                       generator=g_rng, device=dev))[0].to(
        torch.int32)
    big_vals = [torch.rand(1 << 22, generator=g_rng, device=dev)
                for _ in range(17)]
    wg_big = window_case(big_gid, big_vals, 1 << 20, 10)
    wg_big["shape"] = "2^22 rows, ~10^6 groups, M=17"
    # planner Q1's partial aggregate: one partition of 3,749,129 live rows
    # at capacity 2^22 in 4 runs that cross ~900 tiles each; small
    # integers keep every f32 sum exact, so kernel and twin must agree
    # to the bit
    part_rows = 3_749_129
    iota = torch.arange(1 << 22, device=dev)
    run_gid = torch.clamp(iota * 4 // part_rows, max=3).to(torch.int32)
    run_vals = [torch.where(iota < part_rows, torch.randint(
        0, 16, (1 << 22,), generator=g_rng, device=dev), 0).float()
        for _ in range(17)]
    wg_runs = window_case(run_gid, run_vals, 1 << 14, 10)
    require(wg_runs["max_abs_err"] == 0.0,
            "window_group_sums at planner Q1's shape is not exact")
    wg_runs["shape"] = "2^22 rows (3,749,129 live), 4 runs, out_cap 2^14, M=17"
    for k in list(kernels.values()) + [gs_mid, gs_wide, wg_big, wg_runs]:
        print(kernel_text(k.get("name", ""), k), flush=True)
    del wide_keys, mid_keys, big_gid, big_vals, q1_vals, mvals, run_vals
    lap("3 (kernels against their twins, with the SF10 data)")

    # 4. engine Q1 through the exec tree
    with C.session(C.RapidsConf(TB.BENCH_CONF)):
        plan = tpch.q1_plan(LocalBatchSource([batches], device=dev))
        K.grouped_sum.launches = 0
        GW.window_group_sums.launches = 0
        K.q1_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df = plan.collect().to_pandas()
        cold_s = time.perf_counter() - t0
        deopted = plan.child._banded_disabled
        t0 = time.perf_counter()
        df_hot = plan.collect().to_pandas()
        hot_s = time.perf_counter() - t0
        engine_launches = {"grouped_sum": K.grouped_sum.launches,
                           "window_group_sums":
                               GW.window_group_sums.launches,
                           "q1_fused": K.q1_fused.launches}
        # a second plan in the now warm process: its cold collect pays the
        # plan's own first-batch probe and deopt re-run, but not the
        # process's first use of each torch op on the path
        fresh = tpch.q1_plan(LocalBatchSource([batches], device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df_fresh = fresh.collect().to_pandas()
        fresh_cold_s = time.perf_counter() - t0
    print(f"engine q1_plan SF10: cold {cold_s:.3f} s (first plan in the "
          f"process), cold {fresh_cold_s:.3f} s (second plan), hot "
          f"{hot_s:.3f} s, banded lane deopted: {deopted}, launches "
          f"{engine_launches}", flush=True)
    require(engine_launches["grouped_sum"] >= TB.N_BATCHES,
            "grouped_sum launched fewer than once per batch")
    require(engine_launches["window_group_sums"] >= 1,
            "window_group_sums never launched")
    exp_keys = [(g // 2, g % 2) for g in range(6)]
    cnt = gold["count"]
    engine_rel = 0.0
    for frame in (df, df_hot, df_fresh):
        require(list(zip(frame["l_returnflag"], frame["l_linestatus"]))
                == exp_keys, "Q1 group keys differ")
        require(np.array_equal(frame["count_order"].to_numpy(),
                               cnt.astype(np.int64)), "Q1 counts differ")
        want = np.column_stack([gold["sums"][:, :4],
                                gold["sums"][:, 0] / cnt,
                                gold["sums"][:, 1] / cnt,
                                gold["sums"][:, 4] / cnt])
        got = frame[Q1_NAMES[:7]].to_numpy(np.float64)
        engine_rel = max(engine_rel,
                         float(np.max(np.abs(got - want) / np.abs(want))))
    require(engine_rel <= 1e-3, f"Q1 engine rel err {engine_rel}")
    print(f"engine q1_plan SF10 against the float64 golden: keys and "
          f"counts exact, max rel err {engine_rel:.3g}", flush=True)
    lap("4 (exec-tree Q1)")

    # 5. the stacked Q1 step
    step = tpch.build_q1_fused_kernel(cap, TB.BATCH_CAP, device=dev)
    K.q1_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = step(*stacked, nums).cpu().numpy()
    step_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(*stacked, nums).cpu()
    step_hot_s = time.perf_counter() - t0
    step_launches = K.q1_fused.launches
    require(step_launches >= 1, "q1_fused never launched")
    require(np.array_equal(table[:6, 5], cnt), "stacked Q1 counts differ")
    step_rel = float(np.max(np.abs(table[:6, :5] - gold["sums"])
                            / np.abs(gold["sums"])))
    require(step_rel <= 1e-5, f"stacked Q1 rel err {step_rel}")
    print(f"stacked q1 step SF10: cold {step_cold_s:.4f} s, hot "
          f"{step_hot_s:.4f} s, rel err {step_rel:.3g}, q1_fused "
          f"launches {step_launches}", flush=True)
    lap("5 (stacked Q1 step)")

    # 6. planner Q1 and Q6
    planner = planner_phase(torch, dev, args.seed, GW)
    lap("6 (planner Q1 and Q6)")

    # 7. the join queries, with the earlier phases' device data freed
    del plan, fresh, batches, stacked, nums, step, b0, slot, keep0
    del q, p, d, t, dp64, val_cols, flag, g_rng, gid, row_live, iota
    del run_gid
    torch.cuda.empty_cache()
    from spark_rapids_tpu_torch.models import tpch_data as TD
    t0 = time.perf_counter()
    tables, arrays = TB.sf10_tables(args.seed)
    print("join data: " + ", ".join(f"{k} {len(v)}" for k, v in
                                    tables.items())
          + f" rows, {time.perf_counter() - t0:.1f} s", flush=True)
    gold = golden_joins(arrays, TD)
    gold_parts = golden_parts(arrays, tables["customer"], TD, TB)
    green = arrays["p_green"]
    del arrays
    joins = join_phase(torch, dev, tables, gold, GW, K)

    def check_join_calls(phase: dict, queries) -> list:
        """The widest window_group_sums call of each query's hot collect
        against the twin (rtol 1e-4, exact on integer measures)."""
        cases = []
        for q in queries:
            require(q in phase["calls"],
                    f"q{q}: no window_group_sums call on the card to check")
            j_gid, j_vals, j_cap = phase["calls"].pop(q)
            case = window_case(j_gid, j_vals, j_cap, 10, strict=False)
            live = int((j_gid[1:] != j_gid[:-1]).sum().item()) + 1
            case.update(query=q, launches=phase["window_group_sums"][
                f"q{q}_hot"], shape=f"Q{q} widest call: capacity "
                f"{j_gid.numel()}, out_cap {j_cap}, M={len(j_vals)}, {live} "
                f"id runs")
            print(kernel_text("window_group_sums", case), flush=True)
            cases.append(case)
            del j_gid, j_vals
        return cases

    join_cases = check_join_calls(joins, (3, 4, 5))
    lap("7 (join queries Q3, Q4, Q5)")

    # 8. Q7-Q10: dates, CASE WHEN, string predicates, division, part and
    # partsupp
    parts = join_phase(torch, dev, tables, gold_parts, GW, K)
    join_cases += check_join_calls(parts, (7, 8, 9, 10))
    grouped_cases = []
    for q, (g_keys, g_vals, g_rows, g_groups) in sorted(
            {**joins["grouped_calls"], **parts["grouped_calls"]}.items()):
        case = grouped_case(g_keys, g_vals, g_rows, g_groups, None, 10,
                            strict=False)
        case.update(query=q, launches=parts["grouped_sum"].get(
            f"q{q}_hot", joins["grouped_sum"].get(f"q{q}_hot")),
            shape=f"Q{q} widest call: capacity {g_keys.numel()}, "
            f"G={g_groups}, M={len(g_vals)}, tier {case['tier']}")
        print(kernel_text("grouped_sum", case), flush=True)
        grouped_cases.append(case)
        del g_keys, g_vals
    require(bool(grouped_cases) or parts["grouped_sum"]["q8_hot"] == 0,
            "grouped_sum launched in Q8 but no call was checked")
    like = like_case(torch, dev, tables["part"], green)
    del tables
    lap("8 (join queries Q7, Q8, Q9, Q10)")

    kernels["q1_fused"]["launches"] = step_launches
    kernels["grouped_sum"]["launches"] = engine_launches["grouped_sum"]
    kernels["window_group_sums"]["launches"] = \
        engine_launches["window_group_sums"]
    kernels["window_group_sums"]["planner_q1_launches"] = \
        planner["q1_launches"]
    for name in ("grouped_sum", "window_group_sums"):
        kernels[name]["join_queries_launches"] = {**joins[name],
                                                  **parts[name]}
    case_keys = ("query", "shape", "launches", "max_abs_err",
                 "max_rel_err", "ms", "device_ms", "device_ms_by",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels["window_group_sums"]["join_cases"] = [
        {k: c[k] for k in case_keys} for c in join_cases]
    kernels["grouped_sum"]["join_cases"] = [
        {k: c[k] for k in case_keys if k in c} for c in grouped_cases]
    print(f"like over {like['rows']} rows: {like['ms']:.4f} ms "
          f"(Contains {like['contains_ms']:.4f} ms), same rows as "
          f"Contains and the p_name green mask", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "planner_q1_launches",
            "join_queries_launches", "join_cases")
    line = {"kernels": [{k: v[k] for k in keys if k in v}
                        for v in kernels.values()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
