#!/usr/bin/env python3
"""GPU smoke run of spark_rapids_tpu_torch: all 22 TPC-H queries, the
ETL plans of the type and expression layer, the 18 TPC-DS queries with
a window, a ROLLUP or a UNION ALL (phase 11), the memory layer's
out-of-core lanes and OOM retry lattice (phase 12), the rest of the
workloads (phase 13): the other 85 TPC-DS queries, TPCx-BB's 30 and
Mortgage's ETL, the I/O layer with the planner's sort-merge
join, repartition, cached columnar scan and sort aggregate (phase 14),
the runtime: two concurrent TPC-H streams, admission control, the
result cache, the watchdog and AQE (phase 15), the shuffle manager
lane with the brute-force joins (phase 16), the observability layer
(phase 17), and the UDF layer: TPCx-BB's q18 and q27 at SF1, the pandas
execs through the worker daemon, the plugin, the shims, the API audit
and the ML export (phase 18), and distribution: TPC-H over a device mesh
with the SPMD lane, the graft entry's dry run (phase 19), on one NVIDIA
card
(59,986,052 lineitem rows, scale factor 10, in phases 4-6 and 14a, TPC-H
spec 4.2.5; 50,000 TPC-DS store_sales rows in 11b and 13b, where SF1 has
2,880,404, Table 3-2).

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (exit code 1, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from spark_rapids_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch twin on the card at the
     main path's shapes (counts exact; f32 sums rtol 1e-5 for q1_fused
     and 1e-4 for grouped_sum and window_group_sums, which add in another
     order than the twin's; window_group_sums against its twin over
     float64 copies of the inputs rounded to f32, since the f32 twin's
     atomics add in no fixed order, and exact on every measure of
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
     same way over the eight TPC-H tables at SF1 (see the cuts below),
     linked by dbgen's
     keys (tpch_bench.sf10_tables), 16 partitions: the exec trees must
     be the planner's, every join's lane and its probe batches are
     named and the kernels' launches counted, and the results must hold
     against a float64 numpy golden built from index arrays (keys,
     dates, counts and order exact; revenues rtol 1e-3); accelerate and
     collect are timed apart (one new plan per query: the hot second
     plan of phases 7 and 8 went when phase 9 came, to keep the script
     within half its time limit), and each query's peak device memory
     printed; then the inputs of the widest window_group_sums call of
     each query's collect are held
     against the twin as in phase 3 (rtol 1e-4, exact on measures of
     integers whose sums f32 holds exactly) and timed (`device_ms`
     from CUDA events queued behind a sleep kernel, as in every later
     phase: the profiler records no device activity there);
  8. run TPC-H Q7, Q8, Q9 and Q10 (Year, CASE WHEN, Contains, Divide,
     part and partsupp, Q10's seven group keys) as phase 7 runs Q3-Q5,
     against float64 goldens (keys, years, names, counts and order
     exact; revenues, profits and market shares rtol 1e-3), with the
     same window_group_sums checks; then time LIKE '%green%' over 2^20
     p_name values, which must select the rows Contains does;
  9. run TPC-H Q2 and Q11-Q22 (InSet, Min/Max, scalar subqueries
     through run, Cast) the same way over the same tables, each scalar
     subquery a collect of its own on the card (timed apart), Q21 with
     its two semi/anti joins with a residual condition as CpuHashJoin
     islands (spark.rapids.sql.test.allowedNonGpu=CpuHashJoin, every
     other node a device exec), against float64 numpy goldens (keys,
     strings, counts and order exact; sums rtol 1e-3; Q15's revenue
     equal to its subquery's max to the bit), each aggregate's lane
     decisions printed, the widest window_group_sums call of each query
     and every grouped_sum call held against the twins;
 10. run the ETL plans of models/etl_bench.py over the same tables at
     16 partitions under ETL_CONF (the three cast gates on) with
     test.enabled, so that no plan has a CPU node: X1 casts o_orderkey,
     o_orderdate, o_totalprice and a timestamp to STRING and back and
     counts the mismatches (all 0), and on a sample of 65,536 orders the
     strings must be str(int), ISO dates, Java's Double.toString and
     'yyyy-MM-dd HH:mm:ss'; X2 derives a timestamp per order and groups
     its fields, to_date, trunc, months_between, time_add, weekday and
     text by the hour (counts and integers exact, months_between rtol
     1e-12, the sample's rows too); X3 cleans the customers'
     strings, every column held against Python's string methods, and
     counts them by split(c_phone, '-')[0] (c_nationkey + 10); X4 takes
     var_samp, stddev_samp, first/last, narrow-cast and bitwise sums,
     sqrt, log10 and a rounded average over lineitem by (l_returnflag,
     l_linestatus) (var/stddev rtol 1e-9 of a two-pass float64 golden,
     integer sums exact, float64 sums rtol 1e-9), stddev_samp by the
     suppliers, and two ANSI casts: cast(l_extendedprice as
     smallint) must raise ArithmeticError at collect, cast(l_quantity
     as tinyint) must sum exactly; each plan new, accelerate and a cold
     and a hot collect timed apart, plan runs, peak device memory and
     the kernels' launches per plan printed, and the widest call of each
     kernel in each plan's hot collect held against its twin;
 11. run the 18 TPC-DS queries of DS_SLICE (windows, ROLLUPs through
     ExpandExec, UNION ALL) as a user submits them, under the TPC bench
     conf with test.enabled, so that no plan has a CPU node, after
     freeing phases 1-10's data: 11a, their check against the CPU engine
     (keys, strings, ranks, row numbers, counts and the sort keys' order
     exact; sums and averages rtol 1e-3: the banded lane adds in f32),
     runs in 13a; 11b runs the 18 over the tables 13b runs over
     (workload_tables(seed, WL_SCALE): 50,000 store_sales rows, the
     generator's own ratios for the rest), 16 partitions, one new
     plan per query, spread over this process and CARD_HELPERS more on
     the card as 13's are: accelerate and collect timed
     apart, plan runs, peak device memory, rows, lane decisions and the
     kernels' launches printed; the widest input batch of every
     WindowExec and ExpandExec downloaded and the exec's output held
     against CpuWindow's pandas evaluation / CpuExpand over the same
     rows (exact, window sums of floats within n*eps*sum|x| of their
     input), the widest call of each kernel in each query against its
     twin, and device memory back to its value before each query, as in
     13b;
 13. the rest of the workloads, as a user submits them under the TPC
     bench conf with test.enabled (no plan has a CPU node): 13a runs all
     103 TPC-DS queries (the 85 without a window or an expand, and 11a's
     18) and TPCx-BB's 30 queries (q18's and q27's UDFs compiled) over
     workload_tables(3, 20,000) (the reference fixture's seed and scale,
     where every query keeps support; its TPC-DS tables are
     tpcds_bench.sf10_tables(3, 20,000)'s), and Mortgage's etl_plan and
     summary_plan over 1,000 loans x 24 months, 16 partitions, each
     result held against the CPU engine's, which CPU_WORKERS processes
     compute while the card runs (no result empty but q91's, as the
     reference fixture allows; q9's five scalar subqueries each a
     collect of its own on the card, timed apart); 13b runs every
     second one of the 85 TPC-DS queries (see the cuts) over
     workload_tables(seed, WL_SCALE) and Mortgage over 1,000,000 loans
     x 24 months (24M performance rows), one new plan each, as 11b runs
     the 18 (q9's subquery collects counted and checked with its plan;
     TPCx-BB's queries left 13b: see the cuts); 13a's, 11b's and 13b's
     TPC-DS and TPCx-BB queries are spread over this process and
     CARD_HELPERS processes more on the card (card_pool, spread: the
     next query to the runner that frees first, the slowest first),
     since at these scales the engine holds the card a few percent of a
     query's time; 11b's and 13b's widest kernel calls come back as
     numpy copies and are held against their twins and timed in this
     process once its phase's queries have run, with the card to
     itself (call_cases); Mortgage's two plans run in this process;
     throughout: accelerate and collect apart, plan runs, peak device
     memory, rows, aggregate and join lanes and the kernels' launches
     printed, every float of a result finite, the widest call of each
     kernel in each query held against its twin (device time from CUDA
     events), and torch.cuda.memory_allocated() printed before and
     after each query, where it must come back to its value before once
     the plan is dropped (but for the growth of the kernel wrappers' own
     state, which lives as long as the process: window_group_sums' tile
     flags, grouped_sum's scratch and row counts); window_group_sums
     and grouped_sum must each launch in phase 13;
 14. the I/O layer and the planner's missing nodes, under the TPC bench
     conf with test.enabled (no plan has a CPU node but 14c's fallback),
     with files in IO_DIR (git-ignored, emptied at each part's start
     and end; 14b's stay for phase 15): 14a, right after phase 6 while its SF10 lineitem is
     held, writes the seven columns Q1 and Q6 read through the port's
     writer (write(CpuSource) -> TpuWriteFilesExec, partitioned by
     l_returnflag and l_linestatus: the dynamic partition writer and
     hive discovery) and runs planner Q1 and Q6 over read_parquet
     against phase 6's float64 golden (keys and counts exact, sums rtol
     1e-3), the filters pushed into the scan, window_group_sums
     launched in Q1; 14b, after phase 12 over its SF1 tables, writes
     lineitem, orders, customer, supplier and partsupp as Parquet, part
     as ORC (the port's writer) and nation and region as CSV (pandas:
     the port reads CSV but writes none) and runs Q3, Q5 and Q9 over
     the file scans (Q9 reads part from ORC, Q5 region and nation from
     CSV) against phases 7 and 8's goldens and checks; 14c, over the
     same tables in memory, runs Q3 with every hash join made a
     CpuSortMergeJoin over local CpuSorts (phase 7's exec tree node for
     node: no SortExec left; phase 7's checks), again with
     spark.rapids.sql.replaceSortMergeJoin.enabled off (ExecutionPlan-
     Capture names the CpuSortMergeJoin fallback; same checks), Q1 over
     CpuShuffleExchange(roundrobin, 16), over a CpuCachedColumnar copy
     of lineitem (HostColumnarToDeviceExec, no RowToColumnarExec) and
     with a CpuSortAggregate (HashAggregateExec), each against Q1's
     float64 golden at SF1; per plan accelerate and collect apart, each
     file scan's host decode and upload time, upload bytes and row
     groups read against its splits' total, the peak device memory and
     the kernels' launches printed, and the widest call of each kernel
     in each plan held against its twin;
 15. the runtime (exec/pipeline.py, exec/scheduler.py, utils/watchdog.py,
     plan/aqe.py), after 14c over phases 7-9's SF1 tables and goldens,
     under the TPC bench conf with test.enabled and the runtime's
     defaults (pipeline, scheduler and watchdog on), as every earlier
     phase now runs (the port prefetches at the file scan alone, so the
     in-memory phases start no producer): 15a, the TPC-H throughput test
     (spec 5.3.4): two streams, each on its own thread submitting all 22
     queries (one new plan each, over 14b's files, so that every scan
     prefetches) in the power-test order, stream 2 rotated by 11, every
     result against phases 6-9's goldens and checks (check_tpch;
     here, cut, the two streams run the two halves of the power order,
     11 queries each, at once: HALF_STREAMS), each
     query's accelerate and collect, each stream's wall and the two
     together against the sum of phases 7-9's single-stream collects
     (over memory, which upload in accelerate), the scheduler's counters
     (admitted, queued, most concurrent), the pipeline's (producers, most
     batches in flight) and the kernels' launches printed, the widest
     call of each kernel from any thread held against its twin, and
     torch.cuda.memory_allocated() back to its value before the streams
     but for the wrappers' own state; 15b, three Q6 at once with
     queryBudgetBytes at 45% of the DeviceManager's budget under a gate
     at their root that opens once the scheduler has queued one (two
     admitted at most, one queued, none rejected, a queue wait above 0,
     all three equal to the golden), then a Q6 with queueDepth 0 while
     two Q6 at the same budget are held admitted by the gate
     (TpuQueryRejected; the two then equal Q6's golden), then Q1 twice
     over one set of sources with resultCache.enabled (the second a hit,
     equal to the bit, no launch); 15c, Q1 over the lineitem file with
     its scan's producer hung (hangSite producer after 1 batch,
     taskTimeout 5 s, pollInterval 0.5 s) cancelled with a
     TpuQueryTimeout naming the producer within 15 s, then the same Q1
     clean and equal to the golden, no producer left and device memory
     back; 15d, Q3, Q5 and
     Q10 with spark.sql.adaptive.enabled: each final plan
     (ExecutionPlanCapture) with ShuffleQueryStageExec nodes and a
     BroadcastHashJoinExec, one of the three with a coalescing
     CustomShuffleReaderExec, the stages' batches released, results
     against the goldens, device memory back; 15e, grouped_sum tiers A
     and B and window_group_sums at phase 3's shapes, 100 calls each
     from four threads at once: every result equal to the bit to the
     call made alone, the counters grown by exactly 4 x 100 x 3;
 16. the shuffle manager lane (shuffle/*, exec/speculation.py), after
     phase 15 over phases 7-9's SF1 tables and goldens, 16 partitions,
     under the TPC bench conf with test.enabled, spark.rapids.shuffle.
     enabled and shuffle.localExecutors 4 (a four-executor cluster's
     shuffle on one card; the executors are made anew for each part,
     since each takes its conf when made); a second OS process on the
     card is started first and serves 16e: 16a, Q3, Q5, Q9 and Q18 over
     the loopback lane against the goldens, per query accelerate and
     collect, the exchanges' map-output bytes, the bytes each store tier
     took, the device store's peak, peak device memory and the kernels'
     launches, the widest call of each kernel held against its twin and
     device memory back to its value before the query with no map
     output left; 16b, Q5 with every map output advertised on the TCP
     lane and zstd on the wire, the rows of 16a's to the bit, wire and
     raw bytes; 16c, Q3 with local-1 killed after 4 served frames
     (failureThreshold 1), maps recomputed and stage attempts printed,
     16a's rows to the bit; 16d, Q3 with speculation against local-1
     slowed tenfold at its map tasks, a duplicate winning and a loser
     cancelled, 16a's rows to the bit; 16e, 2^22 rows (int64, float64
     and int32 with nulls, strings with nulls) from the second process
     over TCP with lz4, equal to the batch it served to the bit, then
     that process killed while a second, paced read is in flight
     (FetchFailedError within the read's timeout); 16f, nation x region
     as a CpuCartesianProduct and a CpuNestedLoopJoin on
     n_regionkey < r_regionkey, both enabled and planned onto
     NestedLoopJoinExec on the card, against pandas; at the end no
     executor and no shuffle thread is left;
 17. the observability layer (utils/profile.py, movement.py,
     residency.py, kernelprof.py, telemetry.py and their hooks), after
     phase 16 over phases 7-9's SF1 tables and goldens and 14b's files
     (IO_DIR stays until phase 17 ends), with spark.rapids.sql.profile.
     enabled, profile.kernels.enabled (every entry timed) and telemetry.
     enabled, telemetry's HTTP endpoint on a free port of 127.0.0.1, the
     Chrome traces and the event log in PROFILE_DIR (git-ignored, emptied
     at the phase's start and end): 17a, planner Q1 and Q5 over the
     files, the exec-tree Q1 and the stacked Q1 step over one batch of
     SF1's 6,001,215 lineitem rows at capacity 2^23, and
     window_group_sums at phase 3's merge shape, each profiled after an
     unprofiled run of the same (the same bits; the goldens); every
     TpuExec of each plan has a span, each Chrome trace parses as
     written, upload and readback moved bytes, the residency high-water
     mark is above 0 with no leak, no kernel or edge is past its H100
     roofline, each hand kernel's catalog launches equal its wrapper's
     `.launches` delta, and its warm sampled mean (the samples after a
     first call at its shape: 5 of q1_fused, 6 of grouped_sum from six
     profiled exec-tree collects, 20 of window_group_sums) must be
     within CATALOG_RTOL of the kernel timed alone at the same shape
     (CUDA events behind a sleep kernel, as the phases after 7 time
     kernels; the catalog's pairs start behind a spin too); 17a's Q5
     is held against 17e's first run; 17c, Q3 over four executors,
     profiled: wire bytes sent equal bytes received, every
     shuffle-fetch span parents under its query; 17b, the same Q3
     under phase 12's OOM injection, profiled, twice: with the
     out-of-core lanes under a quarter of its peak (17c's residency
     high-water mark), and without them under a 32nd (so that the
     retry harness's pressure spills the device store, which holds the
     manager lane's map output): in each, the oom_retry and
     oom_split_retry events equal numRetries and numSplitRetries, the
     device store's device->* hops equal the spill callback's bytes and
     the plan's spillBytes, the out-of-core hops equal the run
     accounting and spillRunBytes, and the leg's own hops are above 0;
     17d, two streams over the files (Q1 and Q3, and
     Q5) under the sampler: the causes' shares sum to 100%, the
     Prometheus text parses, /metrics answers; 17e, Q5 unprofiled
     before 17a-d and twice after, once telemetry (no instance, no
     thread), kernel attribution and residency tracking are found off:
     the collect times, the process RSS and gc.get_count() printed;
 18. the UDF layer (udf/, pyudf/, plugin.py, shims/, api_validation.py,
     ml/), after phase 17 over phases 7-9's SF1 tables and goldens,
     under the TPC bench conf with test.enabled: 18a, TPCx-BB's q18 and
     q27 at SF1 (workload_tables(seed, UDF_SCALE): 2,880,404 store_sales
     rows, 1,440,202 product reviews), one new plan each, with the UDF
     compiler on (no CPU node; each UDF's compiled expression printed,
     its find() >= 0 tests simplified to Contains) and off (the UDF's
     project the only CPU island, row-applying the Python function):
     keys, counts and order exact, avg_rating rtol 1e-3; 18b, the six
     pandas execs (each enabled; ArrowEvalPython's vectorized UDF in the
     worker daemon's UDF_WORKERS processes) over SF1 lineitem's
     6,001,215 rows at 16 partitions, under test.enabled, with an
     aggregate on the card above the three whose output has a row per
     input row, each against the CPU engine (keys and counts exact; the
     card's f32 sums rtol 1e-3, the host's own sums exact); two probes
     at once take both workers, each with CUDA_VISIBLE_DEVICES empty,
     no torch imported and no pid among nvidia-smi's compute apps; a
     worker killed in the middle of a batch fails its query with
     WorkerCrash, and the pool's next query runs and equals the first;
     18c, the API audit of the five versions (clean) and their
     RapidsShuffleManager classes, then plugin.activate() on the card:
     planner Q1 and Q6 through the session's columnar rules against
     their float64 goldens (phase 6's, at SF1), Q3 over four executors,
     each a spark301.RapidsShuffleManager, against phase 7's golden, Q6's
     input exported by ColumnarRdd.collect_arrays as tensors on the card
     whose revenue equals the golden (rtol 1e-9) and the collect (1e-3),
     20 SGD steps of a torch.nn.Linear on them (the loss falls), then
     deactivate(): torch.cuda.memory_allocated() back to its value
     before but for the wrappers' own state; throughout, accelerate and
     collect apart, the launches per plan, and the widest call of each
     kernel in each plan held against its twin;
 19. distribution (parallel/, exec/spmd.py, graft_entry.py), after phase
     18 over phases 7-9's SF1 tables and goldens: a mesh of MESH_SLOTS
     slots spread round-robin over the cards (on one card all four
     slots share it: the lane's routing, counts, capacity and gang code
     run, no byte crosses an interconnect, and the script says so);
     19a, TPC-H Q1, Q3, Q5 and Q9 at 4 partitions with the mesh active,
     spark.rapids.sql.spmd.enabled, test.enabled and profiling on (the
     collective edge), one new plan each, against phases 6-8's float64
     goldens (keys and counts exact, sums rtol 1e-3): each join query's
     hash exchanges run the mesh all-to-all, every query dispatches
     gangs, the collective edge's bytes and sites, the launches, the
     widest call of each kernel held against its twin, device memory
     back after each; 19b, graft_entry.dryrun_multichip(MESH_SLOTS) on
     the card (filter, project, the mesh all-to-all, grouped_sum per
     slot, the hash-grouping lane, checked in numpy) and entry()'s Q1
     step with the q1_fused kernel against the plain step (keys and
     counts exact, sums rtol 1e-5);
 20. print the kernels line (all three kernels, with their launches in
     every phase: `launches` the main path's, then per phase and per
     part of phases 15-19, and phase 17's catalog mean beside the
     kernel timed alone) and, last, the device line.
Cuts, to keep the script within 950 s of its 1,200 s limit, in this
order: (1) TPCx-BB's queries left 13b (13a still checks them at 20,000 rows;
`scripts/torch_workloads_phase.py` runs them at any scale); (2) 15a's
two streams run the two halves of the power order, 11 queries each
(`scripts/torch_runtime_phase.py` runs two streams of the 22, and three
at SF10); (3) when phase 16 came, 13b runs every second one of the 85
in registration order (43 queries, ds_rest_cut) at WL_SCALE (13a
still checks all 85 against the CPU engine; `scripts/torch_tpcds_phase.py
--queries rest` runs all 85 at WL_SCALE); with the 85 the script had
taken 976.6 s of laps, 252.9 s of them 13b's.  When phase 17 came, the
script took 1,227 s of laps with it (PERF.md) on hosts where phases
1-16 and 13 ran ~25% slower than where the script had taken 919.1 s; rather
than cut more queries, 13a, 11b and 13b now run their queries in three
processes on the card (CARD_HELPERS).  When phase 15 came, the runtime's prefetch producers ran at
every pipeline break and cost time on this host-bound engine (phases
1-12 262.6 s of laps against 173.4 s before, 13a 492.0 s against
293.7; PERF.md), which first forced two more cuts (11b at 20,000 rows,
84 of the 85 out of 13a and 13b); since the producers run at the file
scan alone, both are undone.  Earlier cuts: phase 9 runs one new plan
per query, as phases 7 and 8 do; phases 7-10 and 12 run over TPC-H at
scale factor JOIN_SF = 1 (10 before phase 11 came, 5 before 13b ran the
85); 11a's check of the 18 runs in 13a at 20,000 store_sales rows
(100,000 before phase 13 came); 11b and 13b run at WL_SCALE = 50,000
store_sales rows, not at SF1 (11b ran at a quarter of SF10 before phase
13 came).  Why not SF1: there q24, q24b and q72 run out of the card's
memory in a join of the reference's plan (q72 completes at 300,000
rows, not at 400,000); and on an H100 the card's time per query is
nearly flat in the scale, so the 85 cost their count more than their
size: with them and TPCx-BB at 288,040 rows in 13b and phases 7-10 at
SF5, the script took 1,191.1 s of phase laps (13a 290.6 s, 11b 102.7
s, 13b 439.9 s, phases 7-10 and 12 310.1 s).  Laps vary by up to a
fifth between hosts.  `main` freezes the collector (`gc.freeze()`) at
its start and before 13a, so each 11b and 13b query's collection
before its memory check walks only what the query made (it walked the
whole heap, ~0.9 s a query, before: 1,059.3 s of laps against 853.5).
`scripts/torch_tpcds_phase.py --queries rest --scale 2880404` and
`scripts/torch_workloads_phase.py --scale 2880404` run them at SF1,
`--queries all --scale 28800991` at SF10 (PERF.md).
Every phase prints its wall time.  Without a CUDA device, or without
the package beside it, it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
Q1_NAMES = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_price", "avg_disc", "count_order"]


def sf_of(tables: dict) -> str:
    """The TPC-H scale factor of `tables`, from its orders (1,500,000 a
    unit, spec 4.2.5)."""
    return f"SF{len(tables['orders']) / 1_500_000:g}"


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


def device_ms(torch, fn, kernel: str, reps: int) -> float:
    """Mean device time of one launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `reps` calls of fn();
    raises where the profiler sees no such launch."""
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
    """(class name, describe()) of every node, in tree order, through
    the device/CPU transitions of a plan with CPU islands."""
    return [(type(n).__name__, n.describe()) for n in walk(plan)]


def tree_names(plan) -> list:
    """Class names in tree order, exchanges with their partitioning."""
    return [d if name == "ShuffleExchangeExec" else name
            for name, d in tree(plan)]


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


def check_q1(df, gold: dict, label: str) -> float:
    """Raise unless `df` is Q1's golden answer (keys and counts exact,
    sums and averages within rtol 1e-3); return the largest relative
    error."""
    require(list(zip(df["l_returnflag"], df["l_linestatus"]))
            == gold["keys"], f"{label} group keys differ")
    require(np.array_equal(df["count_order"].to_numpy(), gold["count"]),
            f"{label} counts differ")
    vals = df[Q1_NAMES[:7]].to_numpy(np.float64)
    rel = float(np.max(np.abs(vals - gold["want"]) / np.abs(gold["want"])))
    require(rel <= 1e-3, f"{label} rel err {rel}")
    return rel


def check_q6(df, gold: float, label: str) -> float:
    """The same for Q6's one revenue."""
    require(len(df) == 1, f"{label} is one row")
    rel = abs(float(df["revenue"][0]) - gold) / abs(gold)
    require(rel <= 1e-3, f"{label} rel err {rel}")
    return rel


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
    # the frame and goldens stay for phase 14a
    out = {"rel": 0.0, "seconds": {}, "frame": frame, "q1_gold": q1_gold,
           "q6_gold": q6_gold}
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
                rel = check_q1(df, q1_gold, "planner Q1")
                out["q1_launches"] = GW.window_group_sums.launches
            else:
                rel = check_q6(df, q6_gold, "planner Q6")
            out["rel"] = max(out["rel"], rel)
            out["seconds"][f"q{q}_{run}"] = {"accelerate": t1 - t0,
                                             "collect": t2 - t1}
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
#: the nodes of REST_TREES: one letter each
TREE_CODES = {
    "T": "SortedTopNExec", "S": "SortExec", "C": "CoalesceBatchesExec",
    "X": "ShuffleExchangeExec(HashPartitioning, n=16)", "J": "HashJoinExec",
    "A": "HashAggregateExec", "F": "FilterExec", "P": "ProjectExec",
    "L": "LocalBatchSource", "U": "CommonSubplanExec", "G": "FusedStageExec",
    "R": "RowToColumnarExec", "W": "ColumnarToRowExec", "H": "CpuHashJoin"}
#: phase 9's plans at 16 partitions, node by node in tree order through
#: Q21's transitions (R uploads what the CpuHashJoin islands H return, W
#: brings a device subtree down to them)
REST_TREES = {
    2: ("T P J J X U J X J X L C X J X L C X C C F L C X L C X C F L C P A "
         "U J X J X L C X J X L C X C C F L C X L"),
    11: "S C F A J X J X L C X L C X C F L",
    12: "S C A J X L C X C F L",
    13: "S C A A J X L C X C F L",
    14: "P A J X C F L C X L",
    15: "S C P J X L C X C F A X A L",
    16: "S C A A J X C F L C X J X L C X C F L",
    17: "P A J J X U L C X C U C C F L C A J X U L C X U C C F L",
    18: "T A J X J X L C X J X L C X C F A X A U L C X U L",
    19: "A J X L C X L",
    20: "S C P J X J X L C X C F J X J X L C X C F L C X A X A L C X C F L",
    21: ("T A R H H W J X J X J X L C X C F L C X C U C C F U L C X C F L W "
         "P U L W P U C C F U L"),
    22: "S C A J X C G L C X L",
}


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


def _codes(frame, name: str) -> np.ndarray:
    """The category codes of a Categorical column."""
    return frame[name].cat.codes.to_numpy()


def _strings(frame, name: str, rows) -> list:
    return frame[name].astype(str).to_numpy()[rows].tolist()


def golden_rest(a: dict, tables: dict, TD, TB) -> dict:
    """float64 numpy goldens of Q2 and Q11-Q22 over sf10_tables, from
    index arrays as golden_parts: p_partkey, s_suppkey and c_custkey are
    row + 1, partsupp row 4 (p - 1) + i is part p's supplier number i,
    and an order's lines are contiguous; category codes stand for the
    strings (p_type codes run over TYPE_S1 x TYPE_S2 x TYPE_S3, p_brand
    over Brand#11-55, p_container over CONTAIN_S1 x CONTAIN_S2), and the
    printed strings come from the frames."""
    part, supp, cust = tables["part"], tables["supplier"], tables["customer"]
    orders, li = tables["orders"], tables["lineitem"]
    d = TD.days
    n_supp, n_part, n_cust = len(supp), len(part), len(cust)
    names = [n for n, _ in TD.NATIONS]
    nat = {n: i for i, n in enumerate(names)}
    s_nat = a["s_nationkey"]
    ps_part = np.repeat(np.arange(1, n_part + 1), 4)
    ps_supp = TB.part_suppkey(ps_part, np.tile(np.arange(4), n_part), n_supp)
    ps_cost = a["ps_supplycost"]
    ps_avail = tables["partsupp"]["ps_availqty"].to_numpy()
    p_type = a["p_type"]
    p_size = part["p_size"].to_numpy()
    p_brand = _codes(part, "p_brand") + 11
    p_cont = _codes(part, "p_container")
    okey, odate = a["o_orderkey"], a["o_orderdate"]
    order_row = np.full(int(okey.max()) + 1, -1, np.int64)
    order_row[okey] = np.arange(len(okey))
    lo = order_row[a["l_orderkey"]]
    lp, ls = a["l_partkey"], a["l_suppkey"]
    qty, price = a["l_quantity"], a["l_extendedprice"]
    ship, commit, receipt = (a["l_shipdate"], a["l_commitdate"],
                             a["l_receiptdate"])
    rev = price * (1.0 - a["l_discount"])
    s_acct = supp["s_acctbal"].to_numpy()
    out = {}
    # Q2: per part the cheapest EUROPE supplier(s), for size-15 BRASS parts
    eu = (a["n_regionkey"][s_nat] == TD.REGIONS.index("EUROPE"))[ps_supp - 1]
    min_cost = np.full(n_part, np.inf)
    np.minimum.at(min_cost, ps_part[eu] - 1, ps_cost[eu])
    brass = (p_size == 15) & (p_type % 5 == TD.TYPE_S3.index("BRASS"))
    rows = np.flatnonzero(eu & brass[ps_part - 1]
                          & (ps_cost == min_cost[ps_part - 1]))
    sk, pk = ps_supp[rows] - 1, ps_part[rows]
    s_name = supp["s_name"].to_numpy()[sk]
    n_name = np.array(names, dtype=object)[s_nat[sk]]
    top = np.array(sorted(range(len(rows)), key=lambda i: (
        -s_acct[sk[i]], n_name[i], s_name[i], pk[i]))[:100], np.int64)
    sk, pk = sk[top], pk[top]
    out[2] = {"s_acctbal": s_acct[sk], "s_name": s_name[top].tolist(),
              "n_name": n_name[top].tolist(), "p_partkey": pk,
              "p_mfgr": _strings(part, "p_mfgr", pk - 1),
              **{c: _strings(supp, c, sk) for c in (
                  "s_address", "s_phone", "s_comment")}}
    # Q11: GERMANY's stock value per part above a ten-thousandth of all
    de = s_nat[ps_supp - 1] == nat["GERMANY"]
    val = ps_cost[de] * ps_avail[de]
    total = float(val.sum())
    per = np.bincount(ps_part[de] - 1, weights=val, minlength=n_part)
    hit = np.flatnonzero((per > total * 0.0001)
                         & (np.bincount(ps_part[de] - 1, minlength=n_part)
                            > 0))
    hit = hit[np.argsort(-per[hit], kind="stable")]
    out[11] = {"key": hit + 1, "value": per[hit], "total": total}
    # Q12: 1994's lines received by MAIL or SHIP, late but shipped in
    # time, counted by their order's priority
    sm = _codes(li, "l_shipmode")

    def among(codes, chosen, size):
        """codes in `chosen`, by a lookup table (np.isin sorts)."""
        lut = np.zeros(size, bool)
        lut[chosen] = True
        return lut[codes]
    modes = len(TD.SHIP_MODES)
    ok = (among(sm, [TD.SHIP_MODES.index("MAIL"),
                     TD.SHIP_MODES.index("SHIP")], modes)
          & (commit < receipt) & (ship < commit)
          & (receipt >= d("1994-01-01")) & (receipt < d("1995-01-01")))
    urgent = a["o_orderpriority"][lo[ok]] <= 1
    high = np.bincount(sm[ok], weights=urgent, minlength=modes)
    cnt = np.bincount(sm[ok], minlength=modes)
    live = [m for m in sorted(("MAIL", "SHIP"))
            if cnt[TD.SHIP_MODES.index(m)]]
    idx = [TD.SHIP_MODES.index(m) for m in live]
    out[12] = {"mode": live, "high": high[idx].astype(np.int64),
               "low": (cnt - high)[idx].astype(np.int64)}
    # Q13: customers by their number of orders without special requests
    c_count = np.bincount(a["o_custkey"][~a["o_special"]] - 1,
                          minlength=n_cust)
    dist = np.bincount(c_count)
    cc = np.flatnonzero(dist)
    order = np.lexsort((-cc, -dist[cc]))
    out[13] = {"c_count": cc[order], "custdist": dist[cc][order]}
    # Q14: the PROMO parts' share of September 1995's revenue
    ok = (ship >= d("1995-09-01")) & (ship < d("1995-10-01"))
    promo = p_type[lp - 1] // 25 == TD.TYPE_S1.index("PROMO")
    out[14] = {"promo_revenue": np.array(
        [100.0 * rev[ok & promo].sum() / rev[ok].sum()])}
    # Q15: the supplier(s) of the most revenue in 1996's first quarter
    ok = (ship >= d("1996-01-01")) & (ship < d("1996-04-01"))
    r15 = np.bincount(ls[ok] - 1, weights=rev[ok], minlength=n_supp)
    has = np.bincount(ls[ok] - 1, minlength=n_supp) > 0
    m15 = r15[has].max()
    out[15] = {"max": m15, "revenue": r15,
               "near": np.flatnonzero(has & (r15 >= m15 * (1 - JOIN_RTOL)))
               + 1}
    # Q16: distinct suppliers without complaints per brand, type, size
    medpol = ((p_type // 25 == TD.TYPE_S1.index("MEDIUM"))
              & (p_type // 5 % 5 == TD.TYPE_S2.index("POLISHED")))
    pok = (p_brand != 45) & ~medpol & np.isin(p_size,
                                              (49, 14, 23, 45, 19, 3, 36, 9))
    rows = ~a["s_complaint"][ps_supp - 1] & pok[ps_part - 1]
    pp = ps_part[rows] - 1
    grp = (p_brand[pp].astype(np.int64) * 200 + p_type[pp]) * 64 + p_size[pp]
    pairs = np.unique(grp * (n_supp + 1) + ps_supp[rows])
    gk, gcnt = np.unique(pairs // (n_supp + 1), return_counts=True)
    types = [f"{x} {y} {z}" for x in TD.TYPE_S1 for y in TD.TYPE_S2
             for z in TD.TYPE_S3]
    rows16 = sorted(((-int(c), f"Brand#{g // 64 // 200}",
                      types[g // 64 % 200], int(g % 64))
                     for g, c in zip(gk.tolist(), gcnt.tolist())))
    out[16] = {"keys": [(b, t, s) for _, b, t, s in rows16],
               "supplier_cnt": np.array([-c for c, _, _, _ in rows16])}
    # Q17: Brand#23 MED BOX lines under a fifth of their part's average
    # quantity, yearly
    medbox = (TD.CONTAIN_S1.index("MED") * len(TD.CONTAIN_S2)
              + TD.CONTAIN_S2.index("BOX"))
    lsel = ((p_brand == 23) & (p_cont == medbox))[lp - 1]
    s_q = np.bincount(lp[lsel] - 1, weights=qty[lsel], minlength=n_part)
    c_q = np.bincount(lp[lsel] - 1, minlength=n_part)
    avg = s_q / np.maximum(c_q, 1)
    keep = lsel & (qty < 0.2 * avg[lp - 1])
    out[17] = {"avg_yearly": np.array([price[keep].sum() / 7.0])}
    # Q18: the 100 dearest orders of more than 150 units
    oq = np.bincount(lo, weights=qty, minlength=len(okey))
    big = np.flatnonzero(oq > 150.0)
    tp = orders["o_totalprice"].to_numpy()
    rows = big[np.lexsort((okey[big], odate[big], -tp[big]))[:100]]
    ck = a["o_custkey"][rows]
    out[18] = {"o_orderkey": okey[rows], "c_custkey": ck,
               "o_orderdate": odate[rows], "o_totalprice": tp[rows],
               "sum_qty": oq[rows], "c_name": _strings(cust, "c_name",
                                                       ck - 1)}
    # Q19: three brand / container / quantity / size brackets, by air,
    # delivered in person

    def conts(s1, s2s):
        return among(cont, [TD.CONTAIN_S1.index(s1) * len(TD.CONTAIN_S2)
                            + TD.CONTAIN_S2.index(x) for x in s2s],
                     len(TD.CONTAIN_S1) * len(TD.CONTAIN_S2))
    brand, cont, size = p_brand[lp - 1], p_cont[lp - 1], p_size[lp - 1]
    small = ((brand == 12) & conts("SM", ("CASE", "BOX", "PACK", "PKG"))
             & (qty >= 1) & (qty <= 11) & (size <= 5))
    med = ((brand == 23) & conts("MED", ("BAG", "BOX", "PKG", "PACK"))
           & (qty >= 10) & (qty <= 20) & (size <= 10))
    large = ((brand == 34) & conts("LG", ("CASE", "BOX", "PACK", "PKG"))
             & (qty >= 20) & (qty <= 30) & (size <= 15))
    common = ((size >= 1)
              & among(sm, [TD.SHIP_MODES.index("AIR"),
                           TD.SHIP_MODES.index("REG AIR")], modes)
              & (_codes(li, "l_shipinstruct")
                 == TD.INSTRUCTIONS.index("DELIVER IN PERSON")))
    out[19] = {"revenue": np.array([rev[common & (small | med | large)]
                                    .sum()])}
    # Q20: CANADA's suppliers of forest parts holding more than half of
    # what they shipped in 1994
    forest = part["p_name"].str.startswith("forest").to_numpy(bool)
    ok = forest[lp - 1] & (ship >= d("1994-01-01")) & (ship < d("1995-01-01"))
    qty_row = np.zeros(4 * n_part)
    hit_row = np.zeros(4 * n_part, np.int64)
    lp_ok, ls_ok, qty_ok = lp[ok], ls[ok], qty[ok]
    for i in range(4):
        h = TB.part_suppkey(lp_ok, i, n_supp) == ls_ok
        r = (lp_ok[h] - 1) * 4 + i
        qty_row += np.bincount(r, weights=qty_ok[h], minlength=4 * n_part)
        hit_row += np.bincount(r, minlength=4 * n_part)
    qual = (hit_row > 0) & forest[ps_part - 1] & (ps_avail > 0.5 * qty_row)
    sk = np.unique(ps_supp[qual]) - 1
    sk = sk[s_nat[sk] == nat["CANADA"]]
    out[20] = {c: _strings(supp, c, sk) for c in ("s_name", "s_address")}
    # Q21: SAUDI ARABIA's suppliers who alone kept a multi-supplier order
    # of status F waiting
    new_order = np.r_[True, lo[1:] != lo[:-1]]
    starts = np.flatnonzero(new_order)
    seg = np.cumsum(new_order) - 1
    late = receipt > commit
    other = ((np.minimum.reduceat(ls, starts)[seg] != ls)
             | (np.maximum.reduceat(ls, starts)[seg] != ls))
    lmin = np.minimum.reduceat(np.where(late, ls, ls.max() + 1), starts)[seg]
    lmax = np.maximum.reduceat(np.where(late, ls, 0), starts)[seg]
    other_late = (lmax > 0) & ((lmin != ls) | (lmax != ls))
    l1 = (late & (s_nat[ls - 1] == nat["SAUDI ARABIA"])
          & (_codes(orders, "o_orderstatus")[lo] == "FOP".index("F")))
    wait = np.bincount(ls[l1 & other & ~other_late] - 1, minlength=n_supp)
    sk = np.flatnonzero(wait)
    sk = sk[np.lexsort((sk, -wait[sk]))][:100]
    out[21] = {"s_name": _strings(supp, "s_name", sk), "numwait": wait[sk]}
    # Q22: rich customers of seven country codes without an order
    code = a["c_nationkey"] + 10
    acct = a["c_acctbal"]
    inset = np.isin(code, (13, 31, 23, 29, 30, 18, 17))
    avg_bal = float(acct[inset & (acct > 0.0)].mean())
    keep = (inset & (acct > avg_bal)
            & (np.bincount(a["o_custkey"] - 1, minlength=n_cust) == 0))
    cc = np.unique(code[keep])
    out[22] = {"cntrycode": [str(c) for c in cc],
               "numcust": np.bincount(code[keep], minlength=35)[cc],
               "totacctbal": np.bincount(code[keep], weights=acct[keep],
                                         minlength=35)[cc],
               "avg": avg_bal}
    return out


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    require(len(got) == len(want), f"{len(got)} values, the golden "
            f"{len(want)}")
    if not len(want):
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(
        np.abs(want), np.finfo(np.float64).tiny)))


def _ranked(q: int, keys, vals, gold_keys, gold_vals) -> np.ndarray:
    """Rows ranked by a float: each row's key must be the golden's at
    its rank, or one whose value is within JOIN_RTOL of that rank's (a
    near-tie may swap).  Returns the golden values of the rows' keys."""
    require(len(keys) == len(gold_keys) and len(set(keys)) == len(keys),
            f"Q{q} rows {list(keys)[:10]}")
    at = {k: i for i, k in enumerate(gold_keys)}
    want = []
    for i, k in enumerate(keys):
        require(k in at, f"Q{q} rank {i}: {k} is not in the golden")
        j = at[k]
        require(abs(gold_vals[j] - gold_vals[i])
                <= JOIN_RTOL * abs(gold_vals[i]),
                f"Q{q} rank {i}: {k} is the golden's rank {j}")
        want.append(gold_vals[j])
    return np.asarray(want)


def check_rest_query(q: int, df, gold: dict, sub: Optional[list] = None
                     ) -> float:
    """Raise unless `df` is query q's golden answer; return the largest
    relative error of its sums.  Keys, strings, counts and order exact;
    sums and ratios within JOIN_RTOL (an order by a sum may swap a
    near-tie).  `sub` holds the frames the query's scalar subqueries
    returned: Q15's revenue must equal its max to the bit, and the
    scalars must hold against the golden's."""
    rel = 0.0
    if q == 2:
        for c in ("s_name", "n_name", "p_mfgr", "s_address", "s_phone",
                  "s_comment"):
            require(df[c].astype(str).tolist() == gold[c],
                    f"Q2 {c} differs")
        require(np.array_equal(df["p_partkey"].to_numpy(np.int64),
                               gold["p_partkey"])
                and np.array_equal(df["s_acctbal"].to_numpy(np.float64),
                                   gold["s_acctbal"]), "Q2 rows differ")
    elif q == 11:
        want = _ranked(11, df["ps_partkey"].tolist(), df["value"].tolist(),
                       gold["key"].tolist(), gold["value"])
        rel = _rel(df["value"], want)
        if sub:
            rel = max(rel, _rel(sub[0]["total"], [gold["total"]]))
    elif q == 12:
        require(df["l_shipmode"].astype(str).tolist() == gold["mode"]
                and np.array_equal(df["high_line"].to_numpy(np.int64),
                                   gold["high"])
                and np.array_equal(df["low_line"].to_numpy(np.int64),
                                   gold["low"]), "Q12 counts differ")
    elif q == 13:
        require(np.array_equal(df["c_count"].to_numpy(np.int64),
                               gold["c_count"])
                and np.array_equal(df["custdist"].to_numpy(np.int64),
                                   gold["custdist"]),
                "Q13 distribution differs")
    elif q in (14, 17, 19):
        (name,) = gold
        rel = _rel(df[name], gold[name])
    elif q == 15:
        keys = df["s_suppkey"].to_numpy(np.int64)
        require(len(keys) >= 1 and np.isin(keys, gold["near"]).all(),
                f"Q15 suppliers {keys}, the golden's {gold['near']}")
        got = df["total_revenue"].to_numpy(np.float64)
        rel = _rel(got, gold["revenue"][keys - 1])
        if sub:
            m = sub[0]["m"].to_numpy(np.float64)[0]
            require(bool(np.all(got == m)), f"Q15 revenue {got} is not "
                    f"the subquery's max {m!r} to the bit")
            rel = max(rel, _rel([m], [gold["max"]]))
    elif q == 16:
        got = list(zip(df["p_brand"].astype(str), df["p_type"].astype(str),
                       df["p_size"].astype(int)))
        require(got == gold["keys"], "Q16 groups or their order differ")
        require(np.array_equal(df["supplier_cnt"].to_numpy(np.int64),
                               gold["supplier_cnt"]), "Q16 counts differ")
    elif q == 18:
        for c in ("o_orderkey", "c_custkey", "o_orderdate"):
            require(np.array_equal(df[c].to_numpy(np.int64), gold[c]),
                    f"Q18 {c} differs")
        require(df["c_name"].astype(str).tolist() == gold["c_name"]
                and np.array_equal(df["o_totalprice"].to_numpy(np.float64),
                                   gold["o_totalprice"]),
                "Q18 names or prices differ")
        rel = _rel(df["sum_qty"], gold["sum_qty"])
    elif q == 20:
        for c in ("s_name", "s_address"):
            require(df[c].astype(str).tolist() == gold[c],
                    f"Q20 {c} differs")
    elif q == 21:
        require(df["s_name"].astype(str).tolist() == gold["s_name"]
                and np.array_equal(df["numwait"].to_numpy(np.int64),
                                   gold["numwait"]), "Q21 differs")
    else:
        require(df["cntrycode"].astype(str).tolist() == gold["cntrycode"]
                and np.array_equal(df["numcust"].to_numpy(np.int64),
                                   gold["numcust"]), "Q22 counts differ")
        rel = _rel(df["totacctbal"], gold["totacctbal"])
        if sub:
            rel = max(rel, _rel(sub[0]["a"], [gold["avg"]]))
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


def collect_spy(stats):
    """While in use, count in `stats` the plan executions a collect makes
    (a deopt retry, such as a compact-groups escalation, runs the plan
    again) and time the CPU islands: "device_to_host" is the time spent
    drawing batches out of a device subtree below an island (its
    execution and download), "cpu_joins" the CpuHashJoin work besides
    (the pandas merges and the residual condition).  Returns the undo."""
    from spark_rapids_tpu_torch.exec import base as EB
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan import transitions as TR
    saved = (EB.new_execution, N.CpuHashJoin.execute,
             TR.ColumnarToRowExec.execute)

    def new_execution():
        stats["executions"] += 1
        saved[0]()

    def timed(it):
        while True:
            t0 = time.perf_counter()
            try:
                df = next(it)
            except StopIteration:
                return
            finally:
                stats["device_to_host"] += time.perf_counter() - t0
            yield df

    def to_rows(self):
        return [timed(iter(it)) for it in saved[2](self)]

    def join(self):
        t0 = time.perf_counter()
        inner = stats["device_to_host"] + stats["cpu_joins"]
        out = saved[1](self)
        stats["cpu_joins"] += time.perf_counter() - t0 - (
            stats["device_to_host"] + stats["cpu_joins"] - inner)
        return out
    EB.new_execution = new_execution
    N.CpuHashJoin.execute = join
    TR.ColumnarToRowExec.execute = to_rows

    def undo():
        (EB.new_execution, N.CpuHashJoin.execute,
         TR.ColumnarToRowExec.execute) = saved
    return undo


def join_phase(torch, dev, tables, gold: dict, GW, K, trees=None,
               check=None, runs=("cold", "hot")) -> dict:
    """Phases 7, 8 and 9: the TPC-H queries of `gold` ({query: golden})
    at SF10 over `tables` (see the module docstring), one new plan per
    entry of `runs`, held by `check` (check_join_query /
    check_part_query by default) and against `trees` (JOIN_TREES, all
    exchanges hash exchanges, by default).  out["calls"][q] holds the
    inputs of the widest window_group_sums call of query q's last run,
    and out[kernel][f"q{q}"] that run's launches."""
    from collections import Counter

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    n = TB.SF10_PARTITIONS
    out = {"rel": 0.0, "window_group_sums": {}, "grouped_sum": {},
           "calls": {}, "grouped_calls": {}, "peak_gb_by_query": {},
           "agg_lanes": {}, "seconds": {}, "frames": {}}
    torch.cuda.reset_peak_memory_stats(dev)
    for q in gold:
        # Q21's semi and anti joins with a residual condition are CPU
        # islands, as in the reference: test.enabled allows those alone
        islands = ({C.TEST_ALLOWED_NONGPU.key: "CpuHashJoin"} if q == 21
                   else {})
        conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                             **islands})
        torch.cuda.reset_peak_memory_stats(dev)
        for run in runs:
            calls: list = []
            gcalls: list = []
            lanes_seen: Counter = Counter()
            if run == runs[-1]:
                AGG.window_group_sums = recording(calls, GW)
                AGG.grouped_sum = recording_grouped(gcalls, K)
            sub: list = []

            def run_sub(plan):
                # a scalar subquery, collected on the card as run_query
                # collects it
                df = collect(accelerate(plan, conf, device=dev), conf)
                sub.append(df)
                return df
            torch.cuda.synchronize()
            ts = time.perf_counter()
            cpu_plan = QUERIES[q](TD.sources(tables, n), run_sub)
            t0 = time.perf_counter()
            plan = accelerate(cpu_plan, conf, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            GW.window_group_sums.launches = 0
            K.grouped_sum.launches = 0
            J.sort_merge_lane.launches = J.dense_lane.launches = 0
            spied: Counter = Counter()
            undo, undo_collect = lane_spy(AGG, lanes_seen), \
                collect_spy(spied)
            try:
                df = collect(plan, conf)
            finally:
                undo()
                undo_collect()
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
            if trees is None:
                require([name for name, _ in got] == JOIN_TREES[q],
                        f"q{q} exec tree: {got}")
                exchanges = {d for name, d in got
                             if name == "ShuffleExchangeExec"}
                require(exchanges == {
                    f"ShuffleExchangeExec(HashPartitioning, n={n})"},
                    f"q{q} exchanges: {exchanges}")
            else:
                require(tree_names(plan) == trees[q],
                        f"q{q} exec tree: {tree_names(plan)}")
            lanes = [j.lane for j in walk(plan)
                     if isinstance(j, J.HashJoinExec)]
            require(all(lanes), f"q{q}: a join never ran: {lanes}")
            if check is not None:
                rel = check(q, df, gold[q], sub)
            else:
                rel = (check_join_query(q, df, gold[q]) if q < 7
                       else check_part_query(q, df, gold[q]))
            out["rel"] = max(out["rel"], rel)
            out["frames"][q] = df  # phase 12's unbudgeted result
            for k, v in launches.items():
                out[k][f"q{q}_{run}"] = out[k][f"q{q}"] = v
            out["agg_lanes"][f"q{q}_{run}"] = {
                f"{m}={d}": c for (m, d), c in sorted(lanes_seen.items())}
            out["seconds"][f"q{q}_{run}"] = {
                "subqueries": t0 - ts, "accelerate": t1 - t0,
                "collect": t2 - t1}
            islands = (f", CPU islands: device subtrees and download "
                       f"{spied['device_to_host']:.3f} s, pandas joins "
                       f"{spied['cpu_joins']:.3f} s"
                       if spied["cpu_joins"] else "")
            print(f"join q{q} {sf_of(tables)} {run}: "
                  + (f"subqueries {t0 - ts:.3f} s, " if sub else "")
                  + f"accelerate {t1 - t0:.3f} s (with the upload), "
                  f"collect {t2 - t1:.3f} s (plan runs "
                  f"{spied['executions']}{islands}), rel err {rel:.3g}, "
                  f"{len(df)} "
                  f"rows, join lanes {lanes}, probe batches {probes}, "
                  f"launches {launches}, aggregate lanes "
                  f"{out['agg_lanes'][f'q{q}_{run}']}", flush=True)
            del cpu_plan, plan, df, sub
        out["peak_gb_by_query"][q] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
    out["peak_gb"] = max(out["peak_gb_by_query"].values())
    peaks = {k: round(v, 2) for k, v in out["peak_gb_by_query"].items()}
    print(f"join queries {list(gold)} {sf_of(tables)} against the float64 "
          f"golden: "
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
    """Every node in pre-order, through the device/CPU transitions."""
    yield plan
    for c in list(plan.children) + [getattr(plan, a) for a in (
            "cpu_child", "tpu_child") if hasattr(plan, a)]:
        yield from walk(c)


def lane_spy(AGG, seen):
    """Count the lane decisions of every HashAggregateExec into `seen`
    while in use: (method, decision), a dictionary batch being one whose
    _dict_groupby_batch gave a result.  Returns the undo."""
    cls = AGG.HashAggregateExec
    saved = {m: getattr(cls, m) for m in (
        "_use_hash_grouping", "_use_banded", "_dict_groupby_batch")}

    def spy(name, fn):
        def call(self, *a, **k):
            out = fn(self, *a, **k)
            seen[name, out if isinstance(out, bool) else out is not None] \
                += 1
            return out
        return call
    for m, fn in saved.items():
        setattr(cls, m, spy(m, fn))

    def undo():
        for m, fn in saved.items():
            setattr(cls, m, fn)
    return undo


#: rows of X1's and X2's row projections drawn from orders
ETL_SAMPLE = 65_536


def java_double(x: float) -> str:
    """Java's Double.toString of x: the shortest round-trip digits (Python's
    repr), plain for 1e-3 <= |x| < 1e7, 'd.dddEexp' outside."""
    import math
    from decimal import Decimal
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    neg = "-" if math.copysign(1.0, x) < 0 else ""
    if x == 0.0:
        return neg + "0.0"
    d = Decimal(repr(abs(x)))
    digits = "".join(map(str, d.as_tuple().digits)).rstrip("0") or "0"
    e = d.adjusted()
    if -3 <= e < 7:
        if e >= 0:
            return (f"{neg}{digits[:e + 1].ljust(e + 1, '0')}."
                    f"{digits[e + 1:] or '0'}")
        return f"{neg}0.{'0' * (-e - 1)}{digits}"
    return f"{neg}{digits[0]}.{digits[1:] or '0'}E{e}"


def months_between_golden(days: np.ndarray, secs: np.ndarray,
                          origin_days: int) -> np.ndarray:
    """Spark's months_between(ts, origin at midnight) in float64 numpy,
    rounded to 8 decimals (half to even, as the engine's round)."""
    dt = days.astype("datetime64[D]")
    y = dt.astype("datetime64[Y]").astype(np.int64) + 1970
    m = dt.astype("datetime64[M]").astype(np.int64) % 12 + 1
    d = (dt - dt.astype("datetime64[M]")).astype(np.int64) + 1
    last = ((dt.astype("datetime64[M]") + 1).astype("datetime64[D]")
            - dt.astype("datetime64[M]")).astype(np.int64)
    o = np.array([origin_days]).astype("datetime64[D]")
    oy = int(o.astype("datetime64[Y]").astype(np.int64)[0]) + 1970
    om = int(o.astype("datetime64[M]").astype(np.int64)[0]) % 12 + 1
    od = int((o - o.astype("datetime64[M]")).astype(np.int64)[0]) + 1
    olast = int(((o.astype("datetime64[M]") + 1).astype("datetime64[D]")
                 - o.astype("datetime64[M]")).astype(np.int64)[0])
    tod = (secs % 86400).astype(np.float64)
    months = ((y - oy) * 12 + (m - om)).astype(np.float64)
    frac = ((d - od).astype(np.float64) + tod / 86400.0) / 31.0
    whole = ((d == last) & (od == olast)) | ((d == od) & (tod == 0))
    out = np.where(whole, months, months + frac)
    return np.round(out * 1e8) / 1e8


def golden_etl(a: dict, tables: dict, seed: int) -> dict:
    """float64 numpy goldens of phase 10's plans from the index arrays,
    and the sample of orders the row projections read."""
    gold: dict = {}
    keys, days = a["o_orderkey"], a["o_orderdate"].astype(np.int64)
    gold["x1"] = {"rows": len(keys)}
    secs = days * 86400 + keys * 7919 % 86400
    h = secs % 86400 // 3600
    mb = months_between_golden(days, secs, 8035)
    month_start = days.astype("datetime64[D]").astype(
        "datetime64[M]").astype("datetime64[D]").astype(np.int64)
    year_start = days.astype("datetime64[D]").astype(
        "datetime64[Y]").astype("datetime64[D]").astype(np.int64)
    n_h = np.bincount(h, minlength=24)
    gold["x2"] = {
        "rows": n_h,
        "sum_minute": np.bincount(h, weights=secs % 3600 // 60,
                                  minlength=24).astype(np.int64),
        "sum_second": np.bincount(h, weights=secs % 60,
                                  minlength=24).astype(np.int64),
        "sum_wd": np.bincount(h, weights=(days + 3) % 7,
                              minlength=24).astype(np.int64),
        "min_mb": np.array([mb[h == i].min() for i in range(24)]),
        "max_mb": np.array([mb[h == i].max() for i in range(24)]),
        "min_tm": np.array([month_start[h == i].min() for i in range(24)]),
        "max_ty": np.array([year_start[h == i].max() for i in range(24)]),
        "max_ta": np.array([secs[h == i].max() for i in range(24)])
        * 1_000_000 + 3_600_000_000,
        "text_len": n_h * 19}
    rng = np.random.default_rng([seed, 10])
    idx = np.sort(rng.choice(len(keys), ETL_SAMPLE, replace=False))
    gold["sample"] = {"idx": idx, "keys": keys[idx], "days": days[idx],
                      "secs": secs[idx], "mb": mb[idx],
                      "prices": tables["orders"]["o_totalprice"]
                      .to_numpy()[idx]}
    nat = a["c_nationkey"]
    gold["x3_country"] = np.bincount(nat, minlength=25)
    g = a["l_returnflag"].astype(np.int64) * 2 + a["l_linestatus"]
    price, qty = a["l_extendedprice"], a["l_quantity"]
    n = np.bincount(g, minlength=6)

    def var(vals, groups, count):
        mean = np.bincount(groups, weights=vals, minlength=len(count)) \
            / np.maximum(count, 1)
        dev = vals - mean[groups]
        return np.bincount(groups, weights=dev * dev, minlength=len(count)) \
            / np.maximum(count - 1, 1)
    okey = a["l_orderkey"]
    disc = price * (1.0 - a["l_discount"])
    gold["x4"] = {
        "rows": n, "var_price": var(price, g, n),
        "sd_qty": np.sqrt(var(qty, g, n)),
        "sum_ln": np.bincount(g, weights=a["l_linenumber"], minlength=6)
        .astype(np.int64),
        "sum_q16": np.bincount(g, weights=qty, minlength=6).astype(np.int64),
        "sum_sqrt": np.bincount(g, weights=np.sqrt(price), minlength=6),
        "sum_log10": np.bincount(g, weights=np.log10(price), minlength=6),
        "sum_band": np.bincount(g, weights=okey & 255, minlength=6)
        .astype(np.int64),
        "max_shr": np.array([(okey[g == i] >> 3).max() if n[i] else -1
                             for i in range(6)]),
        "avg_disc": np.bincount(g, weights=disc, minlength=6)
        / np.maximum(n, 1),
        "sum_qty": int(qty.sum())}
    supp = a["l_suppkey"]
    ns = np.bincount(supp)
    gold["x4_supplier"] = {"rows": ns, "sd_price": np.sqrt(var(price, supp,
                                                               ns))}
    return gold


def check_etl(name: str, df, gold: dict, tables: dict) -> float:
    """Phase 10's checks of one plan's result (see etl_phase); returns the
    largest relative error of its float columns."""
    def ints(col):
        return df[col].to_numpy(np.int64)

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                            1e-300)))
    if name == "x1":
        require(df.iloc[0].tolist() == [gold["rows"], 0, 0, 0, 0],
                f"x1: rows and round-trip misses {df.iloc[0].tolist()}")
        return 0.0
    if name == "x1_strings":
        s = gold
        iso = s["days"].astype("datetime64[D]").astype(str)
        require(list(df["k_str"]) == [str(int(k)) for k in s["keys"]],
                "x1: the key strings are not str(int)")
        require(list(df["d_str"]) == list(iso), "x1: the date strings")
        require(list(df["t_str"]) == [f"{d} 00:00:00" for d in iso],
                "x1: the timestamp strings")
        require(list(df["p_str"]) == [java_double(float(p))
                                      for p in s["prices"]],
                "x1: the price strings are not Java's Double.toString")
        return 0.0
    if name == "x2":
        df = df.sort_values("h", ignore_index=True)
        require(ints("h").tolist() == list(range(24)), "x2: the hours")
        for k in ("rows", "sum_minute", "sum_second", "sum_wd", "min_tm",
                  "max_ty", "max_ta", "text_len"):
            require(np.array_equal(ints(k), gold[k]), f"x2: {k}")
        require(int(df["d_miss"].sum()) == 0, "x2: to_date != o_orderdate")
        err = max(rel(df["min_mb"], gold["min_mb"]),
                  rel(df["max_mb"], gold["max_mb"]))
        require(err <= 1e-12, f"x2: months_between rel err {err}")
        return err
    if name == "x2_rows":
        s = gold
        secs, days = s["secs"], s["days"]
        require(np.array_equal(ints("ts"), secs * 1_000_000), "x2: ts")
        for k, want in (("h", secs % 86400 // 3600),
                        ("mi", secs % 3600 // 60), ("s", secs % 60),
                        ("td", days), ("wd", (days + 3) % 7),
                        ("ta", secs * 1_000_000 + 3_600_000_000)):
            require(np.array_equal(ints(k), want), f"x2: {k}")
        require(list(df["t_str"]) == [
            str(t).replace("T", " ")
            for t in secs.astype("datetime64[s]")], "x2: the text")
        err = rel(df["mb"], s["mb"])
        require(err <= 1e-12, f"x2: months_between rel err {err}")
        return err
    if name == "x3":
        c = tables["customer"]
        df = df.sort_values("c_custkey", ignore_index=True)
        require(np.array_equal(ints("c_custkey"), c["c_custkey"]),
                "x3: the customers")
        name_, seg = c["c_name"].astype(str), c["c_mktsegment"].astype(str)
        phone = c["c_phone"].astype(str)
        want = {"up": name_.str.upper(), "lo": seg.str.lower(),
                "ic": seg.str.lower().str.title(), "tr": phone,
                "cat": name_ + "|" + phone,
                "rep": phone.str.replace("-", ""),
                "lp": c["c_custkey"].astype(str).str.zfill(9),
                "rp": seg.str.ljust(12, "."),
                "si": phone.str.split("-").str[:2].str.join("-")}
        for k, w in want.items():
            require(list(df[k]) == list(w), f"x3: column {k}")
        require((ints("loc") == 9).all(), "x3: locate('#', c_name) != 9")
        require(np.array_equal(ints("cc"), c["c_nationkey"] + 10),
                "x3: the country code is not c_nationkey + 10")
        return 0.0
    if name == "x3_country":
        df = df.sort_values("cc", ignore_index=True)
        require(ints("cc").tolist() == list(range(10, 35)),
                "x3: the country codes")
        require(np.array_equal(ints("n"), gold), "x3: customers per code")
        return 0.0
    if name == "x4":
        df = df.sort_values(["l_returnflag", "l_linestatus"],
                            ignore_index=True)
        g = np.array(["ANR".index(f) * 2 + "FO".index(o) for f, o in
                      zip(df["l_returnflag"], df["l_linestatus"])])
        require(np.array_equal(ints("rows"), gold["rows"][g]), "x4: rows")
        require(list(df["first_status"]) == list(df["l_linestatus"])
                and list(df["last_status"]) == list(df["l_linestatus"]),
                "x4: first/last of l_linestatus")
        for k in ("sum_ln", "sum_q16", "sum_band", "max_shr"):
            require(np.array_equal(ints(k), gold[k][g]), f"x4: {k}")
        err = max(rel(df["var_price"], gold["var_price"][g]),
                  rel(df["sd_qty"], gold["sd_qty"][g]))
        require(err <= 1e-9, f"x4: var/stddev rel err {err}")
        # float64 sums on the sort lane: the moments keep X4 off the
        # f32 kernel lanes
        sums = max(rel(df["sum_sqrt"], gold["sum_sqrt"][g]),
                   rel(df["sum_log10"], gold["sum_log10"][g]))
        require(sums <= 1e-9, f"x4: float sums rel err {sums}")
        avg = df["avg_disc"].to_numpy(np.float64)
        require(np.all(np.abs(avg - gold["avg_disc"][g]) <= 0.005 + 1e-6)
                and np.allclose(avg * 100, np.round(avg * 100)),
                "x4: round(avg, 2)")
        return max(err, sums)
    if name == "x4_supplier":
        df = df.sort_values("l_suppkey", ignore_index=True)
        k = ints("l_suppkey")
        require(np.array_equal(ints("rows"), gold["rows"][k]),
                "x4: rows per supplier")
        err = rel(df["sd_price"], gold["sd_price"][k])
        require(len(df) == len(tables["supplier"]) and err <= 1e-9,
                f"x4: stddev by supplier, {len(df)} rows, rel err {err}")
        return err
    raise KeyError(name)


def etl_phase(torch, dev, tables: dict, gold: dict, GW, K) -> dict:
    """Phase 10: the ETL plans of models/etl_bench.py at SF10 over
    `tables`, 16 partitions, ETL_CONF with test.enabled (no CPU node in
    any plan): each a new plan, accelerate timed apart from its two
    collects (cold, then hot on the same plan), plan runs counted, peak
    device memory and the kernels' launches per plan, and the results
    held by check_etl; then the two ANSI casts.  out["launches"][plan]
    holds each plan's launches, out["calls"][plan] and
    out["grouped_calls"][plan] the inputs of the widest
    window_group_sums and grouped_sum calls of its last collect."""
    from collections import Counter

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.models import etl_bench as EB
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    M = EB.port_classes()
    conf = C.RapidsConf({**EB.ETL_CONF, C.TEST_ENABLED.key: True})
    n = TB.SF10_PARTITIONS
    sample = TD.sources({"orders": tables["orders"].iloc[
        gold["sample"]["idx"]].reset_index(drop=True)}, n)["orders"]
    plans = {
        "x1": (lambda: EB.x1_plan(M, TD.sources(tables, n)), gold["x1"]),
        "x1_strings": (lambda: EB.x1_strings_plan(M, sample),
                       gold["sample"]),
        "x2": (lambda: EB.x2_plan(M, TD.sources(tables, n)), gold["x2"]),
        "x2_rows": (lambda: EB.x2_rows_plan(M, sample), gold["sample"]),
        "x3": (lambda: EB.x3_plan(M, TD.sources(tables, n)), None),
        "x3_country": (lambda: EB.x3_country_plan(M, TD.sources(tables, n)),
                       gold["x3_country"]),
        "x4": (lambda: EB.x4_plan(M, TD.sources(tables, n)), gold["x4"]),
        "x4_supplier": (lambda: EB.x4_supplier_plan(
            M, TD.sources(tables, n)), gold["x4_supplier"]),
    }
    out = {"seconds": {}, "launches": {}, "peak_gb": {}, "rel": 0.0,
           "calls": {}, "grouped_calls": {}}
    wrappers = {"q1_fused": K.q1_fused, "grouped_sum": K.grouped_sum,
                "window_group_sums": GW.window_group_sums}

    def counted_collect(name, plan, record):
        """collect(plan) with the kernels' launches counted into
        out["launches"][name] and, if `record`, their widest calls kept."""
        calls: list = []
        gcalls: list = []
        if record:
            AGG.window_group_sums = recording(calls, GW)
            AGG.grouped_sum = recording_grouped(gcalls, K)
        before = {k: f.launches for k, f in wrappers.items()}
        try:
            return collect(plan, conf)
        finally:
            AGG.window_group_sums = GW.window_group_sums
            AGG.grouped_sum = K.grouped_sum
            seen = out["launches"].setdefault(name, dict.fromkeys(before, 0))
            for k, f in wrappers.items():
                seen[k] += f.launches - before[k]
            if calls:
                out["calls"][name] = calls
            if gcalls:
                out["grouped_calls"][name] = gcalls

    for name, (build, g) in plans.items():
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = accelerate(build(), conf, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        require(isinstance(plan, TpuExec), f"{name}: a CPU node")
        times, runs = [], []
        for run in ("cold", "hot"):
            spied: Counter = Counter()
            undo = collect_spy(spied)
            ta = time.perf_counter()
            try:
                df = counted_collect(name, plan, run == "hot")
            finally:
                undo()
            times.append(time.perf_counter() - ta)
            runs.append(spied["executions"])
        launches = out["launches"][name]
        err = check_etl(name, df, g, tables)
        out["rel"] = max(out["rel"], err)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out["seconds"][name] = {"accelerate": t1 - t0, "cold": times[0],
                                "hot": times[1]}
        out["peak_gb"][name] = peak
        print(f"etl {name} {sf_of(tables)}: accelerate {t1 - t0:.3f} s "
              f"(with the upload), collect cold {times[0]:.3f} s / hot "
              f"{times[1]:.3f}"
              f" s (plan runs {runs[0]} / {runs[1]}), {len(df)} rows, peak "
              f"{peak:.2f} GiB, max rel err {err:.3g}, launches {launches}",
              flush=True)
        del plan, df
    # ANSI: an overflowing cast raises at collect, one in range sums
    for column, to, raises in (("l_extendedprice", M.T.INT16, True),
                               ("l_quantity", M.T.INT8, False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = accelerate(EB.x4_ansi_plan(M, TD.sources(tables, n), column,
                                          to), conf, device=dev)
        raised = None
        try:
            df = counted_collect(f"ansi_{column}", plan, True)
        except ArithmeticError as e:
            raised = str(e)
        want = (f"ANSI cast float64 -> {to} overflow "
                f"(spark.sql.ansi.enabled semantics)")
        if raises:
            require(raised == want, f"ANSI {column} -> {to}: {raised!r}")
        else:
            require(raised is None and int(df["total"][0]) ==
                    gold["x4"]["sum_qty"], f"ANSI {column} -> {to}")
        out["seconds"][f"ansi_{column}"] = time.perf_counter() - t0
        print(f"etl ANSI cast({column} as {to}) {sf_of(tables)}: "
              f"{'raised ' + repr(raised) if raised else 'in range'}, "
              f"{time.perf_counter() - t0:.3f} s, launches "
              f"{out['launches'][f'ansi_{column}']}", flush=True)
        del plan
    return out


# -- phase 12: the memory layer ---------------------------------------------
#: each budgeted plan of 12a runs under spark.rapids.memory.hbmBudgetBytes
#: = its unbudgeted peak max_memory_allocated / MEM_BUDGET_SHARE
MEM_BUDGET_SHARE = 4
#: ... but the aggregate at an eighth: its own merge, ~7x its partial
#: state, sets its peak, so at a quarter the partial state's estimate
#: (2x its bytes, 1.9 GB at SF5) stays under the budget (3.1 GB) and it
#: never spills (measured on an H100); at an eighth it does
MEM_AGG_BUDGET_SHARE = 8
#: the host tier of phase 12's spills (the machine holds 96 GiB); what it
#: cannot hold falls through to disk
MEM_HOST_SPILL = 16 << 30
#: 12b: Q5 under seeded OOM injection
MEM_INJECT = {"spark.rapids.memory.faultInjection.oomRate": 0.05,
              "spark.rapids.memory.faultInjection.seed": 0}
#: the lineitem columns of 12a's SortExec (all but the three comment-like
#: strings), uploaded in batches of SORT_BATCH_ROWS (6 at SF1; 1 << 22,
#: 8 batches, at SF5)
SORT_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                "l_returnflag", "l_linestatus", "l_shipdate",
                "l_commitdate", "l_receiptdate")
SORT_BATCH_ROWS = 1 << 20
#: 12a's aggregate reads (l_partkey, l_quantity) in batches of this many
#: rows (23 at SF1; 1 << 20, 29 batches, at SF5): each touches most of
#: the parts, so its partial state grows with the batch count, as a
#: scan's does
AGG_BATCH_ROWS = 1 << 18
#: the disk tier's directory (git-ignored), emptied when a phase-12
#: environment closes
SPILL_DIR = Path(__file__).resolve().parent / ".spill"
_MEM_METRICS = ("spillRunBytes", "numExternalMergePasses",
                "numGracePartitions", "numRetries", "numSplitRetries",
                "numOomFallbacks", "spillBytes")


def plan_cases(phase: str, runs: dict, window_case, grouped_case) -> dict:
    """The widest call of each kernel in each of a phase's plans (`runs`:
    {label: run_plan's info}) against its twin, as phases 7-11 hold
    theirs, the recorded inputs freed as they are checked.  Every plan
    that launched a kernel must have its call checked, window_group_sums
    must launch in the phase, and q1_fused in none of its plans (no call
    of it is recorded there)."""
    cases: dict = {"window_group_sums": [], "grouped_sum": []}
    for label, info in runs.items():
        launches = info["launches"]
        require(launches["q1_fused"] == 0,
                f"q1_fused launched in {label}: no call of it is checked")
        if info["calls"]:
            gid, vals, cap = info.pop("calls")
            case = window_case(gid, vals, cap)
            case.update(plan=label, launches=launches["window_group_sums"],
                        shape=f"{label} widest call: capacity "
                        f"{gid.numel()}, out_cap {cap}, M={len(vals)}")
            print(kernel_text("window_group_sums", case), flush=True)
            cases["window_group_sums"].append(case)
            del gid, vals
        if info["grouped_calls"]:
            keys, vals, rows, groups = info.pop("grouped_calls")
            case = grouped_case(keys, vals, rows, groups, None)
            case.update(plan=label, launches=launches["grouped_sum"],
                        shape=f"{label} widest call: capacity "
                        f"{keys.numel()}, G={groups}, M={len(vals)}, tier "
                        f"{case['tier']}")
            print(kernel_text("grouped_sum", case), flush=True)
            cases["grouped_sum"].append(case)
            del keys, vals
    for kernel, done in cases.items():
        checked = {c["plan"] for c in done}
        require(all(label in checked for label, i in runs.items()
                    if i["launches"][kernel]),
                f"{kernel} launched in a phase-{phase} plan whose call was "
                f"not checked")
    require(cases["window_group_sums"],
            f"window_group_sums never launched in phase {phase}")
    return cases


def run_plan(torch, dev, GW, K, make_plan, fetch, calls=None,
             gcalls=None) -> tuple:
    """One plan on the card with phase 7's spies: `make_plan()` builds
    the card's exec tree (a scalar subquery collects inside it, so its
    launches count) and `fetch(plan)` collects it.  Each kernel's
    launches count from 0, the inputs of each kernel's widest call go to
    `calls` and `gcalls` (runs that share them keep the widest of all),
    the plan runs are counted and the peak device memory read; returns
    (result, plan, info)."""
    from collections import Counter

    from spark_rapids_tpu_torch.exec import aggregate as AGG
    calls = [] if calls is None else calls
    gcalls = [] if gcalls is None else gcalls
    spied: Counter = Counter()
    GW.window_group_sums.launches = 0
    K.grouped_sum.launches = K.q1_fused.launches = 0
    AGG.window_group_sums = recording(calls, GW)
    AGG.grouped_sum = recording_grouped(gcalls, K)
    undo = collect_spy(spied)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        plan = make_plan()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fetch(plan)
        torch.cuda.synchronize()
    finally:
        undo()
        AGG.window_group_sums = GW.window_group_sums
        AGG.grouped_sum = K.grouped_sum
    t2 = time.perf_counter()
    return out, plan, {
        "accelerate_s": t1 - t0, "collect_s": t2 - t1, "seconds": t2 - t0,
        "peak": torch.cuda.max_memory_allocated(dev),
        "runs": spied["executions"],
        "launches": {"window_group_sums": GW.window_group_sums.launches,
                     "grouped_sum": K.grouped_sum.launches,
                     "q1_fused": K.q1_fused.launches},
        "calls": calls, "grouped_calls": gcalls}


def tree_metrics(plan) -> dict:
    """The memory metrics summed over every exec of `plan`, and the
    spill-run bytes by exec class."""
    from collections import Counter
    out = dict.fromkeys(_MEM_METRICS, 0.0)
    by_exec: Counter = Counter()
    for node in walk(plan):
        ms = getattr(node, "metrics", None)
        if ms is None:
            continue
        for name in _MEM_METRICS:
            v = ms.value(name)
            out[name] += v
            if name == "spillRunBytes" and v:
                by_exec[type(node).__name__] += v
    out["spill_run_bytes_by_exec"] = dict(by_exec)
    return out


def memory_env(dev, extra: dict):
    """A ResourceEnv on `dev` (catalog, device -> host -> disk stores, a
    DeviceManager made from the conf) under TPC bench conf +
    test.enabled + `extra`; returns (conf, env)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.memory import ResourceEnv
    from spark_rapids_tpu_torch.memory import oocore as OC
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                         C.HOST_SPILL_STORAGE.key: MEM_HOST_SPILL, **extra})
    env = ResourceEnv.init(conf, spill_dir=str(SPILL_DIR), device=dev)
    R.reset_oom_injection()
    OC.reset_run_accounting()
    return conf, env


def memory_report(env) -> dict:
    """What an environment spilled, by tier, and what it still holds
    (a finished plan must hold no run and no reservation)."""
    from spark_rapids_tpu_torch.memory import oocore as OC
    require(len(env.catalog) == 0,
            f"{len(env.catalog)} spilled buffers outlived their plan")
    require(env.device_manager.reserved_bytes == 0,
            "a reservation outlived its plan")
    return {"run_bytes": OC.run_bytes_spilled(), "runs": OC.runs_spilled(),
            "host_bytes": env.host_store.bytes_added,
            "disk_bytes": env.disk_store.bytes_added,
            "device_to_host_bytes": env.spill_callback.bytes_spilled}


def memory_query(torch, dev, q: int, tables: dict, conf, GW, K) -> tuple:
    """TPC-H query q as run_query runs it (a new plan, accelerate and
    collect at 16 partitions) through run_plan: (result, info), with the
    plan's memory metrics."""
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

    def run_sub(plan):
        return collect(accelerate(plan, conf, device=dev), conf)
    df, plan, info = run_plan(
        torch, dev, GW, K, lambda: accelerate(QUERIES[q](
            TD.sources(tables, TB.SF10_PARTITIONS), run_sub), conf,
            device=dev), lambda plan: collect(plan, conf))
    info["metrics"] = tree_metrics(plan)
    return df, info


def same_frame(want, got, rtol: float, label: str) -> float:
    """`got` equals `want` row for row: every non-float column exact
    (keys, counts, dates, strings, order), float columns within `rtol`.
    Returns the max rel err."""
    require(list(want.columns) == list(got.columns),
            f"{label}: columns {list(got.columns)}")
    require(len(want) == len(got), f"{label}: {len(got)} rows, "
            f"unbudgeted {len(want)}")
    rel = 0.0
    for c in want.columns:
        if want[c].dtype.kind == "f" or str(want[c].dtype).startswith(
                "Float"):
            rel = max(rel, _rel(got[c], want[c]))
        else:
            require(want[c].astype(object).tolist()
                    == got[c].astype(object).tolist(),
                    f"{label}: column {c} differs")
    require(rel <= rtol, f"{label}: rel err {rel}")
    return rel


def same_batch_bits(want, got, label: str) -> None:
    """Two batches with the same rows, bit for bit, on the device."""
    import torch
    require(want.num_rows == got.num_rows, f"{label}: {got.num_rows} "
            f"rows, unbudgeted {want.num_rows}")
    n = want.num_rows
    for f, a, b in zip(want.schema.fields, want.columns, got.columns):
        require(torch.equal(a.validity[:n], b.validity[:n]),
                f"{label}: {f.name} validity differs")
        if f.dtype.is_string:
            require(torch.equal(a.lengths[:n], b.lengths[:n]),
                    f"{label}: {f.name} lengths differ")
            w = min(a.char_cap, b.char_cap)
            require(torch.equal(a.data[:n, :w], b.data[:n, :w]),
                    f"{label}: {f.name} bytes differ")
        else:
            require(torch.equal(a.data[:n].view(torch.uint8),
                                b.data[:n].view(torch.uint8)),
                    f"{label}: {f.name} bits differ")


def same_groups(want, got, rtol: float, label: str) -> float:
    """Two (key, sum) batches with the same groups: keys and nulls
    exact, sums within `rtol`, compared on the device in key order.
    Returns the max rel err."""
    import torch
    n = want.num_rows
    require(n == got.num_rows, f"{label}: {got.num_rows} groups, "
            f"unbudgeted {n}")
    kw, kg = want.columns[0].data[:n], got.columns[0].data[:n]
    ow, og = torch.argsort(kw), torch.argsort(kg)
    require(torch.equal(kw[ow], kg[og]), f"{label}: keys differ")
    vw, vg = want.columns[1], got.columns[1]
    require(torch.equal(vw.validity[:n][ow], vg.validity[:n][og]),
            f"{label}: nulls differ")
    sw, sg = vw.data[:n][ow], vg.data[:n][og]
    rel = float(((sg - sw).abs() / sw.abs().clamp_min(
        np.finfo(np.float64).tiny)).max().item()) if n else 0.0
    require(rel <= rtol, f"{label}: rel err {rel}")
    return rel


def _mem_line(name: str, info: dict, base_s: float, base_peak: int,
              budget: int, report: dict, rel: float,
              share: int = MEM_BUDGET_SHARE) -> str:
    m = info["metrics"]
    return (f"memory {name}: budget {budget} bytes (unbudgeted peak "
            f"{base_peak} / {share}), peak {info['peak']} "
            f"bytes ({info['peak'] / max(budget, 1):.2f}x the budget), "
            f"wall {info['seconds']:.3f} s against {base_s:.3f} s "
            f"unbudgeted, plan runs {info['runs']}, spilled runs "
            f"{report['runs']} ({report['run_bytes']} bytes: host tier "
            f"{report['host_bytes']}, disk tier {report['disk_bytes']}, "
            f"device store to host {report['device_to_host_bytes']}), "
            f"spill-run bytes by exec {m['spill_run_bytes_by_exec']}, "
            f"grace partitions {m['numGracePartitions']:g}, external "
            f"merge passes {m['numExternalMergePasses']:g}, retries "
            f"{m['numRetries']:g}, split retries {m['numSplitRetries']:g}, "
            f"launches {info['launches']}, rel err {rel:.3g}")


def memory_phase(torch, dev, tables: dict, unbudgeted: dict, checks: dict,
                 gold5: dict, GW, K) -> dict:
    """Phase 12 over phases 7-10's tables.  12a: Q18 and Q9 (their
    unbudgeted frames and peaks from phases 8-9 in `unbudgeted`, their
    golden checks in `checks`) and a SortExec over lineitem by
    (l_shipdate, l_orderkey desc, l_linenumber), each under a budget of
    a quarter of its unbudgeted peak: results equal to the unbudgeted
    ones, and the aggregate's spill, the grace-hash join and the
    external merge each engaged in one of them.  12b: Q5 under seeded
    OOM injection equal to phase 7's golden, with retries and split
    retries.  The native runtime must be live."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exec.sort import SortExec, asc, desc
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.memory import ResourceEnv
    from spark_rapids_tpu_torch.memory import native
    from spark_rapids_tpu_torch.plan.nodes import schema_of_df
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    require(native.implementation() == "native",
            f"the native host runtime is not live: {native.build_error}")
    out = {"plans": {}, "runs": {}}

    def keep(name, info):
        out["runs"][name] = {k: info[k] for k in (
            "launches", "calls", "grouped_calls")}

    # 12a: Q18 and Q9 under a quarter of their peaks
    for q in (18, 9):
        base = unbudgeted[q]
        budget = int(base["peak"]) // MEM_BUDGET_SHARE
        conf, env = memory_env(dev, {C.HBM_BUDGET_BYTES.key: budget})
        try:
            df, info = memory_query(torch, dev, q, tables, conf, GW, K)
            report = memory_report(env)
        finally:
            ResourceEnv.shutdown()
        rel = same_frame(base["frame"], df, JOIN_RTOL, f"Q{q} budgeted")
        checks[q](df)
        keep(f"q{q}_budget", info)
        out["plans"][f"q{q}_budget"] = {
            "budget": budget, "unbudgeted_peak": int(base["peak"]),
            "unbudgeted_s": base["seconds"], "seconds": info["seconds"],
            "peak": info["peak"], "runs": info["runs"],
            "metrics": info["metrics"], "report": report, "rel": rel}
        print(_mem_line(f"Q{q} {sf_of(tables)}", info, base["seconds"],
                        int(base["peak"]), budget, report, rel), flush=True)
        del df

    # 12a: through the exec tree over lineitem in one partition, in core,
    # then budgeted: a SortExec, and Q17's subquery aggregate
    # (avg(l_quantity) by l_partkey, whose 1M groups every batch touches)
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exprs.aggregates import Average
    from spark_rapids_tpu_torch.models import tpch_bench as TB

    def upload(names, rows):
        frame = tables["lineitem"][list(names)]
        schema = schema_of_df(frame)
        return [batch_from_df(frame.iloc[lo:lo + rows], schema, dev)
                for lo in range(0, len(frame), rows)]
    t0 = time.perf_counter()
    batches = upload(SORT_COLUMNS, SORT_BATCH_ROWS)
    agg_batches = upload(("l_partkey", "l_quantity"), AGG_BATCH_ROWS)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    print(f"memory lineitem: {len(tables['lineitem'])} rows, "
          f"{len(SORT_COLUMNS)} columns in {len(batches)} batches for the "
          f"sort, 2 in {len(agg_batches)} for the aggregate, upload "
          f"{upload_s:.3f} s", flush=True)
    exec_plans = {
        "sort": lambda: SortExec(
            [asc(col("l_shipdate")), desc(col("l_orderkey")),
             asc(col("l_linenumber"))],
            LocalBatchSource([batches], device=dev)),
        "agg": lambda: HashAggregateExec(
            [col("l_partkey")], [Average(col("l_quantity")).alias("avg_qty")],
            LocalBatchSource([agg_batches], device=dev))}

    def exec_run(name, conf, calls, gcalls):
        def fetch(plan):
            with C.session(conf):
                return plan.collect()
        got, plan, info = run_plan(torch, dev, GW, K, exec_plans[name],
                                   fetch, calls, gcalls)
        info["metrics"] = tree_metrics(plan)
        return got, info

    for name in ("sort", "agg"):
        # the unbudgeted run's kernel calls are checked with the
        # budgeted run's: the recorders keep the widest of both
        calls, gcalls = [], []
        want, base = exec_run(name, C.RapidsConf(dict(TB.BENCH_CONF)),
                              calls, gcalls)
        require(base["metrics"]["spillRunBytes"] == 0,
                f"the unbudgeted {name} went external")
        share = MEM_AGG_BUDGET_SHARE if name == "agg" else MEM_BUDGET_SHARE
        budget = base["peak"] // share
        conf, env = memory_env(dev, {C.HBM_BUDGET_BYTES.key: budget})
        try:
            got, info = exec_run(name, conf, calls, gcalls)
            report = memory_report(env)
        finally:
            ResourceEnv.shutdown()
        if name == "sort":
            # (l_orderkey, l_linenumber) is unique: one total order
            same_batch_bits(want, got, "lineitem sort budgeted")
            rel = 0.0
        else:
            rel = same_groups(want, got, JOIN_RTOL,
                              "lineitem aggregate budgeted")
        keep(f"{name}_budget", info)
        out["plans"][f"{name}_budget"] = {
            "budget": budget, "budget_share": share,
            "unbudgeted_peak": base["peak"],
            "unbudgeted_s": base["seconds"],
            "unbudgeted_runs": base["runs"], "seconds": info["seconds"],
            "peak": info["peak"], "runs": info["runs"],
            "metrics": info["metrics"], "report": report, "rel": rel}
        print(_mem_line(f"lineitem {name} {sf_of(tables)}", info,
                        base["seconds"], base["peak"], budget, report, rel,
                        share), flush=True)
        del want, got
    del batches, agg_batches
    engaged = {
        "aggregate spill": any(
            p["metrics"]["spill_run_bytes_by_exec"].get("HashAggregateExec")
            for p in out["plans"].values()),
        "grace-hash join": any(p["metrics"]["numGracePartitions"] > 0
                               for p in out["plans"].values()),
        "external merge sort": out["plans"]["sort_budget"]["metrics"][
            "numExternalMergePasses"] > 0}
    print(f"memory 12a lanes engaged: {engaged}", flush=True)
    require(all(engaged.values()), f"12a: a lane never engaged: {engaged}")

    # 12b: Q5 under seeded OOM injection
    conf, env = memory_env(dev, MEM_INJECT)
    try:
        from spark_rapids_tpu_torch.memory import retry as R
        df, info = memory_query(torch, dev, 5, tables, conf, GW, K)
        report = memory_report(env)
        injected = R.injected_oom_count()
    finally:
        ResourceEnv.shutdown()
    rel = check_join_query(5, df, gold5)
    m = info["metrics"]
    require(injected > 0 and m["numRetries"] > 0
            and m["numSplitRetries"] > 0,
            f"12b: injections {injected}, retries {m['numRetries']}, "
            f"split retries {m['numSplitRetries']}")
    keep("q5_inject", info)
    out["plans"]["q5_inject"] = {
        "seconds": info["seconds"], "peak": info["peak"],
        "runs": info["runs"], "metrics": m, "report": report, "rel": rel,
        "injected": injected}
    print(f"memory Q5 {sf_of(tables)} under oomRate 0.05, seed 0: "
          f"{injected} injected failures, retries {m['numRetries']:g}, "
          f"split retries {m['numSplitRetries']:g}, fallbacks "
          f"{m['numOomFallbacks']:g}, collect {info['seconds']:.3f} s, "
          f"plan runs {info['runs']}, against the golden rel err "
          f"{rel:.3g}, launches {info['launches']}", flush=True)
    return out


#: TPC-H scale factor of phases 7-10's and 12's tables: cut from 10 when
#: phase 11 came and from 5 when 13b ran the 85, to keep the script
#: within 950 s of its 1,200 s limit
JOIN_SF = 1.0
#: sums and averages of phase 11a's card results against the CPU
#: engine: the banded lane adds in f32
DS_RTOL = 1e-3
#: phase 13a's TPC-DS and TPCx-BB tables: store_sales rows and seed (the
#: reference fixture's, tests/test_workloads.py, where every query keeps
#: support; at seed 0 q31's result is empty), and its Mortgage loans
WL_CHECK_SCALE = 20_000
WL_CHECK_SEED = 3
WL_CHECK_LOANS = 1_000
#: phases 11b's and 13b's store_sales rows (SF1 has 2,880,404, TPC-DS
#: Table 3-2), and 13b's Mortgage loans (see the cuts above)
WL_SCALE = 50_000
MORTGAGE_LOANS = 1_000_000
#: months of performance records per loan in phase 13
MORTGAGE_MONTHS = 24
EPS64 = float(np.finfo(np.float64).eps)
#: phase 11's TPC-DS queries: the 18 with a window, a ROLLUP or a UNION
#: ALL (phase 13 runs the other 85)
DS_SLICE = ("q5", "q14", "q18", "q22", "q27", "q36", "q44", "q47", "q49",
            "q51", "q53", "q57", "q67", "q70", "q77", "q80", "q86", "q89")


def query_order(name: str) -> tuple:
    """Sort key of a query name: its number, then its suffix (q14 before
    q14b before q15)."""
    digits = "".join(c for c in name if c.isdigit())
    return int(digits), name


def _ds_norm(df):
    """`df` with every non-float column as text (None for null) and
    every float column as float64 (NaN for null)."""
    import pandas as pd
    out = {}
    for c in df.columns:
        s = df[c]
        if str(s.dtype).lower() in ("float64", "float32"):
            out[c] = pd.to_numeric(s, errors="coerce").astype("float64") \
                .to_numpy()
        else:
            out[c] = pd.Series([None if v is None or v is pd.NA or (
                isinstance(v, float) and v != v) else str(v)
                for v in s], dtype=object)
    return pd.DataFrame(out)


def _ds_rows(df):
    """_ds_norm's frame with its rows sorted by the text columns, then
    by the floats to 4 significant digits (row sets compare in one
    order whatever the engines' order of ties)."""
    out = _ds_norm(df)
    text = [c for c in out.columns if out[c].dtype == object]
    rounded = {f"__{c}": out[c].map(lambda v: f"{v:.4e}")
               for c in out.columns if c not in text}
    order = out.assign(**rounded).fillna("").sort_values(
        text + list(rounded)).index
    return out.loc[order].reset_index(drop=True)


def _ds_same(want, got, rtol: float, label: str) -> float:
    """Normalized frames column by column in row order: nulls and text
    exact, floats within rtol.  Returns the largest relative float
    error."""
    require(list(want.columns) == list(got.columns),
            f"{label}: columns {list(got.columns)}")
    require(len(want) == len(got),
            f"{label}: {len(got)} rows, expected {len(want)}")
    rel = 0.0
    for c in want.columns:
        w, g = want[c].to_numpy(), got[c].to_numpy()
        if w.dtype == object or g.dtype == object:
            require(w.tolist() == g.tolist(), f"{label}: column {c}")
            continue
        require(np.array_equal(np.isnan(w), np.isnan(g)),
                f"{label}: nulls of {c}")
        ok = ~np.isnan(w)
        if ok.any():
            rel = max(rel, float(np.max(np.abs(g[ok] - w[ok]) / np.maximum(
                np.abs(w[ok]), 1e-12))))
            require(np.allclose(g[ok], w[ok], rtol=rtol, atol=1e-9),
                    f"{label}: column {c} beyond rtol {rtol}")
    return rel


def ds_order_columns(plan) -> list:
    """The output columns a plan's final sort orders by ([] where no
    sort orders the result: a global aggregate, a row of scalars)."""
    from spark_rapids_tpu_torch.exprs.base import AttributeReference
    from spark_rapids_tpu_torch.plan.nodes import CpuSort
    out = set(plan.output_schema().names)
    node = plan
    while not isinstance(node, CpuSort):
        if not node.children:
            return []
        node = node.children[0]
    return [o.expr.name for o in node.order
            if isinstance(o.expr, AttributeReference) and o.expr.name in out]


def check_ds_query(q: str, want, got, order_cols) -> float:
    """Phase 11a: the card's result of query q against the CPU engine's:
    the row sets (keys, strings, ranks, row numbers and counts exact;
    sums and averages rtol DS_RTOL) and the sequence of every sort key
    in result order."""
    rel = _ds_same(_ds_rows(want), _ds_rows(got), DS_RTOL, q)
    for c in order_cols:
        _ds_same(_ds_norm(want[[c]]), _ds_norm(got[[c]]), DS_RTOL,
                 f"{q} order of {c}")
    return rel


def widest_inputs(widest: dict, EX, W):
    """While in use, keep in `widest` the widest input batch (the first
    of the largest capacity) of every ExpandExec and WindowExec that
    runs: {exec_id: (exec, batch)}.  Returns the undo."""
    saved = (EX.ExpandExec.expand_batch, W.WindowExec.window_batch)

    def keep(fn):
        def call(self, batch):
            have = widest.get(self.exec_id)
            if have is None or batch.capacity > have[1].capacity:
                widest[self.exec_id] = (self, batch)
            return fn(self, batch)
        return call
    EX.ExpandExec.expand_batch = keep(saved[0])
    W.WindowExec.window_batch = keep(saved[1])

    def undo():
        EX.ExpandExec.expand_batch, W.WindowExec.window_batch = saved
    return undo


def check_exec_batch(ex, batch, W) -> dict:
    """One ExpandExec's or WindowExec's widest input batch, downloaded:
    the exec's device output against CpuExpand / the CPU window
    evaluation over the same rows, in the same row order.  Exact, but
    for window sums and averages of floats: within n*eps*sum|x| of that
    function's input over the batch."""
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval
    from spark_rapids_tpu_torch.plan.transitions import df_from_batch
    t0 = time.perf_counter()
    schema = ex.child.output_schema()
    df_in = df_from_batch(batch)
    is_window = isinstance(ex, W.WindowExec)
    got = df_from_batch(ex.window_batch(batch) if is_window
                        else ex.expand_batch(batch))
    t1 = time.perf_counter()
    tol = {}
    if is_window:
        names = ex.output_schema().names[-len(ex.fns):]
        pairs = list(zip(ex.fns, names))
        want = N.normalize_df(W._cpu_window_eval(
            df_in, schema, ex.spec, pairs), ex.output_schema())
        for fn, name in pairs:
            if fn.kind in ("sum", "avg") and (
                    fn.kind == "avg" or
                    fn.child.data_type(schema).is_floating):
                x = cpu_eval(fn.child, df_in, schema).astype("Float64")
                x = np.abs(x.dropna().to_numpy(np.float64))
                tol[name] = len(df_in) * EPS64 * float(x.sum())
    else:
        stand_in = N.CpuSource([], schema)
        want = N.CpuExpand(ex.projections, ex.output_schema().names,
                           stand_in)._expand_df(df_in)
    t2 = time.perf_counter()
    require(len(want) == len(got), f"{ex.describe()}: rows differ")
    worst = 0.0
    for c in want.columns:
        w, g = _ds_norm(want[[c]])[c].to_numpy(), \
            _ds_norm(got[[c]])[c].to_numpy()
        if c in tol:
            require(np.array_equal(np.isnan(w), np.isnan(g)),
                    f"{ex.describe()}: nulls of {c}")
            ok = ~np.isnan(w)
            err = float(np.max(np.abs(g[ok] - w[ok]))) if ok.any() else 0.0
            require(err <= tol[c], f"{ex.describe()}: {c} off by {err} "
                    f"past n*eps*sum|x| = {tol[c]}")
            worst = max(worst, err / tol[c] if tol[c] else 0.0)
        else:
            require(w.tolist() == g.tolist() if w.dtype == object
                    else np.array_equal(w, g, equal_nan=True),
                    f"{ex.describe()}: column {c} differs")
    return {"exec": ex.describe(), "rows": len(df_in),
            "out_rows": len(got), "download_s": t1 - t0,
            "cpu_s": t2 - t1, "worst_sum_share_of_bound": worst}


class Workload(NamedTuple):
    """A suite of the port's models: its name, its queries (name ->
    fn(t, run) -> CpuNode) and its sources(tables, num_partitions)."""
    name: str
    queries: dict
    sources: Callable


def workload(name: str) -> Workload:
    """"tpcds" (103 queries), "tpcxbb" (30) or "mortgage" (etl_plan and
    summary_plan)."""
    if name == "tpcds":
        from spark_rapids_tpu_torch.models import tpcds_data as DD
        from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES

        def sources(tables: dict, n: int) -> dict:
            return DD.sources({k: v for k, v in tables.items()
                               if k in DD.SCHEMAS}, n)
        return Workload(name, QUERIES, sources)
    if name == "tpcxbb":
        from spark_rapids_tpu_torch.models import tpcxbb as X
        return Workload(name, X.QUERIES, X.sources)
    from spark_rapids_tpu_torch.models import mortgage as M
    return Workload(name, {
        "etl_plan": lambda t, run: M.etl_plan(t),
        "summary_plan": lambda t, run: M.summary_plan(t)}, M.sources)


def workload_tables(seed: int, scale: int) -> dict:
    """tpcxbb.gen_tables at `scale` store_sales rows from `seed`: the
    TPC-DS tables of tpcds_bench.sf10_tables(seed, scale), then a
    clickstream of 3x scale rows and the product reviews."""
    from spark_rapids_tpu_torch.models import tpcxbb as X
    return X.gen_tables(np.random.default_rng(seed), scale)


def mortgage_tables(seed: int, loans: int, months: int) -> dict:
    from spark_rapids_tpu_torch.models import mortgage as M
    return M.gen_tables(np.random.default_rng(seed), loans=loans,
                        months=months)


def make_tables(spec: tuple) -> dict:
    """("workload", seed, scale): workload_tables(seed, scale);
    ("mortgage", seed, loans, months): mortgage_tables(...)."""
    kind, *args = spec
    return workload_tables(*args) if kind == "workload" \
        else mortgage_tables(*args)


def card_run(torch, dev, conf, laps: list):
    """The `run` a user's query calls: collect(accelerate(plan)) on the
    card, each call's wall time (to the card's last kernel) in `laps`."""
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

    def run(plan):
        t0 = time.perf_counter()
        df = collect(accelerate(plan, conf, device=dev), conf)
        torch.cuda.synchronize(dev)
        laps.append(time.perf_counter() - t0)
        return df
    return run


#: processes that compute check_queries' CPU-engine results while the
#: card runs the same queries (the CPU engine took a fifth of 13a's
#: time, q72 alone ~40 s)
CPU_WORKERS = 2
#: spawned processes that run phases 13a's, 11b's and 13b's queries on
#: the card beside the main process (card_pool, spread), one query at a
#: time each: at these scales the engine is host-bound (a TPC-DS query
#: at 20,000 store_sales rows holds the card ~2 s, nearly all of it the
#: host's), so three processes on one card run the queries in about a
#: third of the time
CARD_HELPERS = 2
#: the queries that took the card longest in 13a, 11b and 13b (on an
#: H100): handed out first, so that no runner is left with
#: one of them while the others wait
SLOW_QUERIES = ("q64", "q4", "q72", "q74", "q11", "q49", "q67", "q14",
                "q80", "q14b", "q75", "q66", "q78", "q57", "q56", "q88",
                "q5", "q60", "q76", "q47", "q85")
#: a CPU worker process's tables, made once by cpu_worker_init
_WORKER_TABLES: dict = {}
#: a card helper's tables, by make_tables spec (one spec at a time)
_HELPER_TABLES: dict = {}


def cpu_worker_init(spec: tuple) -> None:
    import torch
    torch.set_num_threads(2)
    _WORKER_TABLES.update(make_tables(spec))


def cpu_engine_result(wl_name: str, q: str) -> tuple:
    """In a CPU worker: query q of workload `wl_name` over the worker's
    tables on the port's CPU engine, 16 partitions: (result, the
    columns its final sort orders by, seconds)."""
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    wl = workload(wl_name)
    t0 = time.perf_counter()
    plan = wl.queries[q](wl.sources(_WORKER_TABLES, DB.SF10_PARTITIONS),
                         lambda p: p.collect())
    df = plan.collect()
    return df, ds_order_columns(plan), time.perf_counter() - t0


def card_helper_init(device: str) -> None:
    """A card helper's start: one torch thread (the main process and the
    CPU workers hold the host's other cores) and its device's context."""
    import torch
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.zeros(1, device=device)


def card_pool(dev, helpers: int = CARD_HELPERS):
    """`helpers` spawned processes on `dev`'s kind of device (the card),
    for spread; the caller shuts them down (`with card_pool(dev) as
    pool:`)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(helpers, multiprocessing.get_context("spawn"),
                               initializer=card_helper_init,
                               initargs=(dev.type,))


def helper_tables(spec: tuple) -> dict:
    """In a card helper: make_tables(spec), made on first use (the same
    frames the main process makes from the same spec)."""
    if spec not in _HELPER_TABLES:
        _HELPER_TABLES.clear()
        gc.collect()
        _HELPER_TABLES[spec] = make_tables(spec)
    return _HELPER_TABLES[spec]


def slow_first(queries) -> list:
    """`queries` with SLOW_QUERIES' first, in that order, then the rest
    in theirs."""
    rank = {q: i for i, q in enumerate(SLOW_QUERIES)}
    return sorted(queries, key=lambda q: rank.get(q, len(rank)))


def spread(queries, here, there, pool, done) -> None:
    """Runs each of `queries` once, in the order given, on the runner that
    frees first: this process (`here(q)` returns its result) or one of
    `pool`'s processes (one query at a time each; `there(q)` is the
    (function, *arguments) submitted); without a pool, all here.
    done(q, result, error), one of the two None, is called in this
    thread as results come, between this process's own queries; once it
    raises, the runners take no further query and the error is raised
    here when they have stopped."""
    import threading
    from collections import deque
    todo = deque(queries)
    lock = threading.Lock()
    ready: deque = deque()

    def take():
        with lock:
            return todo.popleft() if todo else None

    def feed() -> None:
        while (q := take()) is not None:
            try:
                ready.append((q, pool.submit(*there(q)).result(), None))
            except Exception as e:  # noqa: BLE001 -- handed to done
                ready.append((q, None, e))

    def drain() -> None:
        while ready:
            done(*ready.popleft())

    feeders = [] if pool is None else [
        threading.Thread(target=feed, name=f"card-helper-feed-{i}",
                         daemon=True) for i in range(pool._max_workers)]
    for t in feeders:
        t.start()
    try:
        while (q := take()) is not None:
            try:
                res, err = here(q), None
            except Exception as e:  # noqa: BLE001 -- handed to done
                res, err = None, e
            done(q, res, err)
            # a failed query's error holds its plan's frames, and with
            # them its device memory: not through the next query
            res = err = None
            drain()
        for t in feeders:
            t.join()
        drain()
    finally:
        with lock:
            todo.clear()
        for t in feeders:
            t.join()


def card_query(torch, dev, wl: Workload, tables: dict, q: str) -> tuple:
    """Query q of `wl` over `tables` as a user submits it on the card, 16
    partitions, under the TPC bench conf with test.enabled (a CPU node
    fails the plan): (result, each scalar subquery's collect seconds,
    seconds)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    conf = C.RapidsConf({**DB.BENCH_CONF, C.TEST_ENABLED.key: True})
    t0 = time.perf_counter()
    laps: list = []
    run = card_run(torch, dev, conf, laps)
    got = run(wl.queries[q](wl.sources(tables, DB.SF10_PARTITIONS), run))
    return got, laps[:-1], time.perf_counter() - t0


def helper_device(device: str):
    import torch
    return torch.device("cuda", 0) if device == "cuda" \
        else torch.device(device)


def helper_check(wl_name: str, spec: tuple, q: str, device: str) -> tuple:
    """In a card helper: card_query of q over helper_tables(spec)."""
    import torch
    return card_query(torch, helper_device(device), workload(wl_name),
                      helper_tables(spec), q)


def helper_ds(wl_name: str, spec: tuple, q: str, device: str) -> dict:
    """In a card helper: ds_query of q over helper_tables(spec), its
    widest kernel calls kept for the main process to time
    (run_queries)."""
    import torch

    from spark_rapids_tpu_torch.ops import grouped_window as GW
    from spark_rapids_tpu_torch.ops import kernels as K
    try:
        out = ds_query(q, helper_tables(spec), torch, helper_device(device),
                       GW, K, None, workload(wl_name))
        del out["frame"]
        return out
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def check_queries(torch, dev, wl: Workload, spec: tuple, queries,
                  label: str, pool=None) -> dict:
    """Each query of `queries` over make_tables(spec) as a user submits
    it on the card (card_query), against the CPU engine's result
    (check_ds_query), which CPU_WORKERS processes compute meanwhile; no
    result may be empty but q91's (the reference fixture allows it).
    Each scalar subquery that a query collects through `run` (q9's five)
    is a collect of its own on the card, timed apart.  With a `pool` of
    card helpers, the queries are spread over them and this process,
    the slow ones first."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    tables = make_tables(spec)
    out = {"rel": 0.0, "seconds": {}, "subqueries": {}}
    order = slow_first(queries) if pool is not None else list(queries)
    waiting: list = []
    with ProcessPoolExecutor(
            CPU_WORKERS, multiprocessing.get_context("spawn"),
            initializer=cpu_worker_init, initargs=(spec,)) as cpu_pool:
        cpu = {q: cpu_pool.submit(cpu_engine_result, wl.name, q)
               for q in order}

        def check(q: str, got, subqueries: list, card_s: float) -> None:
            want, order_cols, cpu_s = cpu[q].result()
            require(len(want) > 0 or (wl.name, q) == ("tpcds", "q91"),
                    f"{wl.name} {q}: the CPU engine's result is empty")
            rel = check_ds_query(f"{wl.name} {q}", want, got, order_cols)
            out["rel"] = max(out["rel"], rel)
            out["seconds"][q] = {"cpu": cpu_s, "card": card_s}
            subs = ""
            if subqueries:
                out["subqueries"][q] = subqueries
                subs = (f"; {len(subqueries)} scalar subqueries, each a "
                        f"collect on the card: " + ", ".join(
                            f"{s:.3f}" for s in subqueries) + " s")
            print(f"{wl.name} {q} at {label}: {len(got)} rows equal to the "
                  f"CPU engine's (CPU {cpu_s:.2f} s, card {card_s:.2f} s), "
                  f"max rel err {rel:.3g}{subs}", flush=True)

        def done(q: str, res, err) -> None:
            # checked once the CPU engine has its result; the rest wait
            if err is not None:
                raise err
            waiting.append((q, res))
            for item in [w for w in waiting if cpu[w[0]].done()]:
                waiting.remove(item)
                check(item[0], *item[1])

        spread(order, lambda q: card_query(torch, dev, wl, tables, q),
               lambda q: (helper_check, wl.name, spec, q, dev.type), pool,
               done)
        for q, res in waiting:
            check(q, *res)
    return out


def kernel_state_bytes(GW, K) -> int:
    """Device bytes of the kernel wrappers' state that lives as long as
    the process, as the caching allocator counts them (blocks of 512
    bytes): window_group_sums' tile flags and scratch and grouped_sum's
    ticket and tier-A scratch (each grown to the widest launch, never
    freed), and grouped_sum's int32 row counts (one per device, stream
    and row count, at most 256, then cleared)."""
    tensors = [t for state in GW._TILE_STATE.values() for t in state[:2]]
    tensors += [t for state in K._GS_DEVICE.values() for t in state[2:]]
    tensors += list(K._ROW_COUNTS.values())
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for t in tensors)


def ds_query(q: str, tables: dict, torch, dev, GW, K, cases,
             wl: Optional[Workload] = None) -> dict:
    """The run of query q of `wl` (TPC-DS by default) over `tables` at
    16 partitions, one new plan, under the TPC bench conf with
    test.enabled (the result in out["frame"]): accelerate (with the upload and any scalar subquery's
    collect) and collect timed apart, plan runs, peak device memory,
    rows, aggregate and join lanes, the kernels' launches; every float
    of the result finite; the widest input batch of every WindowExec and
    ExpandExec held against its CPU node (the 18 of phase 11 must have
    one), and the widest call of each kernel against its twin (with
    `cases` from kernel_cases; without, a numpy copy of each call's
    inputs in out["window_call"] and out["grouped_call"], for
    call_cases), the subquery collects' calls and launches with the
    plan's.  Every device
    tensor the query made is dropped when it returns:
    torch.cuda.memory_allocated() must come back to its value before
    the query, but for the growth of the kernel wrappers' own state
    (kernel_state_bytes)."""
    from collections import Counter

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import expand as EX
    from spark_rapids_tpu_torch.exec import window as W
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    wl = wl or workload("tpcds")
    label = f"{wl.name} {q}"
    conf = C.RapidsConf({**DB.BENCH_CONF, C.TEST_ENABLED.key: True})
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    laps: list = []
    run = card_run(torch, dev, conf, laps)
    calls: list = []
    gcalls: list = []
    widest: dict = {}
    lanes: Counter = Counter()
    spied: Counter = Counter()
    torch.cuda.reset_peak_memory_stats(dev)
    # counted and recorded from the query function on, so that a scalar
    # subquery's collect (q9's five, in accelerate) is counted and checked
    GW.window_group_sums.launches = 0
    K.grouped_sum.launches = 0
    K.q1_fused.launches = 0
    AGG.window_group_sums = recording(calls, GW)
    AGG.grouped_sum = recording_grouped(gcalls, K)
    undo: list = []
    try:
        ts = time.perf_counter()
        plan = accelerate(wl.queries[q](
            wl.sources(tables, DB.SF10_PARTITIONS), run), conf, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        undo = [lane_spy(AGG, lanes), collect_spy(spied),
                widest_inputs(widest, EX, W)]
        df = collect(plan, conf)
    finally:
        for u in undo:
            u()
        AGG.window_group_sums = GW.window_group_sums
        AGG.grouped_sum = K.grouped_sum
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"window_group_sums": GW.window_group_sums.launches,
                "grouped_sum": K.grouped_sum.launches,
                "q1_fused": K.q1_fused.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    execs = list(walk(plan))
    names = [type(e).__name__ for e in execs]
    join_lanes = Counter(getattr(e, "lane", None) for e in execs
                         if type(e).__name__ == "HashJoinExec")
    del plan, execs
    if wl.name == "tpcds" and q in DS_SLICE:
        require(any(x in names for x in ("WindowExec", "ExpandExec")),
                f"{q}: no WindowExec or ExpandExec in {names}")
        require(widest, f"{q}: no ExpandExec or WindowExec ran")
    floats = [c for c in df.columns
              if str(df[c].dtype).lower().startswith("float")]
    require(all(np.isfinite(df[c].dropna().to_numpy(np.float64)).all()
                for c in floats), f"{label}: a non-finite value")
    require(launches["q1_fused"] == 0,
            f"{label}: q1_fused launched: no call of it is checked")
    agg_lanes = {f"{m}={d}": c for (m, d), c in sorted(lanes.items())}
    subs = (f" and {len(laps)} scalar subqueries' collects, "
            + ", ".join(f"{s:.3f}" for s in laps) + " s") if laps else ""
    fact = "store_sales" if "store_sales" in tables else "perf"
    print(f"{label} ({len(tables[fact])} {fact} rows): accelerate {t1 - ts:.3f} s (with "
          f"the upload{subs}), collect {t2 - t1:.3f} s (plan runs "
          f"{spied['executions']}), {len(df)} rows, peak device memory "
          f"{peak:.2f} GiB, launches {launches}, aggregate lanes "
          f"{agg_lanes}, join lanes {dict(join_lanes)}", flush=True)
    out = {"frame": df, "launches": launches, "peak_gb": peak,
           "rows": len(df),
           "seconds": {"accelerate": t1 - ts, "collect": t2 - t1,
                       "subqueries": laps},
           "plan_runs": spied["executions"], "join_lanes": dict(join_lanes)}
    # a comprehension, so no loop variable keeps an exec (and through its
    # children the plan's uploaded tables) alive until the memory check
    out["execs"] = [check_exec_batch(ex, batch, W)
                    for ex, batch in widest.values()]
    widest.clear()
    for res in out["execs"]:
        print(f"{label} {res['exec']}: widest input {res['rows']} rows "
              f"-> {res['out_rows']}, equal to the CPU node (worst window "
              f"sum at {res['worst_sum_share_of_bound']:.3g} of its bound; "
              f"download {res['download_s']:.2f} s, CPU {res['cpu_s']:.2f} "
              f"s)", flush=True)
    require(bool(calls) == bool(launches["window_group_sums"]),
            f"{label}: window_group_sums launched but no call recorded")
    require(bool(gcalls) == bool(launches["grouped_sum"]),
            f"{label}: grouped_sum launched but no call recorded")
    if cases is not None:
        call_cases(torch, dev, out, label, q, cases, calls, gcalls)
    else:
        # held against the twins and timed later, where this process is
        # not on the card (run_queries)
        if calls:
            out["window_call"] = (calls[0].cpu().numpy(), [
                v.cpu().numpy() for v in calls[1]], calls[2])
        if gcalls:
            out["grouped_call"] = (gcalls[0].cpu().numpy(), [
                v.cpu().numpy() for v in gcalls[1]], gcalls[2], gcalls[3])
    del calls, gcalls
    gc.collect()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    grown = kernel_state_bytes(GW, K) - state0
    out["memory_allocated"] = {"before": before, "after": after,
                               "kernel_state_growth": grown}
    print(f"{label}: memory_allocated {before} bytes before, {after} "
          f"after the plan was dropped (the kernel wrappers' own state "
          f"grew {grown})", flush=True)
    require(after - before == grown,
            f"{label}: {after - before - grown} bytes of device memory "
            f"kept after its plan was dropped")
    return out


def call_cases(torch, dev, out: dict, label: str, q: str, cases, wcall,
               gcall) -> None:
    """The widest call of each kernel in a ds_query run held against its
    twin and timed (kernel_cases `cases`), into out["window_case"] and
    out["grouped_case"]: `wcall` [gid, vals, out_cap] and `gcall` [keys,
    vals, num_rows, n_groups], as device tensors or as numpy copies."""
    grouped_case, window_case = cases

    def on_card(x):
        return x if isinstance(x, torch.Tensor) \
            else torch.from_numpy(x).to(dev)

    if wcall:
        gid, vals, cap = on_card(wcall[0]), [on_card(v) for v in wcall[1]], \
            wcall[2]
        case = window_case(gid, vals, cap)
        case.update(query=q, launches=out["launches"]["window_group_sums"],
                    shape=f"{label} widest call: capacity {gid.numel()}, "
                    f"out_cap {cap}, M={len(vals)}")
        print(kernel_text("window_group_sums", case), flush=True)
        out["window_case"] = case
        del gid, vals
    if gcall:
        keys, vals, rows, groups = on_card(gcall[0]), [
            on_card(v) for v in gcall[1]], gcall[2], gcall[3]
        case = grouped_case(keys, vals, rows, groups, None)
        case.update(query=q, launches=out["launches"]["grouped_sum"],
                    shape=f"{label} widest call: capacity {keys.numel()}, "
                    f"G={groups}, M={len(vals)}, tier {case['tier']}")
        print(kernel_text("grouped_sum", case), flush=True)
        out["grouped_case"] = case
        del keys, vals


def run_queries(torch, dev, wl: Workload, tables: dict, queries, GW, K,
                cases, failed: Optional[list] = None, pool=None,
                spec: Optional[tuple] = None) -> dict:
    """ds_query for each query of `queries` in turn, the caching
    allocator emptied after each.  With a `pool` of card helpers
    (card_pool), the queries are spread over them (over
    make_tables(spec), the same frames as `tables`) and this process,
    the slow ones first, and each query's widest kernel calls are held
    against their twins and timed here once all have run, with the card
    to this process.  With a `failed` list, a query that raises is
    named there with its error (its traceback printed) and the next one
    runs; without one, the first error ends the run."""
    import traceback
    out = {}

    def here(q: str) -> dict:
        try:
            res = ds_query(q, tables, torch, dev, GW, K,
                           None if pool is not None else cases, wl)
            del res["frame"]
            return res
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    def done(q: str, res, err) -> None:
        if err is None:
            out[q] = res
            return
        if failed is None:
            raise err
        traceback.print_exception(err)
        failed.append(f"{wl.name} {q}: {type(err).__name__}: {err}")
        print(f"{wl.name} {q} FAILED: {type(err).__name__}: {err}",
              flush=True)

    spread(slow_first(queries) if pool is not None else list(queries),
           here, lambda q: (helper_ds, wl.name, spec, q, dev.type), pool,
           done)
    if pool is not None:
        for q in [q for q in queries if q in out]:
            call_cases(torch, dev, out[q], f"{wl.name} {q}", q, cases,
                       out[q].pop("window_call", None),
                       out[q].pop("grouped_call", None))
    return {q: out[q] for q in queries if q in out}


def ds_phase(torch, dev, seed: int, GW, K, scale: Optional[int] = None,
             queries: Optional[list] = None,
             failed: Optional[list] = None,
             tables: Optional[dict] = None, pool=None,
             spec: Optional[tuple] = None) -> dict:
    """Phase 11b: the 18 queries of DS_SLICE (or `queries`, in
    query_order) over `tables`, or else `tpcds_bench.sf10_tables(seed,
    scale)` (SF10's 28,800,991 store_sales rows by default), 16
    partitions, one new plan each, with ds_query's measures and checks;
    with a `pool`, spread over it (run_queries; `spec` makes the same
    tables there)."""
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    cases = kernel_cases(torch, dev, GW, K)
    if tables is None:
        t0 = time.perf_counter()
        tables = DB.sf10_tables(seed, scale or DB.SF10_STORE_SALES)
        print("tpcds data: " + ", ".join(f"{k} {len(v)}" for k, v in
                                         tables.items())
              + f" rows, {time.perf_counter() - t0:.1f} s", flush=True)
    return run_queries(torch, dev, workload("tpcds"), tables,
                       sorted(queries or DS_SLICE, key=query_order), GW, K,
                       cases, failed, pool, spec)


def ds_rest() -> list:
    """The 85 TPC-DS queries of phase 13: all but DS_SLICE."""
    from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES
    return sorted(set(QUERIES) - set(DS_SLICE), key=query_order)


def ds_rest_cut() -> list:
    """13b's queries: every second one of the 85 in registration order
    (the docstring's cut 3; 13a checks all 85)."""
    from spark_rapids_tpu_torch.models.tpcds_queries import QUERIES
    rest = set(ds_rest())
    return sorted([q for q in QUERIES if q in rest][::2], key=query_order)


def workloads_check_phase(torch, dev, seed: int, pool=None) -> dict:
    """Phase 13a: all 103 TPC-DS queries (phase 11's 18 with them) and
    the 30 TPCx-BB queries over workload_tables(WL_CHECK_SEED, WL_CHECK_SCALE),
    Mortgage's two plans over WL_CHECK_LOANS x MORTGAGE_MONTHS from
    `seed`, on the card against the CPU engine (check_queries; with a
    `pool` of card helpers, spread over them and this process)."""
    from spark_rapids_tpu_torch.models import tpcxbb as X
    spec = ("workload", WL_CHECK_SEED, WL_CHECK_SCALE)
    label = f"{WL_CHECK_SCALE} store_sales rows"
    out = {"tpcds": check_queries(
        torch, dev, workload("tpcds"), spec,
        sorted(DS_SLICE + tuple(ds_rest()), key=query_order), label, pool)}
    require(len(out["tpcds"]["subqueries"].get("q9", ())) == 5,
            "q9's five scalar subqueries did not each collect on the card")
    out["tpcxbb"] = check_queries(torch, dev, workload("tpcxbb"), spec,
                                  sorted(X.QUERIES), label, pool)
    out["mortgage"] = check_queries(
        torch, dev, workload("mortgage"),
        ("mortgage", seed, WL_CHECK_LOANS, MORTGAGE_MONTHS),
        ("etl_plan", "summary_plan"),
        f"{WL_CHECK_LOANS} loans x {MORTGAGE_MONTHS} months", pool)
    return out


def workloads_scale_phase(torch, dev, seed: int, GW, K, scale: int,
                          loans: int, xbb_queries=None,
                          mortgage: bool = True,
                          failed: Optional[list] = None,
                          tables: Optional[dict] = None) -> dict:
    """Phase 13b: the 30 TPCx-BB queries (or `xbb_queries`) over
    `tables`, or else workload_tables(seed, scale), then Mortgage's two
    plans over `loans` x MORTGAGE_MONTHS, one new plan each, with
    ds_query's measures and checks (the 85 TPC-DS queries run by
    ds_phase before it)."""
    from spark_rapids_tpu_torch.models import tpcxbb as X
    cases = kernel_cases(torch, dev, GW, K)
    xbb_queries = sorted(X.QUERIES) if xbb_queries is None else xbb_queries
    out = {}
    if xbb_queries:
        if tables is None:
            t0 = time.perf_counter()
            tables = workload_tables(seed, scale)
            print("workload data: " + ", ".join(
                f"{k} {len(v)}" for k, v in tables.items())
                + f" rows, {time.perf_counter() - t0:.1f} s", flush=True)
        out["tpcxbb"] = run_queries(torch, dev, workload("tpcxbb"), tables,
                                    xbb_queries, GW, K, cases, failed)
        del tables
    if mortgage:
        t0 = time.perf_counter()
        mtg = mortgage_tables(seed, loans, MORTGAGE_MONTHS)
        print(f"mortgage data: perf {len(mtg['perf'])}, acq "
              f"{len(mtg['acq'])} rows, {time.perf_counter() - t0:.1f} s",
              flush=True)
        out["mortgage"] = run_queries(
            torch, dev, workload("mortgage"), mtg,
            ("etl_plan", "summary_plan"), GW, K, cases, failed)
    return out


# -- phase 14: the I/O layer and the planner's missing nodes ----------------
#: phase 14's files, in a git-ignored directory of the checkout that the
#: phase empties at its start and its end
IO_DIR = Path(__file__).resolve().parent / ".io_smoke"
#: the lineitem columns Q1 and Q6 read: what 14a writes
Q1_Q6_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
#: 14b's file formats: part as ORC, nation and region as CSV, the rest
#: as Parquet
IO_FORMATS = {"part": "orc", "nation": "csv", "region": "csv"}


def io_reset() -> None:
    import shutil
    shutil.rmtree(IO_DIR, ignore_errors=True)


def write_files(torch, dev, frame, schema, name: str, fmt: str, conf,
                partition_by=()) -> dict:
    """Write `frame` (16 partitions) as `fmt` files under IO_DIR/name
    through the port's writer on the card, write(CpuSource) ->
    TpuWriteFilesExec; returns the write's wall time, rows, files and
    bytes.  CSV, which the port reads but does not write, is written by
    pandas."""
    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.models.data_util import split_partitions
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    path = IO_DIR / name
    t0 = time.perf_counter()
    if fmt == "csv":
        path.mkdir(parents=True)
        frame.to_csv(path / "part-00000.csv", header=False, index=False)
        res = {"files": 1, "rows": len(frame),
               "bytes": (path / "part-00000.csv").stat().st_size}
    else:
        plan = accelerate(pio.write(
            N.CpuSource(split_partitions(frame, 16), schema), str(path),
            fmt, partition_by), conf, device=dev)
        require(type(plan).__name__ == "TpuWriteFilesExec",
                f"the {name} write is not on the card: {plan}")
        out = collect(plan, conf)
        res = {"files": int(out["num_files"][0]),
               "rows": int(out["num_rows"][0]),
               "bytes": int(out["num_bytes"][0])}
        del plan
        require(res["rows"] == len(frame),
                f"{name}: {res['rows']} rows written of {len(frame)}")
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    print(f"io write {name} as {fmt}"
          + (f" by {list(partition_by)}" if partition_by else "")
          + f": {res['seconds']:.3f} s, {res['rows']} rows, {res['files']} "
          f"files, {res['bytes']} bytes", flush=True)
    return res


def file_sources(names, schemas) -> dict:
    """Plan leaves reading IO_DIR's tables in their formats."""
    from spark_rapids_tpu_torch import io as pio
    out = {}
    for name in names:
        fmt = IO_FORMATS.get(name, "parquet")
        path = str(IO_DIR / name)
        out[name] = (pio.read_csv(path, schemas[name]) if fmt == "csv"
                     else pio.read_orc(path) if fmt == "orc"
                     else pio.read_parquet(path))
    return out


def io_query(torch, dev, label: str, cpu_plan, conf, check, GW, K,
             tree_check=None) -> dict:
    """One plan of phase 14 on the card through run_plan: accelerate and
    collect timed apart, the result held by `check(df) -> rel err`, the
    exec tree by `tree_check(plan, names)`, and each file scan's host
    decode and upload time, upload bytes and row groups (stripes) read
    against its splits' total."""
    from spark_rapids_tpu_torch.io.exec import TpuFileSourceScanExec
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    from spark_rapids_tpu_torch.utils import metrics as M
    df, plan, info = run_plan(
        torch, dev, GW, K, lambda: accelerate(cpu_plan, conf, device=dev),
        lambda plan: collect(plan, conf))
    names = [name for name, _ in tree(plan)]
    if tree_check is not None:
        tree_check(plan, names)
    scans = []
    for n in walk(plan):
        if isinstance(n, TpuFileSourceScanExec):
            counts = n.scan.reader.counts
            scans.append({
                "format": n.scan.file_format,
                "path": Path(n.scan.path).name,
                "columns": len(n.scan.output_schema),
                "partitions": len(n.scan.partitions),
                "pushed": n.pushed_filter is not None,
                "rows": int(n.metrics.value(M.NUM_OUTPUT_ROWS)),
                "batches": int(n.metrics.value(M.NUM_OUTPUT_BATCHES)),
                "decode_s": n.metrics.value(M.BUFFER_TIME) / 1e9,
                "upload_s": n.metrics.value(M.DECODE_TIME) / 1e9,
                "upload_bytes": int(n.metrics.value(M.UPLOAD_BYTES)),
                "chunks": (None if counts is None
                           else [counts.read, counts.total])})
    del plan
    rel = check(df)
    info.update(label=label, rows=len(df), rel=rel, scans=scans, tree=names,
                peak_gib=info["peak"] / 2**30)
    print(f"io {label}: accelerate {info['accelerate_s']:.3f} s, collect "
          f"{info['collect_s']:.3f} s (plan runs {info['runs']}), "
          f"rel err {rel:.3g}, {len(df)} rows, peak "
          f"{info['peak_gib']:.2f} GiB, launches {info['launches']}, "
          f"scans {scans}", flush=True)
    return info


def sort_merge_joins(node):
    """`node` with every CpuHashJoin made a CpuSortMergeJoin over local
    CpuSorts of its inputs by the join keys (the plan Spark makes past
    the broadcast threshold)."""
    from spark_rapids_tpu_torch.exec.sort import asc
    from spark_rapids_tpu_torch.plan import nodes as N
    import copy
    kids = [sort_merge_joins(c) for c in node.children]
    if type(node) is N.CpuHashJoin:
        return N.CpuSortMergeJoin(
            node.join_type, node.left_keys, node.right_keys,
            N.CpuSort([asc(k) for k in node.left_keys], kids[0],
                      global_sort=False),
            N.CpuSort([asc(k) for k in node.right_keys], kids[1],
                      global_sort=False), node.condition)
    out = copy.copy(node)
    out.children = kids
    return out


def io_scan_phase(torch, dev, planner: dict, GW, K) -> dict:
    """Phase 14a: Q1 and Q6 at SF10 over Parquet (see the module
    docstring)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    io_reset()
    frame = planner["frame"][list(Q1_Q6_COLUMNS)]
    schema = T.Schema(tuple(TD.SCHEMAS["lineitem"].field(c)
                            for c in Q1_Q6_COLUMNS))
    out = {"write": write_files(torch, dev, frame, schema, "lineitem",
                                "parquet", conf, ("l_returnflag",
                                                  "l_linestatus")),
           "queries": {}}
    del frame

    def scan_tree(plan, names):
        require(names[-1] == "TpuFileSourceScanExec"
                and "LocalBatchSource" not in names,
                f"the plan does not read the files: {names}")

    for q, check in ((1, lambda df: check_q1(df, planner["q1_gold"],
                                             "parquet Q1")),
                     (6, lambda df: check_q6(df, planner["q6_gold"],
                                             "parquet Q6"))):
        src = file_sources(["lineitem"], TD.SCHEMAS)
        out["queries"][f"q{q}"] = io_query(
            torch, dev, f"14a q{q} SF10 parquet", QUERIES[q](src, None),
            conf, check, GW, K, scan_tree)
        mem = planner["seconds"][f"q{q}_cold"]
        print(f"io 14a q{q}: over CpuSource (phase 6, cold) accelerate "
              f"{mem['accelerate']:.3f} s (with the upload), collect "
              f"{mem['collect']:.3f} s", flush=True)
    require(out["queries"]["q1"]["launches"]["window_group_sums"] >= 1,
            "window_group_sums never launched in Q1 over parquet")
    io_reset()
    return out


def io_files_phase(torch, dev, tables: dict, gold: dict, gold_parts: dict,
                   GW, K) -> dict:
    """Phase 14b: Q3, Q5 and Q9 over the SF1 tables written as files."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    out = {"write": write_tpch_files(torch, dev, tables), "queries": {}}

    def file_tree(plan, names):
        require("LocalBatchSource" not in names
                and "TpuFileSourceScanExec" in names,
                f"the plan does not read the files: {names}")

    for q, check in ((3, lambda df: check_join_query(3, df, gold[3])),
                     (5, lambda df: check_join_query(5, df, gold[5])),
                     (9, lambda df: check_part_query(9, df,
                                                     gold_parts[9]))):
        src = file_sources(tables, TD.SCHEMAS)
        out["queries"][f"q{q}"] = io_query(
            torch, dev, f"14b q{q} {sf_of(tables)} files",
            QUERIES[q](src, None), conf, check, GW, K, file_tree)
    formats = {s["format"] for q in ("q5", "q9")
               for s in out["queries"][q]["scans"]}
    require(formats == {"parquet", "orc", "csv"},
            f"14b read the formats {formats}")
    return out  # the files stay for phase 15


def write_tpch_files(torch, dev, tables: dict) -> dict:
    """The eight TPC-H tables of `tables` written into an empty IO_DIR in
    their IO_FORMATS (write_files): what 14b and phase 15 read."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    io_reset()
    return {name: write_files(torch, dev, tables[name], TD.SCHEMAS[name],
                              name, IO_FORMATS.get(name, "parquet"), conf)
            for name in TD.SCHEMAS}


def plan_gaps_phase(torch, dev, tables: dict, gold: dict, q1_gold: dict,
                    GW, K) -> dict:
    """Phase 14c: the planner's sort-merge join, repartition, cached
    columnar scan and sort aggregate over the SF1 tables in memory."""
    import pyarrow as pa

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import ExecutionPlanCapture
    n = TB.SF10_PARTITIONS
    conf = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True})
    out = {}

    def q3_tree(plan, names):
        require(names == JOIN_TREES[3],
                f"sort-merge Q3 exec tree: {tree(plan)}")
        exchanges = {d for name, d in tree(plan)
                     if name == "ShuffleExchangeExec"}
        require(exchanges == {
            f"ShuffleExchangeExec(HashPartitioning, n={n})"},
            f"sort-merge Q3 exchanges: {exchanges}")

    out["q3_smj"] = io_query(
        torch, dev, f"14c q3 sort-merge joins {sf_of(tables)}",
        sort_merge_joins(QUERIES[3](TD.sources(tables, n), None)), conf,
        lambda df: check_join_query(3, df, gold[3]), GW, K, q3_tree)
    off = C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                        C.TEST_ALLOWED_NONGPU.key: "CpuSortMergeJoin",
                        C.REPLACE_SORT_MERGE_JOIN.key: False})
    def fell_back(plan, names):
        ExecutionPlanCapture.assert_did_fall_back("CpuSortMergeJoin")

    out["q3_smj_off"] = io_query(
        torch, dev, f"14c q3 sort-merge joins, replacement off "
        f"{sf_of(tables)}",
        sort_merge_joins(QUERIES[3](TD.sources(tables, n), None)), off,
        lambda df: check_join_query(3, df, gold[3]), GW, K, fell_back)

    def q1_over(leaf, label, tree_check=None, sort_agg=False):
        plan = QUERIES[1]({"lineitem": leaf}, None)
        if sort_agg:
            agg = plan.children[0]
            plan.children[0] = N.CpuSortAggregate(
                agg.group_exprs, agg.aggregates, agg.child)
        return io_query(torch, dev, f"14c q1 {label} {sf_of(tables)}",
                        plan, conf, lambda df: check_q1(
                            df, q1_gold, f"Q1 {label}"), GW, K, tree_check)

    src = TD.sources(tables, n)["lineitem"]
    out["q1_roundrobin"] = q1_over(N.CpuShuffleExchange(
        N.PartitioningSpec("roundrobin", n), src), "over roundrobin(16)",
        lambda plan, names: require(
            f"ShuffleExchangeExec(RoundRobinPartitioning, n={n})"
            in [d for _, d in tree(plan)], f"no round-robin: {names}"))
    t0 = time.perf_counter()
    cached = N.CpuCachedColumnar(
        [pa.Table.from_pandas(p, preserve_index=False)
         for p in src.partitions], src.output_schema())
    print(f"io 14c: lineitem as {len(cached.partitions)} Arrow tables in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out["q1_cached"] = q1_over(
        cached, "over the cached columnar", lambda plan, names: require(
            "HostColumnarToDeviceExec" in names
            and "RowToColumnarExec" not in names,
            f"the cached Q1's tree: {names}"))
    del cached
    out["q1_sort_agg"] = q1_over(
        src, "sort aggregate", lambda plan, names: require(
            names.count("HashAggregateExec") == 2,
            f"the sort aggregate's tree: {names}"), sort_agg=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the runtime (pipeline, scheduler, watchdog, AQE)
#: TPC-H's power-test order (spec 5.3.5.4, Appendix A's stream 0)
POWER_ORDER = (14, 2, 9, 20, 6, 17, 18, 8, 21, 13, 3, 22, 16, 4, 11, 15,
               1, 10, 19, 5, 7, 12)


def stream_orders(streams: int) -> list:
    """Each throughput stream's query order: the power order rotated by
    an equal share of the 22 for each stream (11 for two streams), so
    the streams seldom run one query at once."""
    n = len(POWER_ORDER)
    return [POWER_ORDER[(n * i) // streams:] + POWER_ORDER[:(n * i) // streams]
            for i in range(streams)]


def check_tpch(q: int, df, gold: dict, sub: list) -> float:
    """Query q's result against its float64 golden with phases 6-9's
    checks (gold[1] Q1's and gold[6] Q6's at the same scale)."""
    if q == 1:
        return check_q1(df, gold[1], "q1")
    if q == 6:
        return check_q6(df, gold[6], "q6")
    if q in (3, 4, 5):
        return check_join_query(q, df, gold[q])
    if q in (7, 8, 9, 10):
        return check_part_query(q, df, gold[q])
    return check_rest_query(q, df, gold[q], sub)


def tpch_conf(q: int, **extra):
    """The TPC bench conf with test.enabled (Q21 allows its two
    CpuHashJoin islands) and the runtime's defaults, plus `extra`."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    islands = ({C.TEST_ALLOWED_NONGPU.key: "CpuHashJoin"} if q == 21
               else {})
    return C.RapidsConf({**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                         **islands, **extra})


def submit_tpch(torch, dev, q: int, tables: dict, conf, label: str,
                source=None, keep: Optional[list] = None) -> tuple:
    """One TPC-H query as a user submits it: its plan built over the
    tables at 16 partitions (each scalar subquery a collect of its own
    on the card), accelerated and collected; the plan goes to `keep` if
    given (ExecutionPlanCapture holds it weakly).  Returns (frame,
    subquery frames, {accelerate, collect, subqueries} seconds)."""
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    sub: list = []

    def run_sub(plan):
        df = collect(accelerate(plan, conf, device=dev), conf)
        sub.append(df)
        return df
    ts = time.perf_counter()
    cpu_plan = QUERIES[q](source if source is not None
                          else TD.sources(tables, TB.SF10_PARTITIONS),
                          run_sub)
    t0 = time.perf_counter()
    plan = accelerate(cpu_plan, conf, device=dev)
    if keep is not None:
        keep.append(plan)
    t1 = time.perf_counter()
    df = collect(plan, conf)
    t2 = time.perf_counter()
    return df, sub, {"subqueries": t0 - ts, "accelerate": t1 - t0,
                     "collect": t2 - t1}


def threadsafe_recorders(GW, K, lock):
    """Stand-ins for the aggregate's two kernel wrappers that keep the
    inputs of the widest CUDA call made from any thread (as `recording`
    and `recording_grouped` do on one): ([gid, vals, out_cap],
    [keys, vals, num_rows, n_groups], window stand-in, grouped
    stand-in)."""
    wcalls: list = []
    gcalls: list = []

    def window(gid, vals, *, out_cap: int, capacity: int):
        if gid.is_cuda:
            with lock:
                if not wcalls or capacity > wcalls[0].numel():
                    wcalls[:] = [gid.clone(), [v.clone() for v in vals],
                                 out_cap]
        return GW.window_group_sums(gid, vals, out_cap=out_cap,
                                    capacity=capacity)

    def grouped(keys, vals, num_rows, *, n_groups: int, capacity: int):
        if keys.is_cuda:
            with lock:
                if not gcalls or capacity > gcalls[0].numel():
                    gcalls[:] = [keys.clone(), [v.clone() for v in vals],
                                 int(num_rows), n_groups]
        return K.grouped_sum(keys, vals, num_rows, n_groups=n_groups,
                             capacity=capacity)
    return wcalls, gcalls, window, grouped


def launch_counts(GW, K) -> dict:
    return {"grouped_sum": K.grouped_sum.launches,
            "window_group_sums": GW.window_group_sums.launches,
            "q1_fused": K.q1_fused.launches}


def reset_launches(GW, K) -> None:
    K.grouped_sum.launches = 0
    GW.window_group_sums.launches = 0
    K.q1_fused.launches = 0


def settled_memory(torch, dev, GW, K, before: int, state0: int,
                   label: str) -> dict:
    """torch.cuda.memory_allocated() once every producer has ended and
    the collector has run, required back at `before` but for the growth
    of the kernel wrappers' own state since `state0`."""
    from spark_rapids_tpu_torch.exec import pipeline as PL
    deadline = time.monotonic() + 20.0
    while PL.pipeline_live()["producers"] and time.monotonic() < deadline:
        time.sleep(0.05)
    require(PL.pipeline_live()["producers"] == 0,
            f"{label}: prefetch producers outlived their queries: "
            f"{PL.pipeline_live()}")
    gc.collect()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    grown = kernel_state_bytes(GW, K) - state0
    print(f"{label}: memory_allocated {before} bytes before, {after} "
          f"after (the kernel wrappers' own state grew {grown})",
          flush=True)
    require(after - before == grown,
            f"{label}: {after - before - grown} bytes of device memory "
            f"kept after its queries ended")
    return {"before": before, "after": after, "kernel_state_growth": grown}


def throughput_test(torch, dev, tables: dict, gold: dict, streams: int,
                    GW, K, queries=None, extra=None, orders=None) -> dict:
    """The TPC-H throughput test (spec 5.3.4): `streams` threads, each
    submitting its order of the 22 queries (of `queries`, or its list in
    `orders`) one new plan at a time over `tables` as IO_DIR's files
    (write_tpch_files), so that every scan prefetches, under the TPC
    bench conf with test.enabled and the runtime's defaults (pipeline,
    scheduler and watchdog on) and `extra`; every result held against
    its golden (`gold`, check_tpch) unless `gold` is None.  Returns each
    query's seconds and error, each stream's wall and the streams' wall
    together."""
    import threading

    from spark_rapids_tpu_torch.models import tpch_data as TD
    if orders is None:
        orders = [[q for q in o if queries is None or q in queries]
                  for o in stream_orders(streams)]
    out: dict = {"queries": {}, "stream_wall": {}, "errors": []}
    lock = threading.Lock()
    start = threading.Barrier(streams, timeout=60)

    def stream(i: int) -> None:
        try:
            start.wait()
        except BaseException as e:  # noqa: BLE001 — raised below
            with lock:
                out["errors"].append(f"stream {i}: {e!r}")
            return
        t_stream = time.perf_counter()
        for q in orders[i]:
            # a failed query is named and its stream goes on
            try:
                df, sub, sec = submit_tpch(
                    torch, dev, q, tables, tpch_conf(q, **(extra or {})),
                    f"s{i} q{q}", source=file_sources(TD.SCHEMAS,
                                                      TD.SCHEMAS))
                rel = (check_tpch(q, df, gold, sub) if gold is not None
                       else float("nan"))
            except BaseException as e:  # noqa: BLE001 — raised below
                with lock:
                    out["errors"].append(f"stream {i} q{q}: {e!r}")
                print(f"runtime stream {i} q{q} {sf_of(tables)} FAILED: "
                      f"{e!r}", flush=True)
                continue
            with lock:
                out["queries"][f"s{i}q{q}"] = {**sec, "rel": rel,
                                               "rows": len(df)}
            print(f"runtime stream {i} q{q} {sf_of(tables)}: "
                  f"accelerate {sec['accelerate']:.3f} s, collect "
                  f"{sec['collect']:.3f} s"
                  + (f", subqueries {sec['subqueries']:.3f} s"
                     if sub else "")
                  + f", {len(df)} rows, rel err {rel:.3g}", flush=True)
            del df, sub
        with lock:
            out["stream_wall"][i] = time.perf_counter() - t_stream

    t0 = time.perf_counter()
    threads = [threading.Thread(target=stream, args=(i,),
                                name=f"tpch-stream-{i}")
               for i in range(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(3000)
    require(not any(t.is_alive() for t in threads),
            "a throughput stream never ended")
    out["wall"] = time.perf_counter() - t0
    require(not out["errors"], f"throughput test: {out['errors']}")
    out["orders"] = orders
    return out


def gated(plan, gate, entered):
    """`plan` under a root exec that parks on the event `gate` (setting
    `entered`) before passing its batches on: it holds its query admitted
    until the gate opens."""
    from spark_rapids_tpu_torch.exec.base import UnaryExecBase
    from spark_rapids_tpu_torch.utils import watchdog as W

    class GateExec(UnaryExecBase):
        def output_schema(self):
            return self.child.output_schema()

        def process_partition(self, batches):
            entered.set()
            while not gate.wait(0.05):
                W.check_cancelled()
            yield from batches
    return GateExec(plan)


#: 15d's spark.sql.autoBroadcastJoinThreshold: at SF1 Q3's smallest
#: build side is ~47 MB of device batches (Q5's and Q10's have builds
#: under Spark's 10 MB default)
AQE_BROADCAST_BYTES = 64 << 20
#: 15a's cut (see the docstring's Cuts): two streams run the two halves
#: of the power order at once, 11 queries each
HALF_STREAMS = [list(POWER_ORDER[:11]), list(POWER_ORDER[11:])]


def runtime_phase(torch, dev, tables: dict, gold: dict, GW, K, cases,
                  single_collect_s: float, streams: int = 2,
                  orders=None) -> dict:
    """Phase 15 (see the module docstring): 15a the TPC-H throughput
    test (`streams` streams, or the lists of `orders`), 15b admission
    and the result cache, 15c the watchdog, 15d AQE, 15e the kernel
    wrappers under threads.  Returns each part's launches and
    figures."""
    import threading

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import pipeline as PL
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan import aqe
    from spark_rapids_tpu_torch.plan.overrides import (ExecutionPlanCapture,
                                                       accelerate, collect)
    from spark_rapids_tpu_torch.utils import watchdog as W
    grouped_case, window_case = cases
    sched = S.QueryScheduler.get()
    out: dict = {"launches": {}}
    laps: dict = {}

    def part_done(name: str, t0: float) -> None:
        laps[name] = time.perf_counter() - t0
        print(f"phase {name}: {laps[name]:.1f} s", flush=True)

    # 15a. the throughput test
    t_part = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    reset_launches(GW, K)
    sched.reset_stats()
    PL.reset_pipeline_stats()
    lock = threading.Lock()
    wcalls, gcalls, AGG.window_group_sums, AGG.grouped_sum = \
        threadsafe_recorders(GW, K, lock)
    try:
        if orders is not None:
            streams = len(orders)
        tput = throughput_test(torch, dev, tables, gold, streams, GW, K,
                               orders=orders)
    finally:
        AGG.window_group_sums = GW.window_group_sums
        AGG.grouped_sum = K.grouped_sum
    out["launches"]["15a"] = launches = launch_counts(GW, K)
    sstats, pstats = sched.stats(), PL.pipeline_stats()
    collects = sum(v["collect"] for v in tput["queries"].values())
    print(f"runtime 15a: {streams} streams of {len(tput['orders'][0])} "
          f"queries, {sf_of(tables)}: stream walls "
          + ", ".join(f"{w:.1f}" for _, w in sorted(
              tput["stream_wall"].items()))
          + f" s, together {tput['wall']:.1f} s (the streams' collects "
          f"{collects:.1f} s; phases 7-9's single-stream collects "
          f"{single_collect_s:.1f} s); scheduler admitted "
          f"{sstats['admitted']}, queued {sstats['queued']}, most "
          f"concurrent {sstats['max_admitted']}; pipeline producers "
          f"{pstats['producers']}, most batches in flight "
          f"{pstats['max_in_flight']}; launches {launches}", flush=True)
    require(launches["q1_fused"] == 0,
            "q1_fused launched in the throughput test: no call is checked")
    require(launches["window_group_sums"] and launches["grouped_sum"],
            f"a kernel of the path never launched in 15a: {launches}")
    require(pstats["producers"] > 0,
            "no file scan's prefetch producer ran in 15a")
    require(sstats["max_admitted"] >= min(2, streams),
            f"the streams never ran at once: {sstats}")
    require(bool(wcalls) and bool(gcalls),
            "15a: a kernel launched but no call of it was recorded")
    cases_a = {}
    gid, vals, cap = wcalls
    case = window_case(gid, vals, cap)
    case.update(launches=launches["window_group_sums"],
                shape=f"15a widest call: capacity {gid.numel()}, out_cap "
                f"{cap}, M={len(vals)}")
    print(kernel_text("window_group_sums", case), flush=True)
    cases_a["window_group_sums"] = case
    keys, gvals, rows, groups = gcalls
    case = grouped_case(keys, gvals, rows, groups, None)
    case.update(launches=launches["grouped_sum"],
                shape=f"15a widest call: capacity {keys.numel()}, "
                f"G={groups}, M={len(gvals)}, tier {case['tier']}")
    print(kernel_text("grouped_sum", case), flush=True)
    cases_a["grouped_sum"] = case
    del gid, vals, keys, gvals, wcalls[:], gcalls[:]
    out["15a"] = {"stream_wall": tput["stream_wall"], "wall": tput["wall"],
                  "collects": collects, "single_collect_s": single_collect_s,
                  "scheduler": sstats, "pipeline": pstats,
                  "queries": tput["queries"], "cases": cases_a,
                  "memory": settled_memory(torch, dev, GW, K, before,
                                           state0, "runtime 15a")}
    part_done("15a (TPC-H throughput test)", t_part)

    # 15b. admission: three Q6 at 45% of the budget each, all under a
    # gate at their root: two are admitted and park there, the third
    # queues, and the gate opens once the scheduler counts it queued
    t_part = time.perf_counter()
    reset_launches(GW, K)
    dm = DeviceManager.peek()
    require(dm is not None, "no DeviceManager after 15a")
    budget = int(0.45 * dm.budget)
    conf6 = tpch_conf(6, **{C.SCHED_QUERY_BUDGET.key: budget})
    sched.reset_stats()
    results: dict = {}
    errors: list = []
    gate = threading.Event()
    entered = [threading.Event() for _ in range(3)]

    def gated_q6(i: int, held: dict, conf) -> None:
        try:
            plan = accelerate(QUERIES[6](TD.sources(
                tables, TB.SF10_PARTITIONS), None), conf, device=dev)
            t0 = time.perf_counter()
            held[i] = (collect(gated(plan, gate, entered[i]), conf),
                       time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(f"q6 #{i}: {e!r}")

    ts = [threading.Thread(target=gated_q6, args=(i, results, conf6))
          for i in range(3)]
    for t in ts:
        t.start()
    try:
        deadline = time.monotonic() + 120
        while (sched.stats()["queued"] < 1 and not errors
               and time.monotonic() < deadline):
            time.sleep(0.05)
        require(not errors and sched.stats()["queued"] >= 1
                and len(dm.admissions()) == 2,
                f"15b: three Q6 did not queue one: {sched.stats()}, "
                f"{dm.admissions()}, {errors}")
    finally:
        gate.set()
        for t in ts:
            t.join(600)
    require(not errors and len(results) == 3, f"15b: {errors}")
    for df, _ in results.values():
        check_tpch(6, df, gold, [])
    s6 = sched.stats()
    print(f"runtime 15b: three Q6 at queryBudgetBytes {budget} (45% of "
          f"{dm.budget}), held at a gate until one queued: collects "
          + ", ".join(f"{r[1]:.3f}" for _, r in sorted(results.items()))
          + f" s, scheduler {s6}", flush=True)
    require(s6["queued"] >= 1 and s6["rejected"] == 0
            and s6["longest_queue_wait_ms"] > 0
            and s6["max_admitted"] == 2,
            f"15b: admission did not queue the third Q6: {s6}")
    results.clear()
    # with queueDepth 0, a third query while two are admitted is shed:
    # two Q6 at the same budget held admitted by the gate again
    gate.clear()
    entered = [threading.Event() for _ in range(2)]
    held: dict = {}
    hs = [threading.Thread(target=gated_q6, args=(i, held, conf6))
          for i in range(2)]
    for t in hs:
        t.start()
    try:
        require(all(e.wait(120) for e in entered) and not errors,
                f"15b: the two holders never ran: {errors}")
        require(len(dm.admissions()) == 2,
                f"15b: {dm.admissions()} admitted, expected 2")
        try:
            submit_tpch(torch, dev, 6, tables, tpch_conf(6, **{
                C.SCHED_QUERY_BUDGET.key: budget,
                C.SCHED_QUEUE_DEPTH.key: 0}), "q6 rejected")
            raise RuntimeError("15b: a third query was not rejected")
        except S.TpuQueryRejected as e:
            rejected = str(e)
    finally:
        gate.set()
        for t in hs:
            t.join(600)
    require(not errors and len(held) == 2, f"15b holders: {errors}")
    for df, _ in held.values():
        check_tpch(6, df, gold, [])
    print(f"runtime 15b: with queueDepth 0 and two admitted: "
          f"TpuQueryRejected: {rejected.splitlines()[0]}", flush=True)
    del held
    # the result cache: a second submit of Q1 over the same sources
    conf_rc = tpch_conf(1, **{C.RESULT_CACHE_ENABLED.key: True})
    S.result_cache().clear()
    src = TD.sources(tables, TB.SF10_PARTITIONS)
    df1, _, sec1 = submit_tpch(torch, dev, 1, tables, conf_rc, "q1 cache",
                               source=src)
    check_tpch(1, df1, gold, [])
    counts = launch_counts(GW, K)
    df2, _, sec2 = submit_tpch(torch, dev, 1, tables, conf_rc, "q1 cache",
                               source=src)
    rc = S.result_cache().stats()
    require(rc["hits"] == 1 and rc["stores"] == 1,
            f"15b: the second Q1 did not hit the result cache: {rc}")
    require(launch_counts(GW, K) == counts,
            "15b: a result-cache hit launched a kernel")
    import pandas as pd
    pd.testing.assert_frame_equal(df1, df2, check_exact=True)
    print(f"runtime 15b: Q1 twice with resultCache.enabled: collects "
          f"{sec1['collect']:.3f} s, then {sec2['collect']:.4f} s (a hit, "
          f"equal to the bit, no launch), cache {rc}", flush=True)
    S.result_cache().clear()
    del df1, df2, src
    out["launches"]["15b"] = launch_counts(GW, K)
    out["15b"] = {"scheduler": s6, "budget": budget,
                  "rejected": rejected.splitlines()[0], "result_cache": rc}
    part_done("15b (admission and the result cache)", t_part)

    # 15c. the watchdog: a hung producer cancels Q1, which then runs clean
    t_part = time.perf_counter()
    reset_launches(GW, K)
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    W.reset_hang_injection()
    conf_hang = tpch_conf(1, **{
        C.HANG_INJECT_SITE.key: "producer", C.HANG_INJECT_AFTER.key: 1,
        C.WATCHDOG_TASK_TIMEOUT.key: 5.0,
        C.WATCHDOG_POLL_INTERVAL.key: 0.5})
    t0 = time.perf_counter()
    try:
        # over the lineitem file: its scan's producer is the one that hangs
        submit_tpch(torch, dev, 1, tables, conf_hang, "q1 hang",
                    source=file_sources(["lineitem"], TD.SCHEMAS))
        raise RuntimeError("15c: the hung Q1 was not cancelled")
    except W.TpuQueryTimeout as e:
        timeout_msg = str(e)
    hang_s = time.perf_counter() - t0
    require(hang_s < 15.0, f"15c: the timeout took {hang_s:.1f} s")
    require("producer" in timeout_msg and "watchdog" in timeout_msg,
            f"15c: the timeout does not name the producer: "
            f"{timeout_msg[:300]}")
    W.reset_hang_injection()
    df, _, sec = submit_tpch(torch, dev, 1, tables, tpch_conf(1), "q1",
                             source=file_sources(["lineitem"], TD.SCHEMAS))
    check_tpch(1, df, gold, [])
    del df
    mem_c = settled_memory(torch, dev, GW, K, before, state0,
                           "runtime 15c")
    print(f"runtime 15c: Q1 over the lineitem file with its scan's "
          f"producer hung, cancelled after "
          f"{hang_s:.2f} s (taskTimeout 5 s): "
          f"{timeout_msg.splitlines()[0]}; then clean, collect "
          f"{sec['collect']:.3f} s, equal to the golden; live producers "
          f"{PL.pipeline_live()['producers']}", flush=True)
    out["launches"]["15c"] = launch_counts(GW, K)
    out["15c"] = {"cancel_s": hang_s, "memory": mem_c}
    part_done("15c (the watchdog)", t_part)

    # 15d. AQE: Q3, Q5, Q10 with spark.sql.adaptive.enabled
    t_part = time.perf_counter()
    reset_launches(GW, K)
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    out["15d"] = {}
    coalesced = False
    for q in (3, 5, 10):
        conf_aqe = tpch_conf(q, **{C.ADAPTIVE_ENABLED.key: True,
                                   C.AUTO_BROADCAST_THRESHOLD.key:
                                       AQE_BROADCAST_BYTES})
        held_plans: list = []
        df, _, sec = submit_tpch(torch, dev, q, tables, conf_aqe,
                                 f"q{q} aqe", keep=held_plans)
        final = ExecutionPlanCapture.last_plan
        require(final is not None, f"15d q{q}: no final plan captured")
        nodes = list(aqe_walk(final, aqe))
        names = [type(n).__name__ for n in nodes]
        stages = [n for n in nodes
                  if isinstance(n, aqe.ShuffleQueryStageExec)]
        require(stages, f"15d q{q}: no ShuffleQueryStageExec: {names}")
        require("BroadcastHashJoinExec" in names,
                f"15d q{q}: no join was demoted to a broadcast: {names}")
        require(all(s._buckets is None for s in stages),
                f"15d q{q}: a stage kept its batches after the collect")
        readers = names.count("CustomShuffleReaderExec")
        coalesced = coalesced or readers > 0
        rel = check_tpch(q, df, gold, [])
        out["15d"][q] = {**sec, "stages": len(stages),
                         "broadcast_joins":
                             names.count("BroadcastHashJoinExec"),
                         "coalesced_readers": readers, "rel": rel}
        print(f"runtime 15d q{q} with AQE: collect {sec['collect']:.3f} s, "
              f"{len(stages)} query stages, "
              f"{names.count('BroadcastHashJoinExec')} broadcast joins, "
              f"{readers} coalesced readers, rel err {rel:.3g}",
              flush=True)
        del df, final, nodes, stages, held_plans
    require(coalesced, "15d: no query coalesced its partitions")
    out["15d"]["memory"] = settled_memory(torch, dev, GW, K, before,
                                          state0, "runtime 15d")
    out["launches"]["15d"] = launch_counts(GW, K)
    part_done("15d (AQE)", t_part)

    # 15e. the wrappers under threads, at phase 3's shapes
    t_part = time.perf_counter()
    out["15e"] = wrappers_under_threads(torch, dev, GW, K)
    out["launches"]["15e"] = out["15e"]["launches"]
    part_done("15e (the kernel wrappers under four threads)", t_part)
    out["laps"] = laps
    return out


def aqe_walk(node, aqe):
    """Every node of an adaptive plan, through its stages' exchanges."""
    yield node
    kids = list(node.children)
    if isinstance(node, aqe.ShuffleQueryStageExec):
        kids.append(node.exchange)
    elif isinstance(node, aqe.CustomShuffleReaderExec):
        kids.append(node.stage)
    for c in kids:
        yield from aqe_walk(c, aqe)


def wrappers_under_threads(torch, dev, GW, K, threads: int = 4,
                           calls: int = 100) -> dict:
    """grouped_sum tiers A and B and window_group_sums at phase 3's shapes
    (2^23 rows and 14 measures at G = 26 and G = 300; 2^14 rows, 17
    measures, 6 groups), each called `calls` times by each of `threads`
    threads, interleaved: every result equal to the bit to the same call
    made alone, and the launch counters grown by exactly threads x calls
    x 3."""
    import threading

    from spark_rapids_tpu_torch.models import tpch_bench as TB
    g = torch.Generator(device=dev).manual_seed(15)
    rows = TB.BATCH_CAP
    vals = [torch.rand(rows, generator=g, device=dev) * 100
            for _ in range(14)]
    keys_a = torch.randint(0, 26, (rows,), generator=g, device=dev,
                           dtype=torch.int32)
    keys_b = torch.randint(0, 300, (rows,), generator=g, device=dev,
                           dtype=torch.int32)
    merge_cap = 1 << 14
    gid = torch.clamp(torch.arange(merge_cap, device=dev) // 8,
                      max=5).to(torch.int32)
    mvals = [torch.rand(merge_cap, generator=g, device=dev) * 1e6
             for _ in range(17)]
    calls_of = {
        "A": lambda: K.grouped_sum(keys_a, vals, rows, n_groups=26,
                                   capacity=rows),
        "B": lambda: K.grouped_sum(keys_b, vals, rows, n_groups=300,
                                   capacity=rows),
        "W": lambda: (GW.window_group_sums(gid, mvals, out_cap=50,
                                           capacity=merge_cap),)}
    alone = {}
    for name, fn in calls_of.items():
        alone[name] = fn()
        if name != "W":
            require(K.grouped_sum.last_tiers == [name],
                    f"15e: tier {K.grouped_sum.last_tiers}, expected "
                    f"{name}")
    torch.cuda.synchronize(dev)
    before = launch_counts(GW, K)
    errors: list = []
    barrier = threading.Barrier(threads, timeout=60)

    def worker(i: int) -> None:
        try:
            barrier.wait()
            order = ["A", "B", "W"][i % 3:] + ["A", "B", "W"][:i % 3]
            for _ in range(calls):
                for name in order:
                    got = calls_of[name]()
                    for x, y in zip(got, alone[name]):
                        if not torch.equal(x, y):
                            raise RuntimeError(
                                f"{name} under threads gave other bits")
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(f"thread {i}: {e!r}")

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in ts), "15e: a thread never ended")
    require(not errors, f"15e: {errors}")
    after = launch_counts(GW, K)
    grown = {k: after[k] - before[k] for k in after}
    require(grown["grouped_sum"] == threads * calls * 2
            and grown["window_group_sums"] == threads * calls
            and grown["q1_fused"] == 0,
            f"15e: launch counters grew by {grown}, expected "
            f"{threads * calls * 3} in all")
    print(f"runtime 15e: {threads} threads x {calls} x (grouped_sum tier "
          f"A, tier B, window_group_sums) at phase 3's shapes in "
          f"{wall:.2f} s: every result equal to the bit to the call made "
          f"alone, launches grew by {grown}", flush=True)
    return {"launches": grown, "wall": wall}


# ---------------------------------------------------------------------------
# phase 16: the shuffle manager lane
#: the queries of 16a, through four executors of the card
SHUFFLE_QUERIES = (3, 5, 9, 18)
SHUFFLE_EXECUTORS = 4
#: rows of the map output the second process serves in 16e
SHUFFLE_CHILD_ROWS = 1 << 22
#: 16e's paced frames (seconds a DATA frame waits once the child is told
#: to pace), and how long into the paced read the child is killed
SHUFFLE_PACE_S = 0.1
SHUFFLE_KILL_AFTER_S = 0.3
_STRING_POOL = [f"{c} {n}" for c in ("almond", "blush", "cornsilk",
                                     "dodger", "frosted", "ghost")
                for n in ("requests", "deposits", "packages", "accounts",
                          "theodolites")]


def shuffle_child_table(seed: int, rows: int):
    """The map output of 16e's second process, as a pyarrow table: int64
    keys, float64 and int32 measures with nulls, and dictionary strings
    with nulls, all from `seed` (the parent rebuilds it to compare)."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    k = rng.integers(-(1 << 40), 1 << 40, rows)
    v = rng.standard_normal(rows)
    d = rng.integers(-(1 << 20), 1 << 20, rows).astype(np.int32)
    idx = rng.integers(0, len(_STRING_POOL), rows).astype(np.int32)
    v_null, d_null, s_null = (rng.random(rows) < p
                              for p in (0.05, 0.1, 0.02))
    s = pa.DictionaryArray.from_arrays(
        pa.array(idx, mask=s_null), pa.array(_STRING_POOL))
    return pa.table({"k": pa.array(k), "v": pa.array(v, mask=v_null),
                     "d": pa.array(d, mask=d_null), "s": s})


SHUFFLE_CHILD = r'''
import json, sys, threading, time
import torch
import chip_smoke as CS
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.env import ResourceEnv
from spark_rapids_tpu_torch.shuffle import ici_transport as ici
from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager

spec = json.loads(sys.stdin.readline())
paced = threading.Event()
_send = ici._send_all


def _paced_send(conn, data):
    # told to pace, every DATA-sized frame waits: the parent's second
    # read is then in flight long enough to kill this process in it
    _send(conn, data)
    if paced.is_set() and len(data) > 512:
        time.sleep(spec["pace_s"])


ici._send_all = _paced_send
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
conf = C.RapidsConf({"spark.rapids.shuffle.enabled": True,
                     "spark.rapids.shuffle.compression.codec": "lz4"})
with C.session(conf):
    t0 = time.perf_counter()
    env = ResourceEnv.init(conf, device=dev)
    mgr = TpuShuffleManager("executor-S", env, conf)
    mgr.register_shuffle(spec["shuffle_id"])
    batch = ColumnarBatch.from_arrow(
        CS.shuffle_child_table(spec["seed"], spec["rows"]), device=dev)
    w = mgr.get_writer(spec["shuffle_id"], 0)
    w.write_partition(0, batch)
    st = w.commit(1)
    torch.cuda.synchronize(dev)
    print("OUTPUT:" + json.dumps({
        "executor_id": st.executor_id, "tcp_address": st.tcp_address,
        "partition_sizes": st.partition_sizes,
        "setup_s": time.perf_counter() - t0}), flush=True)
    for line in sys.stdin:
        if line.strip() == "pace":
            paced.set()
            print("PACED", flush=True)
'''


def start_shuffle_child(seed: int, shuffle_id: int):
    """16e's second OS process on the card, started early so that its
    start overlaps 16a-16d: it makes a map output of SHUFFLE_CHILD_ROWS
    rows on the card and serves it over TCP with lz4."""
    import subprocess
    proc = subprocess.Popen(
        [sys.executable, "-c", SHUFFLE_CHILD], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=str(Path(__file__).resolve().parent))
    proc.stdin.write((json.dumps({
        "seed": seed, "rows": SHUFFLE_CHILD_ROWS, "shuffle_id": shuffle_id,
        "pace_s": SHUFFLE_PACE_S}) + "\n").encode())
    proc.stdin.flush()
    return proc


def child_line(proc, prefix: str, timeout: float = 120.0) -> str:
    """The child's next stdout line, which must start with `prefix`; the
    wait is bounded (a reader thread, joined with a timeout)."""
    import threading
    box: list = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    line = box[0].decode() if box else ""
    if not line.startswith(prefix):
        proc.kill()
        err = proc.stderr.read().decode()[-3000:]
        raise RuntimeError(f"16e: the serving process said {line!r}, not "
                           f"{prefix}: {err}")
    return line[len(prefix):]


def shuffle_conf(q: int, **extra):
    """The TPC bench conf with test.enabled and the manager lane over
    SHUFFLE_EXECUTORS executors, plus `extra`."""
    from spark_rapids_tpu_torch import config as C
    return tpch_conf(q, **{C.RAPIDS_SHUFFLE_ENABLED.key: True,
                           C.SHUFFLE_LOCAL_EXECUTORS.key: SHUFFLE_EXECUTORS,
                           **extra})


def exchange_totals(plan) -> dict:
    """The manager-lane metrics of every ShuffleExchangeExec in `plan`,
    summed."""
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    names = ("dataSize", "numFetchFailures", "numMapRecomputes",
             "numStageRetries", "numPeersBlacklisted", "numSpeculativeTasks",
             "numSpeculativeWins", "shuffleCompressedBytes",
             "shuffleUncompressedBytes")
    tot = dict.fromkeys(names, 0.0)
    n = 0
    for node in walk(plan):
        if isinstance(node, ShuffleExchangeExec):
            n += 1
            d = node.metrics.as_dict()
            for k in names:
                tot[k] += d.get(k, 0)
    tot["exchanges"] = n
    return tot


def same_result(want, got, label: str) -> None:
    """Two results of one query equal to the bit (values, nulls, order,
    dtypes)."""
    require(list(want.columns) == list(got.columns)
            and want.reset_index(drop=True).equals(
                got.reset_index(drop=True)),
            f"{label}: not the same rows, to the bit, as 16a's")


def shuffle_query(torch, dev, q: int, tables: dict, gold: dict, conf,
                  label: str, GW, K, cases=None) -> dict:
    """One TPC-H query through the manager lane as a user submits it: the
    result against its golden, accelerate and collect apart, the
    exchanges' metrics, the device store's peak, the bytes each tier took,
    peak device memory, the launches and, with `cases`, the widest call
    of each kernel held against its twin; device memory back to its
    value before the query.  The plan is dropped before the memory check."""
    import threading

    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    from spark_rapids_tpu_torch.shuffle.manager import MapOutputRegistry
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    env = ResourceEnv.get(dev)
    stores = (env.device_store, env.host_store, env.disk_store)
    added0 = [s.bytes_added for s in stores]
    env.device_store.reset_peak()
    launches0 = launch_counts(GW, K)
    wcalls, gcalls, AGG.window_group_sums, AGG.grouped_sum = \
        threadsafe_recorders(GW, K, threading.Lock())
    held: list = []
    try:
        df, sub, sec = submit_tpch(torch, dev, q, tables, conf, label,
                                   keep=held)
    finally:
        AGG.window_group_sums = GW.window_group_sums
        AGG.grouped_sum = K.grouped_sum
    launches = {k: v - launches0[k] for k, v in launch_counts(GW, K).items()}
    rel = check_tpch(q, df, gold, sub)
    totals = exchange_totals(held[0])
    out = {**sec, "rel": rel, "rows": len(df), "launches": launches,
           "exchanges": totals, "frame": df,
           "device_store_peak": env.device_store.peak_size,
           "tier_bytes": {s.tier.name.lower(): s.bytes_added - a
                          for s, a in zip(stores, added0)},
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"shuffle {label} {sf_of(tables)} over {SHUFFLE_EXECUTORS} "
          f"executors: accelerate {sec['accelerate']:.3f} s, collect "
          f"{sec['collect']:.3f} s, {len(df)} rows, rel err {rel:.3g}; "
          f"{totals['exchanges']} exchanges, map outputs "
          f"{int(totals['dataSize'])} bytes written, tiers "
          f"{out['tier_bytes']}, device store peak "
          f"{out['device_store_peak']} bytes; peak device memory "
          f"{out['peak_gib']:.2f} GiB; launches {launches}", flush=True)
    if cases is not None:
        grouped_case, window_case = cases
        out["cases"] = {}
        if wcalls:
            gid, vals, cap = wcalls
            case = window_case(gid, vals, cap)
            case.update(query=q, launches=launches["window_group_sums"],
                        shape=f"{label} widest call: capacity {gid.numel()},"
                        f" out_cap {cap}, M={len(vals)}")
            print(kernel_text("window_group_sums", case), flush=True)
            out["cases"]["window_group_sums"] = case
            del gid, vals
        if gcalls:
            keys, gvals, nrows, groups = gcalls
            case = grouped_case(keys, gvals, nrows, groups, None)
            case.update(query=q, launches=launches["grouped_sum"],
                        shape=f"{label} widest call: capacity "
                        f"{keys.numel()}, G={groups}, M={len(gvals)}, tier "
                        f"{case['tier']}")
            print(kernel_text("grouped_sum", case), flush=True)
            out["cases"]["grouped_sum"] = case
            del keys, gvals
        for name in ("window_group_sums", "grouped_sum"):
            require(not launches[name] or name in out["cases"],
                    f"{label}: {name} launched but no call was recorded")
        del wcalls[:], gcalls[:]
    del wcalls, gcalls
    del held, sub
    out["memory"] = settled_memory(torch, dev, GW, K, before, state0,
                                   f"shuffle {label}")
    require(MapOutputRegistry.live_shuffles() == 0,
            f"{label}: map outputs still registered after the query")
    require(env.device_store.current_size == 0,
            f"{label}: {env.device_store.current_size} bytes of map "
            f"output left in the device store")
    return out


class tcp_statuses:
    """Within the block every map output is advertised on the TCP lane:
    a registered MapStatus's address is its TCP address, so readers in
    this process fetch other executors' outputs over sockets."""

    def __enter__(self):
        from spark_rapids_tpu_torch.shuffle.manager import MapOutputRegistry
        self.cls = MapOutputRegistry
        self.orig = MapOutputRegistry.__dict__["register"]
        register = MapOutputRegistry.register

        def over_tcp(shuffle_id, map_id, status, epoch=None,
                     first_wins=False):
            if status.tcp_address:
                status.address = status.tcp_address
            return register(shuffle_id, map_id, status, epoch=epoch,
                            first_wins=first_wins)
        MapOutputRegistry.register = staticmethod(over_tcp)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, "register", self.orig)


def shuffle_threads() -> list:
    """The live threads of the shuffle lane: accept loops, handlers,
    fetches, hedges and speculative attempts."""
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("tpu-shuffle", "tpu-speculate"))]


def shuffle_phase(torch, dev, tables: dict, gold: dict, GW, K, cases,
                  seed: int) -> dict:
    """Phase 16 (see the module docstring): 16a-16f.  Returns each part's
    figures and launches."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exec import speculation as SPEC
    from spark_rapids_tpu_torch.exec.joins import (JoinType,
                                                   NestedLoopJoinExec)
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    from spark_rapids_tpu_torch.shuffle import client_server as CSV
    from spark_rapids_tpu_torch.shuffle import manager as M
    from spark_rapids_tpu_torch.shuffle.recovery import PeerHealth
    from spark_rapids_tpu_torch.utils import metrics as MX
    from spark_rapids_tpu_torch.utils import watchdog as W
    out: dict = {"launches": {}}
    laps: dict = {}
    child_sid = 1 << 30
    child = start_shuffle_child(seed, child_sid)

    def part_done(name: str, t0: float) -> None:
        laps[name] = time.perf_counter() - t0
        print(f"phase {name}: {laps[name]:.1f} s", flush=True)

    def fresh_executors() -> None:
        # the executors take their conf (codec, fault injection) when
        # made: each part makes its own
        M.TpuShuffleManager.close_all()
        M.MapOutputRegistry.clear()
        PeerHealth.get().clear()

    try:
        # 16a. Q3, Q5, Q9, Q18 over the loopback lane
        t_part = time.perf_counter()
        fresh_executors()
        out["16a"] = {}
        for q in SHUFFLE_QUERIES:
            out["16a"][q] = shuffle_query(torch, dev, q, tables, gold,
                                          shuffle_conf(q), f"16a q{q}", GW,
                                          K, cases)
        # the queries' own launches: the twin checks' are not the path's
        out["launches"]["16a"] = {k: sum(v["launches"][k] for v in
                                         out["16a"].values())
                                  for k in launch_counts(GW, K)}
        require(out["launches"]["16a"]["window_group_sums"] > 0,
                "window_group_sums never launched in 16a")
        require(M.TpuShuffleManager.live_executors() == SHUFFLE_EXECUTORS,
                f"16a: {M.TpuShuffleManager.live_executors()} executors")
        part_done("16a (Q3, Q5, Q9, Q18 over four executors)", t_part)

        # 16b. Q5, every map output on the TCP lane, zstd on the wire
        t_part = time.perf_counter()
        fresh_executors()
        with tcp_statuses():
            b = shuffle_query(torch, dev, 5, tables, gold, shuffle_conf(
                5, **{C.SHUFFLE_COMPRESSION_CODEC.key: "zstd"}),
                "16b q5 tcp zstd", GW, K)
        same_result(out["16a"][5]["frame"], b["frame"], "16b q5")
        wire = b["exchanges"]["shuffleCompressedBytes"]
        raw = b["exchanges"]["shuffleUncompressedBytes"]
        require(wire > 0 and raw > wire,
                f"16b: no compressed bytes crossed the wire ({wire}, {raw})")
        print(f"shuffle 16b: Q5 over TCP with zstd, {int(wire)} wire bytes "
              f"for {int(raw)} raw ({wire / raw:.3f}), the rows of 16a's "
              f"to the bit", flush=True)
        out["16b"] = {**b, "wire_bytes": wire, "raw_bytes": raw}
        out["launches"]["16b"] = b["launches"]
        part_done("16b (Q5 over TCP with zstd)", t_part)

        # 16c. Q3 with one executor killed after a few served frames
        t_part = time.perf_counter()
        fresh_executors()
        recovery = {C.SHUFFLE_FETCH_MAX_RETRIES.key: 1,
                    C.SHUFFLE_FETCH_BACKOFF_BASE_MS.key: 1.0,
                    C.SHUFFLE_BLACKLIST_THRESHOLD.key: 1}
        conf_c = shuffle_conf(3, **recovery)
        for i in range(SHUFFLE_EXECUTORS):
            M.TpuShuffleManager.get_or_create(
                f"local-{i}", conf=conf_c if i != 1 else shuffle_conf(
                    3, **recovery,
                    **{C.SHUFFLE_FAULT_PEER_KILL_FRAMES.key: 4}),
                device=dev)
        victim = M.TpuShuffleManager.get("local-1")
        c = shuffle_query(torch, dev, 3, tables, gold, conf_c,
                          "16c q3 peer kill", GW, K)
        same_result(out["16a"][3]["frame"], c["frame"], "16c q3")
        ex = c["exchanges"]
        require(victim.transport.faults.peer_killed,
                "16c: the victim executor was never killed")
        require(ex["numMapRecomputes"] > 0 and ex["numStageRetries"] > 0,
                f"16c: no recovery: {ex}")
        print(f"shuffle 16c: Q3 with local-1 killed after "
              f"{victim.transport.faults.frames_served} frames: fetch "
              f"failures {int(ex['numFetchFailures'])}, maps recomputed "
              f"{int(ex['numMapRecomputes'])}, stage attempts beyond the "
              f"first {int(ex['numStageRetries'])}, peers blacklisted "
              f"{int(ex['numPeersBlacklisted'])}; the rows of 16a's to the "
              f"bit", flush=True)
        out["16c"] = c
        out["launches"]["16c"] = c["launches"]
        part_done("16c (Q3 under peer kill)", t_part)

        # 16d. Q3 with speculation against one slow executor
        t_part = time.perf_counter()
        fresh_executors()
        SPEC.reset_speculation_stats()
        W.reset_slow_injection()
        d = shuffle_query(torch, dev, 3, tables, gold, shuffle_conf(3, **{
            C.SPECULATION_ENABLED.key: True,
            C.SPECULATION_MIN_RUNTIME_MS.key: 50.0,
            C.SPECULATION_MIN_COMPLETED.key: 1,
            C.SPECULATION_MULTIPLIER.key: 3.0,
            C.WATCHDOG_POLL_INTERVAL.key: 0.05,
            C.SLOW_INJECT_SITE.key: "map-task",
            C.SLOW_INJECT_FACTOR.key: 10.0,
            C.SLOW_INJECT_UNIT_MS.key: 20.0,
            C.SLOW_INJECT_VICTIM.key: "local-1",
            C.SLOW_INJECT_SEED.key: seed}), "16d q3 speculation", GW, K)
        same_result(out["16a"][3]["frame"], d["frame"], "16d q3")
        stats = SPEC.speculation_stats()
        require(stats["wins"] >= 1 and stats["losers_cancelled"] >= 1,
                f"16d: no duplicate won and no loser was cancelled: "
                f"{stats}")
        print(f"shuffle 16d: Q3 with local-1 slowed "
              f"{W.slow_injection_counts()}: speculation {stats}, "
              f"exchanges {int(d['exchanges']['numSpeculativeTasks'])} "
              f"duplicates, {int(d['exchanges']['numSpeculativeWins'])} "
              f"won; the rows of 16a's to the bit, every buffer freed",
              flush=True)
        W.reset_slow_injection()
        out["16d"] = {**d, "speculation": stats}
        out["launches"]["16d"] = d["launches"]
        part_done("16d (Q3 with speculation)", t_part)

        # 16e. a map output of a second process on the card, over TCP
        t_part = time.perf_counter()
        fresh_executors()
        gc.collect()
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        spec = json.loads(child_line(child, "OUTPUT:"))
        want = shuffle_child_table(seed, SHUFFLE_CHILD_ROWS)
        reader = M.TpuShuffleManager.get_or_create(
            "executor-R", conf=shuffle_conf(0), device=dev)
        reader.register_shuffle(child_sid)
        M.MapOutputRegistry.register(child_sid, 0, M.MapStatus(
            spec["executor_id"], spec["tcp_address"],
            spec["partition_sizes"], tcp_address=spec["tcp_address"]))
        metrics = MX.MetricSet()
        t0 = time.perf_counter()
        got = list(reader.get_reader(child_sid, 0, timeout=30.0,
                                     metrics=metrics))
        torch.cuda.synchronize(dev)
        read_s = time.perf_counter() - t0
        require(len(got) == 1 and got[0].device.type == "cuda",
                f"16e: {len(got)} batches read")
        table = got[0].to_arrow()
        for name in want.column_names:
            w_col = want.column(name)
            if name == "s":
                w_col = w_col.cast("string")
            require(table.column(name).equals(w_col),
                    f"16e: column {name} differs from the served batch")
        md = metrics.as_dict()
        del got, table
        print(f"shuffle 16e: {SHUFFLE_CHILD_ROWS} rows (int64, float64 and "
              f"int32 with nulls, strings with nulls) from a second "
              f"process on the card (its setup {spec['setup_s']:.1f} s) "
              f"over TCP with lz4 in {read_s:.3f} s: "
              f"{int(md['shuffleCompressedBytes'])} wire bytes for "
              f"{int(md['shuffleUncompressedBytes'])} raw, equal to the "
              f"batch to the bit", flush=True)
        # the server is killed while a second read of the same output is
        # in flight: FetchFailedError within the read's timeout, no hang
        child.stdin.write(b"pace\n")
        child.stdin.flush()
        child_line(child, "PACED")
        seen: dict = {}

        def kill_in_flight():
            deadline = time.monotonic() + 20.0
            while not CSV.inflight_count() and time.monotonic() < deadline:
                time.sleep(0.005)
            time.sleep(SHUFFLE_KILL_AFTER_S)
            seen["in_flight"] = CSV.inflight_fetches()
            child.kill()

        import threading
        killer = threading.Thread(target=kill_in_flight, daemon=True)
        killer.start()
        t0 = time.perf_counter()
        try:
            list(reader.get_reader(child_sid, 0, timeout=20.0))
            raise RuntimeError("16e: the read completed though its server "
                               "was killed")
        except CSV.FetchFailedError as e:
            failed = str(e)
        kill_s = time.perf_counter() - t0
        killer.join(30)
        child.wait(30)
        require(bool(seen.get("in_flight")),
                "16e: the server was not killed while a fetch was in flight")
        require(kill_s < 30.0, f"16e: FetchFailedError took {kill_s:.1f} s")
        reader.unregister_shuffle(child_sid)
        print(f"shuffle 16e: the server process killed "
              f"{SHUFFLE_KILL_AFTER_S} s into a paced read (in flight: "
              f"{seen['in_flight']}): FetchFailedError after {kill_s:.2f} s:"
              f" {failed[:160]}", flush=True)
        out["16e"] = {"rows": SHUFFLE_CHILD_ROWS, "read_s": read_s,
                      "child_setup_s": spec["setup_s"],
                      "wire_bytes": md["shuffleCompressedBytes"],
                      "raw_bytes": md["shuffleUncompressedBytes"],
                      "kill_s": kill_s}
        fresh_executors()
        out["16e"]["memory"] = settled_memory(torch, dev, GW, K, before,
                                              kernel_state_bytes(GW, K),
                                              "shuffle 16e")
        part_done("16e (a second process's map output over TCP)", t_part)

        # 16f. the brute-force joins on the card
        t_part = time.perf_counter()
        reset_launches(GW, K)
        conf_f = tpch_conf(0, **{
            C.op_enable_key("exec", "CpuCartesianProduct"): True,
            C.op_enable_key("exec", "CpuNestedLoopJoin"): True})
        src = TD.sources({k: tables[k] for k in ("nation", "region")}, 1)
        cross = tables["nation"].merge(tables["region"], how="cross")
        out["16f"] = {}
        for name, node, want_df in (
                ("cartesian", N.CpuCartesianProduct(src["nation"],
                                                    src["region"]), cross),
                ("nested loop", N.CpuNestedLoopJoin(
                    JoinType.INNER, src["nation"], src["region"],
                    col("n_regionkey") < col("r_regionkey")),
                 cross[cross["n_regionkey"] < cross["r_regionkey"]])):
            t0 = time.perf_counter()
            plan = accelerate(node, conf_f, device=dev)
            require(any(isinstance(n, NestedLoopJoinExec)
                        for n in walk(plan)),
                    f"16f {name}: no NestedLoopJoinExec in the plan")
            df = collect(plan, conf_f)
            sec = time.perf_counter() - t0
            keys = ["n_nationkey", "r_regionkey"]
            got_df = df.sort_values(keys, ignore_index=True)
            want_s = want_df.sort_values(keys, ignore_index=True)
            require(len(got_df) == len(want_s), f"16f {name}: rows")
            for c_ in want_s.columns:
                require(got_df[c_].astype(str).tolist()
                        == want_s[c_].astype(str).tolist(),
                        f"16f {name}: column {c_} differs from pandas")
            print(f"shuffle 16f: nation x region {name} on the card: "
                  f"{len(df)} rows equal to pandas, {sec:.3f} s", flush=True)
            out["16f"][name] = {"rows": len(df), "s": sec}
            del plan, df
        out["launches"]["16f"] = launch_counts(GW, K)
        part_done("16f (the brute-force joins)", t_part)
    finally:
        child.kill()
        child.wait(30)
        M.TpuShuffleManager.close_all()
    deadline = time.monotonic() + 10.0
    while shuffle_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    require(M.TpuShuffleManager.live_executors() == 0,
            "executors left after phase 16")
    require(not shuffle_threads(),
            f"shuffle threads left after phase 16: {shuffle_threads()}")
    print(f"shuffle: live executors {M.TpuShuffleManager.live_executors()},"
          f" shuffle threads {shuffle_threads()}", flush=True)
    for part in ("16a",):
        for v in out[part].values():
            v.pop("frame", None)
    for part in ("16b", "16c", "16d"):
        out[part].pop("frame", None)
    out["laps"] = laps
    return out


# -- phase 17: the observability layer -------------------------------------
#: phase 17's profiled settings: the query profile, kernel attribution
#: with every entry timed (so a catalog mean is the mean of every
#: launch) and telemetry
PROFILE_KEYS = {"spark.rapids.sql.profile.enabled": True,
                "spark.rapids.sql.profile.kernels.enabled": True,
                "spark.rapids.sql.profile.kernels.sampleRate": 1,
                "spark.rapids.sql.telemetry.enabled": True,
                "spark.rapids.sql.telemetry.samplePeriodMs": 20.0}
#: where phase 17's profiles write their Chrome traces and event log
#: (git-ignored, emptied at the phase's start and end)
PROFILE_DIR = Path(__file__).resolve().parent / ".profile_smoke"
#: the relative gap allowed between a hand kernel's warm catalog mean
#: (CUDA events around each launch, queued behind a spin) and the kernel
#: alone timed as the phases after 3 time it, at the same shape
CATALOG_RTOL = 0.25
#: 17d's two streams (Q1, Q3 and Q5 between them)
PROFILE_STREAMS = [[1, 3], [5]]
#: the threads telemetry runs while it is on (utils/telemetry.py)
TELEMETRY_THREADS = ("tpu-telemetry", "tpu-telemetry-http")


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_conf(q: int, **extra):
    """tpch_conf with phase 17's profiled settings and sinks."""
    return tpch_conf(q, **PROFILE_KEYS, **{
        "spark.rapids.sql.profile.chromeTrace.path":
            str(PROFILE_DIR / "trace-{query_id}.json"),
        "spark.rapids.sql.profile.eventLog.path":
            str(PROFILE_DIR / "events.jsonl")}, **extra)


def process_rss() -> int:
    """The process's resident set, in bytes."""
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def check_profile(prof, plans: list, label: str, card: str = "") -> dict:
    """A QueryProfile's checks: its Chrome trace parses (in memory and
    as written), every TpuExec of `plans` has a span, no share of a
    roofline is above 100%, the residency verdict is clean."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    require(prof is not None, f"{label}: no QueryProfile")
    trace = json.loads(json.dumps(prof.chrome_trace()))
    written = json.loads((PROFILE_DIR / f"trace-{prof.query_id}.json")
                         .read_text())
    require(written["otherData"]["query_id"] == prof.query_id
            and len(written["traceEvents"]) == len(trace["traceEvents"]),
            f"{label}: the written Chrome trace is not the profile's")
    spanned = {s.name.split("[")[0] for s in prof.spans if s.cat == "exec"}
    ops = {type(n).__name__ for p in plans for n in walk(p)
           if isinstance(n, TpuExec)}
    require(ops <= spanned, f"{label}: operators without a span: "
            f"{sorted(ops - spanned)}")
    shares = [r["roofline_pct"] for r in prof.kernels or ()
              if "roofline_pct" in r]
    require(all(s <= 100.0 for s in shares),
            f"{label}: a kernel above its roofline: {max(shares)}%")
    util = [e["roofline_utilization"]
            for e in prof.movement["edges"].values()]
    require(all(u <= 1.0 for u in util),
            f"{label}: an edge above its roofline: {util}")
    res = prof.residency
    require(res is not None and res["leaks"] == 0
            and res["live_end_bytes"] == 0,
            f"{label}: residency {res}")
    edges = {e: v["bytes"] for e, v in prof.movement["edges"].items()}
    print(f"profile {label}: {len(prof.spans)} spans, "
          f"{len(prof.events)} events, {len(trace['traceEvents'])} trace "
          f"events, depth {prof.span_depth()}, wall "
          f"{prof.wall_s * 1e3:.1f} ms, breakdown {prof.breakdown}, "
          f"movement {edges}, residency high water "
          f"{res['hbm_high_water']} bytes, {len(prof.kernels or ())} "
          f"kernels, max roofline share "
          f"{max(shares) if shares else 0.0:.3g}% [{card}]", flush=True)
    return {"spans": len(prof.spans), "events": len(prof.events),
            "wall_s": prof.wall_s, "breakdown": prof.breakdown,
            "movement": edges, "hbm_high_water": res["hbm_high_water"],
            "kernels": len(prof.kernels or ())}


def profiled_pair(torch, dev, q: int, tables: dict, gold: dict, label: str,
                  conf_plain, conf_prof, source_fn=None,
                  plain_run: Optional[tuple] = None) -> tuple:
    """Query q unprofiled (or `plain_run`, its (frame, seconds) from a run
    already made), then profiled: the same bits, the golden, and the
    profile.  Returns (profile, plans, unprofiled seconds, profiled
    seconds)."""
    from spark_rapids_tpu_torch.utils import profile as P
    if plain_run is None:
        plain, _, sec0 = submit_tpch(torch, dev, q, tables, conf_plain,
                                     f"{label} plain", source=source_fn()
                                     if source_fn else None)
    else:
        plain, sec0 = plain_run
    P.clear_history()
    held: list = []
    df, sub, sec1 = submit_tpch(torch, dev, q, tables, conf_prof, label,
                                source=source_fn() if source_fn else None,
                                keep=held)
    prof = P.last_profile()
    same_result(plain, df, f"{label} profiled")
    rel = check_tpch(q, df, gold, sub)
    print(f"profile {label}: unprofiled collect {sec0['collect']:.3f} s, "
          f"profiled {sec1['collect']:.3f} s (x"
          f"{sec1['collect'] / sec0['collect']:.3f}), same bits, rel err "
          f"{rel:.3g}", flush=True)
    return prof, held, sec0["collect"], sec1["collect"]


def profile_phase(torch, dev, tables: dict, gold: dict, GW, K,
                  kernels: dict, seed: int, keep: str = "") -> dict:
    """Phase 17 (see the module docstring): 17a-17e over phases 7-9's
    tables and goldens and 14b's files.  Returns each part's figures and
    each hand kernel's catalog figures.  `keep` names a directory the
    Chrome traces and the event log are copied to before PROFILE_DIR is
    removed."""
    import shutil
    import threading
    import urllib.request

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.memory import ResourceEnv
    from spark_rapids_tpu_torch.memory import oocore as OC
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager
    from spark_rapids_tpu_torch.utils import kernelprof as KP
    from spark_rapids_tpu_torch.utils import movement as MV
    from spark_rapids_tpu_torch.utils import profile as P
    from spark_rapids_tpu_torch.utils import residency as RS
    from spark_rapids_tpu_torch.utils import telemetry as T
    out: dict = {"laps": {}, "launches": {}}
    on_card = dev.type == "cuda"  # the wrappers launch on the card only
    card = TB.card() if on_card else "cpu"
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    PROFILE_DIR.mkdir(parents=True)

    def part_done(name: str, t0: float) -> None:
        out["laps"][name] = time.perf_counter() - t0
        print(f"phase {name}: {out['laps'][name]:.1f} s", flush=True)

    def files():
        return file_sources(TD.SCHEMAS, TD.SCHEMAS)

    def q5_unprofiled(label: str) -> tuple:
        gc.collect()
        df, _, sec = submit_tpch(torch, dev, 5, tables, tpch_conf(5),
                                 label, source=files())
        check_tpch(5, df, gold, [])
        gc.collect()
        rec = {"collect_s": sec["collect"], "rss": process_rss(),
               "gc_count": gc.get_count()}
        print(f"profile {label}: Q5 unprofiled collect "
              f"{sec['collect']:.3f} s, rss {rec['rss']} bytes, "
              f"gc.get_count() {rec['gc_count']}", flush=True)
        return rec, (df, sec)

    # 17e's first half: Q5 unprofiled, before anything is on; 17a's
    # profiled Q5 is held against this run
    t_part = time.perf_counter()
    out["17e_before"], q5_plain = q5_unprofiled("17e before")
    part_done("17e (before)", t_part)

    # telemetry with its HTTP endpoint on a free port of 127.0.0.1, for
    # the whole phase (17d reads it); kernel attribution from a clean
    # catalog
    P.clear_history()
    KP.reset()
    RS.reset()
    MV.reset_process_edge_totals()
    telem = T.start(profile_conf(1), http_port=0)
    KP.enable(profile_conf(1))

    # 17a: planner Q1 and Q5 over 14b's files, the exec-tree Q1 and the
    # stacked Q1 step over one SF1-sized lineitem batch, and
    # window_group_sums at phase 3's main-path shape
    t_part = time.perf_counter()
    launches0 = launch_counts(GW, K)
    cat0 = {n: KP.hand_kernel_totals(n)["launches"]
            for n in ("q1_fused", "grouped_sum", "window_group_sums")}
    out["17a"] = {}
    for q in (1, 5):
        prof, plans, s0, s1 = profiled_pair(
            torch, dev, q, tables, gold, f"17a q{q}", tpch_conf(q),
            profile_conf(q), files, q5_plain if q == 5 else None)
        info = check_profile(prof, plans, f"17a q{q}", card)
        require(info["movement"]["upload"] > 0
                and info["movement"]["readback"] > 0,
                f"17a q{q}: upload or readback moved no bytes: "
                f"{info['movement']}")
        require(info["hbm_high_water"] > 0,
                f"17a q{q}: no residency high-water mark")
        info.update(unprofiled_s=s0, profiled_s=s1)
        out["17a"][f"q{q}"] = info
        del prof, plans
    del q5_plain
    # the exec-tree Q1 and the stacked step over one batch of SF1's
    # 6,001,215 lineitem rows at capacity 2^23 (phase 3's grouped_sum
    # shape: 2^23 rows, G=26, M=14)
    rows = len(tables["lineitem"])
    arrays = tpch.gen_lineitem_arrays(np.random.default_rng(seed), rows)
    batch = ColumnarBatch.from_numpy(arrays, tpch.LINEITEM_SCHEMA,
                                     capacity=TB.BATCH_CAP, device=dev)
    gold1 = golden_q1([arrays])
    conf1 = C.RapidsConf({**TB.BENCH_CONF, **PROFILE_KEYS, **{
        "spark.rapids.sql.profile.chromeTrace.path":
            str(PROFILE_DIR / "trace-{query_id}.json")}})
    # each kernel's catalog mean is taken over its warm samples: those
    # after a first call at its shape (marks)
    shapes = {"q1_fused": (TB.BATCH_CAP, TB.BATCH_CAP),
              "grouped_sum": (TB.BATCH_CAP, 26, 14, "A"),
              "window_group_sums": (1 << 14, 1 << 14, 17)}

    def entry_totals(name: str) -> tuple:
        want = repr(((KP.HAND_SCOPE, name), (name,) + shapes[name]))
        rows_ = [e for e in KP.hand_kernel_totals(name)["entries"]
                 if e["identity"] == want]
        return (rows_[0]["sampled"], rows_[0]["device_ns"],
                rows_[0]["cost"], rows_[0]["hist"]) if rows_ \
            else (0, 0, None, [0] * (len(KP.TIME_BUCKETS) + 1))

    marks = {}
    # the unprofiled exec-tree Q1 keeps its grouped_sum call's inputs,
    # which are timed alone below
    gcalls: list = []
    AGG.grouped_sum = recording_grouped(gcalls, K)
    try:
        with C.session(C.RapidsConf(dict(TB.BENCH_CONF))):
            plain = tpch.q1_plan(LocalBatchSource([[batch]], device=dev)) \
                .collect().to_pandas()
    finally:
        AGG.grouped_sum = K.grouped_sum
    require(bool(gcalls) or not on_card,
            "17a exec-tree q1: no grouped_sum call on the card")
    marks["grouped_sum"] = entry_totals("grouped_sum")
    P.clear_history()
    with C.session(conf1):
        plan = tpch.q1_plan(LocalBatchSource([[batch]], device=dev))
        df = plan.collect().to_pandas()
    same_result(plain, df, "17a exec-tree q1 profiled")
    require(list(df["count_order"]) == [int(c) for c in gold1["count"]
                                        if c],
            "17a exec-tree q1 counts differ from the golden")
    out["17a"]["exec_q1"] = check_profile(P.last_profile(), [plan],
                                          "17a exec-tree q1", card)
    # five more profiled collects: grouped_sum's warm samples
    with C.session(conf1):
        for _ in range(5):
            again = tpch.q1_plan(LocalBatchSource([[batch]], device=dev)) \
                .collect().to_pandas()
            same_result(plain, again, "17a exec-tree q1 profiled again")
    del plan, plain, df, again
    stacked, nums = TB.stacked_columns([batch], [rows], dev)
    step = tpch.build_q1_fused_kernel(TB.BATCH_CAP, TB.BATCH_CAP,
                                      device=dev)
    plain = step(*stacked, nums).cpu()
    marks["q1_fused"] = entry_totals("q1_fused")
    scope = S.QueryScope(conf1, device=dev)
    try:
        outs = [step(*stacked, nums).cpu() for _ in range(5)]
    finally:
        scope.close()
    require(all(torch.equal(t, plain) for t in outs),
            "17a stacked step: a profiled call gave other bits")
    step_prof = P.last_profile()
    # window_group_sums at phase 3's main-path shape (Q1's merge: 8
    # partials x 6 groups sorted into 2^14 rows, 17 measures)
    g = torch.Generator(device=dev).manual_seed(seed)
    merge_cap, live = 1 << 14, TB.N_BATCHES * 6
    gid = torch.clamp(torch.arange(merge_cap, device=dev) // TB.N_BATCHES,
                      max=5).to(torch.int32)
    row_live = torch.arange(merge_cap, device=dev) < live
    mvals = [torch.where(row_live, torch.rand(
        merge_cap, generator=g, device=dev) * 1e6, 0.0) for _ in range(17)]
    GW.window_group_sums(gid, mvals, out_cap=merge_cap, capacity=merge_cap)
    sync(torch, dev)
    marks["window_group_sums"] = entry_totals("window_group_sums")
    scope = S.QueryScope(conf1, device=dev)
    try:
        for _ in range(20):
            GW.window_group_sums(gid, mvals, out_cap=merge_cap,
                                 capacity=merge_cap)
    finally:
        scope.close()
    sync(torch, dev)
    a_launches = {k: v - launches0[k]
                  for k, v in launch_counts(GW, K).items()}
    catalog = {n: KP.hand_kernel_totals(n)
               for n in ("q1_fused", "grouped_sum", "window_group_sums")}
    for name, tot in catalog.items():
        got = tot["launches"] - cat0[name]
        require(got == a_launches[name] and (got > 0 or not on_card),
                f"17a {name}: catalog launches {got}, wrapper launches "
                f"{a_launches[name]}")
    KP.disable()  # the reference timings below are not the main path's

    def entry(name: str) -> dict:
        # the warm samples: those after the mark, with their histogram
        n1, ns1, cost, h1 = entry_totals(name)
        n0, ns0, _, h0 = marks[name]
        require(n1 - n0 >= 3 or not on_card,
                f"17a {name}: {n1 - n0} warm samples at {shapes[name]}")
        hist = {f"<={b * 1e3:g}ms" if i < len(KP.TIME_BUCKETS)
                else "more": y - x
                for i, (b, x, y) in enumerate(zip(
                    KP.TIME_BUCKETS + (None,), h0, h1)) if y - x}
        if n1 - n0 < 1:
            return {"mean_ms": float("nan"), "sampled": 0, "cost": None,
                    "hist": hist}
        return {"mean_ms": (ns1 - ns0) / (n1 - n0) / 1e6,
                "sampled": n1 - n0, "cost": cost, "hist": hist}

    # each kernel alone, timed as the phases after 3 time it, on the
    # inputs of the calls the catalog sampled: the stacked step's, the
    # exec-tree Q1's dictionary-lane call (recorded above), and the merge
    # shape's
    def alone(fn, reps: int) -> float:
        # CUDA events queued behind a sleep kernel, as every phase after
        # phase 7 times a kernel (the profiler records no device
        # activity there)
        return event_ms(torch, fn, reps) if on_card else float("nan")

    refs = {
        "q1_fused": alone(lambda: K.q1_fused(
            *stacked, nums, capacity=TB.BATCH_CAP, cutoff=10471,
            batch_rows=TB.BATCH_CAP), 10),
        "grouped_sum": alone(lambda: K.grouped_sum(
            gcalls[0], gcalls[1], gcalls[2], n_groups=gcalls[3],
            capacity=gcalls[0].numel()), 10) if gcalls else float("nan"),
        "window_group_sums": alone(lambda: GW.window_group_sums(
            gid, mvals, out_cap=merge_cap, capacity=merge_cap), 20)}
    del gcalls

    def phase3(name: str) -> str:
        k = kernels.get(name) or {}
        return (f"phase 3: {k['device_ms']:.4f} ms at {k['shape']}"
                if k.get("device_ms") else "phase 3 not run")

    compared = {
        "q1_fused": (entry("q1_fused"), refs["q1_fused"],
                     f"alone at 1x2^23; {phase3('q1_fused')}"),
        "grouped_sum": (entry("grouped_sum"), refs["grouped_sum"],
                        f"alone at 2^23 rows, G=26, M=14; "
                        f"{phase3('grouped_sum')}"),
        "window_group_sums": (entry("window_group_sums"),
                              refs["window_group_sums"],
                              f"alone at phase 3's merge shape; "
                              f"{phase3('window_group_sums')}")}
    out["catalog"] = {}
    gaps = []
    for name, (e, ref_ms, what) in compared.items():
        gap = abs(e["mean_ms"] - ref_ms) / ref_ms if ref_ms == ref_ms \
            else float("nan")
        share = ""
        if e["cost"]:
            t = e["mean_ms"] / 1e3
            gbs = e["cost"]["bytes_accessed"] / t / 1e9
            gfs = e["cost"]["flops"] / t / 1e9
            pct = 100 * max(gbs / 3350.0, gfs / 66900.0)
            share = f", {pct:.1f}% of the H100 roofline"
            require(pct <= 100.0, f"17a {name}: above its roofline")
        within = gap <= CATALOG_RTOL
        print(f"profile 17a catalog {name} [{card}]: warm sampled mean "
              f"{e['mean_ms']:.4f} ms over {e['sampled']} launches{share};"
              f" kernel alone {ref_ms:.4f} ms ({what}), gap "
              f"{gap * 100:.1f}%; samples by bucket {e['hist']}",
              flush=True)
        if on_card and not within:
            gaps.append(f"{name}: catalog mean {e['mean_ms']:.4f} ms is "
                        f"{gap * 100:.1f}% from the kernel alone")
        out["catalog"][name] = {**e, "reference_ms": ref_ms, "gap": gap,
                                "within": within, "reference": what,
                                "launches_17a": a_launches[name]}
    KP.enable(profile_conf(1))
    out["launches"]["17a"] = a_launches
    out["17a"]["stacked_step_kernels"] = [
        {k: r[k] for k in ("label", "dispatches", "sampled", "device_ms")}
        for r in step_prof.kernels]
    del stacked, nums, step, batch, arrays, gid, mvals, row_live, outs
    part_done("17a (profiled Q1 three ways, Q5; the catalog)", t_part)

    # 17c: Q3 over four executors of the card, profiled
    t_part = time.perf_counter()
    try:
        P.clear_history()
        held = []
        df, sub, sec = submit_tpch(
            torch, dev, 3, tables, shuffle_conf(3, **PROFILE_KEYS, **{
                "spark.rapids.sql.profile.chromeTrace.path":
                    str(PROFILE_DIR / "trace-{query_id}.json")}),
            "17c q3", keep=held)
        rel = check_tpch(3, df, gold, sub)
        prof = P.last_profile()
        info = check_profile(prof, held, "17c q3", card)
        wire = prof.movement["edges"]["wire"]["sites"]
        sent = sum(v["bytes"] for s, v in wire.items()
                   if s.startswith("send"))
        recv = sum(v["bytes"] for s, v in wire.items()
                   if s.startswith("recv"))
        require(sent == recv > 0, f"17c: wire sent {sent}, received {recv}")
        by_id = {s.sid: s for s in prof.spans}
        fetch = [s for s in prof.spans
                 if s.name.startswith("shuffle-fetch:")]
        require(fetch, "17c: no shuffle-fetch span")
        for s in fetch:
            cur = s
            while cur.parent_id is not None:
                cur = by_id[cur.parent_id]
            require(cur.cat == "query" and cur is not s,
                    f"17c: {s.name} does not parent under its query")
        print(f"profile 17c q3 over {SHUFFLE_EXECUTORS} executors: collect "
              f"{sec['collect']:.3f} s, rel err {rel:.3g}; wire sent "
              f"{sent} = received {recv} bytes; {len(fetch)} shuffle-fetch "
              f"spans under the query (threads "
              f"{sorted({s.thread_name for s in fetch})})", flush=True)
        out["17c"] = {"wire_bytes": sent, "fetch_spans": len(fetch),
                      "collect_s": sec["collect"], **info}
        del df, sub, held, prof
    finally:
        TpuShuffleManager.close_all()
    part_done("17c (Q3 over four executors, profiled)", t_part)

    # 17b: the same Q3 over four executors under phase 12's OOM
    # injection and a device budget cut from its peak (17c's residency
    # high-water mark), profiled, twice: with the out-of-core lanes
    # (a quarter of the peak: their runs spill), and without them (a
    # 32nd: the retry harness's pressure spills the device store, where
    # the manager lane parks its map output; with the lanes on, they
    # take the pressure first and the store never spills, and at a 16th
    # no reservation met the parked output on an H100)
    t_part = time.perf_counter()
    out["17b"] = {}
    for leg, share, oocore in (("out-of-core", 4, True),
                               ("device store", 32, False)):
        budget = max(1, out["17c"]["hbm_high_water"] // share)
        conf_b, env = memory_env(dev, {
            C.HBM_BUDGET_BYTES.key: budget, C.OOCORE_ENABLED.key: oocore,
            **MEM_INJECT})
        try:
            conf_b = conf_b.set(C.RAPIDS_SHUFFLE_ENABLED.key, True)
            conf_b = conf_b.set(C.SHUFFLE_LOCAL_EXECUTORS.key,
                                SHUFFLE_EXECUTORS)
            for k, v in PROFILE_KEYS.items():
                conf_b = conf_b.set(k, v)
            conf_b = conf_b.set(
                "spark.rapids.sql.profile.chromeTrace.path",
                str(PROFILE_DIR / "trace-{query_id}.json"))
            cb0 = env.spill_callback.bytes_spilled
            P.clear_history()
            held: list = []
            df, sub, sec = submit_tpch(torch, dev, 3, tables, conf_b,
                                       f"17b q3 {leg}", keep=held)
            rel = check_tpch(3, df, gold, sub)
            prof = P.last_profile()
            info = check_profile(prof, held, f"17b q3 {leg}", card)
            metric = {n: sum(node.metrics.value(n)
                             for node in walk(held[0])
                             if hasattr(node, "metrics"))
                      for n in ("numRetries", "numSplitRetries",
                                "spillBytes", "spillRunBytes")}
            kinds = [e["kind"] for e in prof.events]
            ev = {"oom_retry": kinds.count("oom_retry"),
                  "oom_split_retry": kinds.count("oom_split_retry")}
            require(ev["oom_retry"] == metric["numRetries"]
                    and ev["oom_split_retry"] == metric["numSplitRetries"],
                    f"17b {leg}: events {ev} against metrics {metric}")
            require(ev["oom_retry"] + ev["oom_split_retry"] > 0,
                    f"17b {leg}: no retry under injection: {ev}")
            # the spill edge three ways: the device store's device->*
            # hops against the spill callback and the plan's spillBytes,
            # and the out-of-core runs' hops against the run accounting
            # and spillRunBytes; this leg's must be above 0
            sites = prof.movement["edges"]["spill"]["sites"]
            hops = sum(v["bytes"] for s, v in sites.items()
                       if s.startswith("device->"))
            spilled = env.spill_callback.bytes_spilled - cb0
            runs = sum(v["bytes"] for s, v in sites.items()
                       if s.startswith(OC.SITE_PREFIX))
            require(hops == spilled == metric["spillBytes"],
                    f"17b {leg}: spill hops {hops}, callback {spilled}, "
                    f"spillBytes {metric['spillBytes']}")
            require(runs == OC.run_bytes_spilled()
                    == metric["spillRunBytes"],
                    f"17b {leg}: run hops {runs}, run accounting "
                    f"{OC.run_bytes_spilled()}, spillRunBytes "
                    f"{metric['spillRunBytes']}")
            require((runs if oocore else hops) > 0,
                    f"17b {leg}: nothing of this leg spilled: sites "
                    f"{sorted(sites)}")
            print(f"profile 17b q3 {sf_of(tables)} over "
                  f"{SHUFFLE_EXECUTORS} executors, out-of-core lanes "
                  f"{'on' if oocore else 'off'}, under budget {budget} "
                  f"bytes (1/{share} of the peak) and oomRate 0.05: "
                  f"collect {sec['collect']:.3f} s, rel err {rel:.3g}; "
                  f"events {ev} = metrics (numRetries "
                  f"{metric['numRetries']:g}, numSplitRetries "
                  f"{metric['numSplitRetries']:g}); spill device->* hops "
                  f"{hops} = callback {spilled} = spillBytes "
                  f"{metric['spillBytes']:g} bytes; out-of-core hops "
                  f"{runs} = run accounting = spillRunBytes "
                  f"{metric['spillRunBytes']:g} bytes; sites "
                  f"{sorted(sites)}", flush=True)
            out["17b"][leg] = {**info, "budget": budget, "events": ev,
                               "metrics": metric, "spill_hops": hops,
                               "run_hops": runs,
                               "collect_s": sec["collect"]}
            del df, sub, held, prof
        finally:
            TpuShuffleManager.close_all()
            ResourceEnv.shutdown()
    part_done("17b (Q3 over four executors under budgets and OOM "
              "injection, the out-of-core lanes on and off, profiled)",
              t_part)

    # 17d: two streams over the files (Q1 and Q3, and Q5), the sampler on
    t_part = time.perf_counter()
    mark = telem.utilization_counts()
    streams = throughput_test(torch, dev, tables, gold, 2, GW, K,
                              orders=PROFILE_STREAMS, extra=PROFILE_KEYS)
    summary = telem.utilization_summary(baseline=mark)
    total = sum(v for k, v in summary.items() if k != "samples")
    require(summary["samples"] > 0 and 99.0 <= total <= 101.0,
            f"17d: cause shares {summary}")
    text = T.prometheus_text()
    samples = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            samples[name] = float(val)
    require(samples.get("tpu_rapids_hbm_budget_bytes", 0) > 0,
            "17d: the Prometheus text has no device budget")
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{telem.http_port}/metrics", timeout=10).read()
    require(b"tpu_rapids_utilization_samples_total" in body,
            "17d: the HTTP endpoint did not serve the registry")
    slow = telem.slow_query_log()
    print(f"profile 17d two streams {PROFILE_STREAMS}: wall "
          f"{streams['wall']:.3f} s; cause shares {summary} (sum "
          f"{total:.1f}%); {len(samples)} Prometheus samples parsed; "
          f"/metrics on 127.0.0.1:{telem.http_port} served {len(body)} "
          f"bytes; slow-query log {[(e['count'], e['p50_ms'], e['top_idle_cause']) for e in slow]}",
          flush=True)
    out["17d"] = {"wall_s": streams["wall"], "causes": summary,
                  "prometheus_samples": len(samples),
                  "slow_queries": len(slow)}
    part_done("17d (two streams, the sampler, Prometheus)", t_part)

    # every part's launches, and the event log
    out["launches"]["17"] = {k: v - launches0[k]
                             for k, v in launch_counts(GW, K).items()}
    recs = [json.loads(ln) for ln in
            (PROFILE_DIR / "events.jsonl").read_text().splitlines()]
    snaps = [r for r in recs if r.get("kind") == P.EV_TELEMETRY_SNAPSHOT]
    events = [r for r in recs if r.get("kind") != P.EV_TELEMETRY_SNAPSHOT]
    require(events and all("query_id" in r and r.get("kind") in
                           P.EVENT_KINDS for r in events),
            "the event log is not JSONL of the queries' events")
    print(f"profile event log: {len(events)} records of "
          f"{len({r['query_id'] for r in events})} queries, kinds "
          f"{sorted({r['kind'] for r in events})}, and {len(snaps)} "
          f"telemetry snapshots", flush=True)
    T.stop()
    KP.disable()
    RS.disable()
    P.clear_history()

    # 17e's second half: Q5 unprofiled after 17a-d, twice (a one-time
    # cost of the first run after shows in the first alone); nothing of
    # the layer may stay on: no telemetry instance or thread, kernel
    # attribution and residency tracking off
    t_part = time.perf_counter()
    alive = sorted(t.name for t in threading.enumerate())
    require(T.live() is None and not KP.enabled() and not RS.enabled()
            and not set(TELEMETRY_THREADS) & set(alive),
            f"17e: the observability layer stayed on: telemetry "
            f"{T.live()}, kernel attribution {KP.enabled()}, residency "
            f"{RS.enabled()}, threads {alive}")
    print(f"profile 17e: telemetry, kernel attribution and residency "
          f"tracking off; threads {alive}", flush=True)
    out["17e_after"] = [q5_unprofiled(f"17e after ({i})")[0]
                        for i in (1, 2)]
    part_done("17e (after)", t_part)
    if keep:
        shutil.copytree(PROFILE_DIR, keep, dirs_exist_ok=True)
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    # 17a's catalog gate, raised once the other parts have run
    require(not gaps, f"17a: past {CATALOG_RTOL:.0%}: {gaps}")
    return out


# -- phase 18: the UDF layer, the plugin, the shims, the audit, the export --
#: TPCx-BB at SF1: TPC-DS SF1's store_sales rows (TPC-DS Table 3-2);
#: gen_tables draws scale // 2 product reviews
UDF_SCALE = 2_880_404
#: the daemon's worker processes in 18b
UDF_WORKERS = 2
#: the six pandas execs, each off by default
PANDAS_EXECS = ("CpuArrowEvalPython", "CpuMapInPandas",
                "CpuFlatMapGroupsInPandas", "CpuAggregateInPandas",
                "CpuWindowInPandas", "CpuFlatMapCoGroupsInPandas")
UDF_KEYS = ("l_returnflag", "l_linestatus")
#: 18b's pid file of the worker it kills (git-ignored, removed after)
UDF_DIR = Path(__file__).resolve().parent / ".udf_smoke"


def expr_kinds(e) -> list:
    """The class names of an expression tree, in pre-order."""
    out = [type(e).__name__]
    for c in e.children():
        out += expr_kinds(c)
    return out


#: the tables q18 and q27 read
UDF_TABLES = ("date_dim", "store_sales", "product_reviews")


def udf_tables(seed: int, scale: int) -> tuple:
    """In a spawned process: workload_tables(seed, scale)'s tables of
    UDF_TABLES, and the seconds the whole draw took."""
    t0 = time.perf_counter()
    tables = workload_tables(seed, scale)
    return {k: tables[k] for k in UDF_TABLES}, time.perf_counter() - t0


def udf_queries_part(torch, dev, tables_future, GW, K) -> dict:
    """18a: TPCx-BB q18 and q27 at SF1 as a user submits them, with the
    UDF compiler on and test.enabled (no CPU node), against the same
    plans with the compiler off, where the UDF's project is a CPU island
    that row-applies the Python function.  `tables_future` gives the
    tables (udf_tables, drawn in a process of its own while 18b and 18c
    run)."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.models import tpcds_bench as DB
    from spark_rapids_tpu_torch.models import tpcxbb as X
    from spark_rapids_tpu_torch.plan.nodes import CpuNode
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    from spark_rapids_tpu_torch.udf import compile_expression
    t0 = time.perf_counter()
    tables, draw_s = tables_future.result()
    n_ss, n_pr = len(tables["store_sales"]), len(tables["product_reviews"])
    require(n_ss == UDF_SCALE and n_pr == UDF_SCALE // 2,
            f"18a: {n_ss} store_sales and {n_pr} review rows, not SF1's")
    print(f"18a data: TPCx-BB at SF1, {n_ss} store_sales rows, {n_pr} "
          f"product reviews, drawn in {draw_s:.1f} s in a process of its "
          f"own, waited for {time.perf_counter() - t0:.1f} s", flush=True)
    on = tpch_conf(0)
    off = tpch_conf(0, **{C.UDF_COMPILER_ENABLED.key: False,
                          C.TEST_ALLOWED_NONGPU.key: "CpuProject"})
    runs: dict = {}
    for q, udf in (("q18", X.review_sentiment), ("q27", X.mentions_aspect)):
        compiled = compile_expression(udf(col("pr_content")))
        kinds = expr_kinds(compiled)
        require(kinds[0] == "Cast" and "Contains" in kinds
                and "PythonUDF" not in kinds and "StringLocate" not in kinds,
                f"18a {q}: the UDF compiled to {compiled!r}")
        print(f"18a {q}: {udf.__name__} compiles to {compiled!r}",
              flush=True)
        frames = {}
        for label, conf in (("compiled", on), ("fallback", off)):
            def make(conf=conf, q=q):
                return accelerate(X.QUERIES[q](
                    X.sources(tables, DB.SF10_PARTITIONS), lambda p: None),
                    conf, device=dev)
            df, plan, info = run_plan(torch, dev, GW, K, make,
                                      lambda p, conf=conf: collect(p, conf))
            islands = [type(n).__name__ for n in walk(plan)
                       if isinstance(n, CpuNode)]
            require(islands == [] if label == "compiled"
                    else "CpuProject" in islands,
                    f"18a {q} {label}: CPU nodes {islands}")
            require(len(df) > 0, f"18a {q} {label}: empty result")
            del plan
            frames[label] = df
            runs[f"18a {q} {label}"] = info
            print(f"18a {q} {label} at SF1: accelerate "
                  f"{info['accelerate_s']:.3f} s, collect "
                  f"{info['collect_s']:.3f} s, {len(df)} rows, plan runs "
                  f"{info['runs']}, peak device memory "
                  f"{info['peak'] / 2**30:.2f} GiB, launches "
                  f"{info['launches']}", flush=True)
        rel = same_frame(frames["fallback"], frames["compiled"], 1e-3,
                         f"18a {q}")
        print(f"18a {q}: the compiled result equals the row-applied UDF's "
              f"(keys, counts and order exact, max rel err {rel:.3g})",
              flush=True)
    del tables
    return runs


def _disc_price(p, d):
    """18b's vectorized UDF (it runs in a daemon worker)."""
    return p * (1.0 - d)


def _map_disc(frames):
    import pandas as pd
    for f in frames:
        yield pd.DataFrame({
            "l_returnflag": f["l_returnflag"],
            "l_linestatus": f["l_linestatus"],
            "disc_price": f["l_extendedprice"] * (1.0 - f["l_discount"])})


def _group_summary(g):
    import pandas as pd
    return pd.DataFrame({
        "l_returnflag": g["l_returnflag"].iloc[:1].tolist(),
        "l_linestatus": g["l_linestatus"].iloc[:1].tolist(),
        "n": [len(g)], "qty": [float(g["l_quantity"].sum())]})


def _cogroup(lg, rg):
    import pandas as pd
    first = lg.iloc[:1] if len(lg) else rg.iloc[:1].rename(columns={
        "w_flag": "l_returnflag", "w_status": "l_linestatus"})
    return pd.DataFrame({
        "l_returnflag": first["l_returnflag"].tolist(),
        "l_linestatus": first["l_linestatus"].tolist(),
        "n": [len(lg)],
        "w": [float(rg["w"].sum()) if len(rg) else None]})


def _worker_probe(x):
    """The worker's pid, its CUDA_VISIBLE_DEVICES and whether it has
    imported torch, after a pause that makes two probes overlap."""
    import os
    import sys
    import time as t
    import pandas as pd
    t.sleep(0.5)
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    return pd.Series([f"{os.getpid()}|{env!r}|{int('torch' in sys.modules)}"]
                     * len(x), index=x.index)


def _stalling_udf(path: str):
    """A UDF that writes its worker's pid to `path`, then stalls until
    the worker is killed."""
    def stall(x):
        import os
        import time as t
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        t.sleep(120)
        return x
    return stall


def compute_app_pids() -> list:
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [int(s) for s in out.split() if s.strip().isdigit()]


def udf_lineitem(lineitem) -> tuple:
    """18b's lineitem: the columns its execs read, 16 partitions;
    (partitions, schema)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.data_util import split_partitions
    cols = list(UDF_KEYS) + ["l_quantity", "l_extendedprice", "l_discount"]
    li = lineitem[cols]
    schema = T.Schema(tuple(TD.SCHEMAS["lineitem"].field(c) for c in cols))
    return split_partitions(li, 16), schema


def udf_exec_plans(parts: list, schema) -> dict:
    """18b's six plans over `parts`, one per pandas exec: name ->
    (build, rtol).  ArrowEvalPython, MapInPandas and WindowInPandas
    give a row per input row, so an aggregate on the card sums their
    output by the keys (its f32 sums rtol 1e-3); the other three give a
    row per key, summed on the host (exact)."""
    import pandas as pd

    from spark_rapids_tpu_torch import pyudf as P
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs.aggregates import Count, Sum
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan import nodes as N
    keys = [col(k) for k in UDF_KEYS]
    weights = pd.DataFrame({"w_flag": ["A", "N", "N", "R", "Z"],
                            "w_status": ["F", "F", "O", "F", "O"],
                            "w": [1.0, 2.0, 3.0, 4.0, 5.0]})

    def source(*cols):
        # the project narrows the upload to the columns the exec reads
        return N.CpuProject(keys + [col(c) for c in cols],
                            N.CpuSource(parts, schema))

    def per_key(node, name):
        return N.CpuAggregate(keys, [Sum(col(name)).alias(name),
                                     Count(None).alias("n")], node)

    s = T.STRING
    per_group = (("l_returnflag", s), ("l_linestatus", s), ("n", T.INT64))
    return {
        "ArrowEvalPythonExec": (lambda: per_key(P.CpuArrowEvalPython(
            [P.PandasUdfSpec("disc_price", _disc_price, T.FLOAT64,
                             (col("l_extendedprice"), col("l_discount")))],
            source("l_extendedprice", "l_discount")), "disc_price"), 1e-3),
        "MapInPandasExec": (lambda: per_key(P.CpuMapInPandas(
            _map_disc, T.Schema.of(("l_returnflag", s), ("l_linestatus", s),
                                   ("disc_price", T.FLOAT64)),
            source("l_extendedprice", "l_discount")), "disc_price"), 1e-3),
        "FlatMapGroupsInPandasExec": (lambda: P.CpuFlatMapGroupsInPandas(
            list(UDF_KEYS), _group_summary,
            T.Schema.of(*per_group, ("qty", T.FLOAT64)),
            source("l_quantity")), 0.0),
        "AggregateInPandasExec": (lambda: P.CpuAggregateInPandas(
            list(UDF_KEYS), [P.PandasUdfSpec(
                "mean_disc", lambda d: float(d.mean()), T.FLOAT64,
                (col("l_discount"),))], source("l_discount")), 0.0),
        "WindowInPandasExec": (lambda: per_key(P.CpuWindowInPandas(
            list(UDF_KEYS), [P.PandasUdfSpec(
                "max_qty", lambda q: float(q.max()), T.FLOAT64,
                (col("l_quantity"),))], source("l_quantity")), "max_qty"),
            1e-3),
        "FlatMapCoGroupsInPandasExec": (
            lambda: P.CpuFlatMapCoGroupsInPandas(
                list(UDF_KEYS), ["w_flag", "w_status"], _cogroup,
                T.Schema.of(*per_group, ("w", T.FLOAT64)), source(),
                N.CpuSource.from_pandas(weights)), 0.0),
    }


_UDF_WORKER: dict = {}


def udf_cpu_init(seed: int, sf: float) -> None:
    """18b's CPU worker: the same SF lineitem from the same seed."""
    import torch
    torch.set_num_threads(2)
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    tables, _ = TB.sf10_tables(seed, sf=sf)
    _UDF_WORKER["parts"], _UDF_WORKER["schema"] = udf_lineitem(
        tables["lineitem"])


def udf_cpu_result(name: str) -> tuple:
    """In 18b's CPU worker: exec `name`'s plan on the CPU engine; (the
    result, seconds, the lineitem's rows and price sum)."""
    t0 = time.perf_counter()
    parts = _UDF_WORKER["parts"]
    df = udf_exec_plans(parts, _UDF_WORKER["schema"])[name][0]().collect()
    return (df, time.perf_counter() - t0, sum(len(p) for p in parts),
            float(sum(p["l_extendedprice"].sum() for p in parts)))


def udf_execs_part(torch, dev, tables: dict, spec: tuple, GW, K) -> dict:
    """18b: the six pandas execs through the planner over the lineitem
    of `spec` (seed, sf), the vectorized UDF in the daemon's UDF_WORKERS
    worker processes, each against the CPU engine (which a spawned CPU
    process computes meanwhile, over the same lineitem made from the
    same seed); two workers at once, none holding a CUDA context; a
    worker killed in the middle of a batch."""
    import multiprocessing
    import os
    import shutil
    import signal
    import threading
    from concurrent.futures import ProcessPoolExecutor

    import pandas as pd

    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import pyudf as P
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    from spark_rapids_tpu_torch.pyudf import daemon as D
    conf = tpch_conf(0, **{f"spark.rapids.sql.exec.{e}": True
                           for e in PANDAS_EXECS},
                     **{C.PYTHON_DAEMON_ENABLED.key: True,
                        C.PYTHON_CONCURRENT_WORKERS.key: UDF_WORKERS})
    D.PythonWorkerPool.reset()
    parts, schema = udf_lineitem(tables["lineitem"])
    rows = sum(len(p) for p in parts)
    price = float(sum(p["l_extendedprice"].sum() for p in parts))
    plans = udf_exec_plans(parts, schema)

    def by_keys(df):
        return df.sort_values(list(UDF_KEYS), ignore_index=True)

    out: dict = {"runs": {}, "seconds": {}}
    with ProcessPoolExecutor(1, multiprocessing.get_context("spawn"),
                             initializer=udf_cpu_init,
                             initargs=spec) as cpu_pool:
        cpu = {name: cpu_pool.submit(udf_cpu_result, name)
               for name in plans}
        for name, (build, rtol) in plans.items():
            df, plan, info = run_plan(
                torch, dev, GW, K,
                lambda build=build: accelerate(build(), conf, device=dev),
                lambda p: collect(p, conf))
            execs = [type(n).__name__ for n in walk(plan)]
            require(isinstance(plan, TpuExec) and name in execs,
                    f"18b {name}: not in the plan's device tree: {execs}")
            del plan
            want, cpu_s, cpu_rows, cpu_price = cpu[name].result()
            require(cpu_rows == rows and cpu_price == price,
                    f"18b: the CPU worker's lineitem ({cpu_rows} rows) is "
                    f"not this one's ({rows})")
            rel = same_frame(by_keys(want), by_keys(df), rtol,
                             f"18b {name}")
            out["runs"][f"18b {name}"] = info
            out["seconds"][name] = {"accelerate": info["accelerate_s"],
                                    "collect": info["collect_s"],
                                    "cpu": cpu_s}
            print(f"18b {name} over lineitem ({rows} rows): accelerate "
                  f"{info['accelerate_s']:.3f} s, collect "
                  f"{info['collect_s']:.3f} s (CPU engine {cpu_s:.3f} s, "
                  f"in a process of its own), {len(df)} rows equal to the "
                  f"CPU engine's (max rel err {rel:.3g}), launches "
                  f"{info['launches']}", flush=True)

    # two probes at once take both workers; neither may hold a CUDA context
    probe = P.CpuArrowEvalPython(
        [P.PandasUdfSpec("probe", _worker_probe, T.STRING, (col("x"),))],
        N.CpuSource.from_pandas(pd.DataFrame({"x": np.arange(64)})))

    def run_probe():
        return collect(accelerate(probe, conf, device=dev), conf)

    answers: list = []
    threads = [threading.Thread(target=lambda: answers.append(run_probe()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    require(len(answers) == 2, "18b: a probe query failed")
    seen = {a["probe"].iloc[0] for a in answers}
    pids = sorted(int(v.split("|")[0]) for v in seen)
    require(len(pids) == UDF_WORKERS and all(
        v.split("|")[1:] == ["''", "0"] for v in seen),
        f"18b: worker answers {seen}")
    apps = compute_app_pids()
    require(not set(pids) & set(apps),
            f"18b: a UDF worker holds a CUDA context: {pids} in {apps}")
    listed = "listed" if os.getpid() in apps else "not listed"
    print(f"18b: {UDF_WORKERS} workers at once, pids {pids}, each with "
          f"CUDA_VISIBLE_DEVICES='' and no torch imported; nvidia-smi's "
          f"compute apps {apps} (this process, {os.getpid()}, {listed})",
          flush=True)

    # a worker killed in the middle of a batch fails the query; the pool's
    # next query runs on a fresh worker
    shutil.rmtree(UDF_DIR, ignore_errors=True)
    UDF_DIR.mkdir()
    pid_file = UDF_DIR / "worker.pid"
    stall = P.CpuArrowEvalPython(
        [P.PandasUdfSpec("x2", _stalling_udf(str(pid_file)), T.INT64,
                         (col("x"),))],
        N.CpuSource.from_pandas(pd.DataFrame({"x": np.arange(64)})))
    killed: list = []

    def killer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            text = pid_file.read_text() if pid_file.exists() else ""
            if text:
                os.kill(int(text), signal.SIGKILL)
                killed.append(int(text))
                return
            time.sleep(0.05)

    kt = threading.Thread(target=killer)
    kt.start()
    t0 = time.perf_counter()
    try:
        collect(accelerate(stall, conf, device=dev), conf)
        crash = None
    except D.WorkerCrash as e:
        crash = e
    crash_s = time.perf_counter() - t0
    kt.join()
    shutil.rmtree(UDF_DIR, ignore_errors=True)
    require(crash is not None and killed,
            f"18b: the killed worker's query did not fail with WorkerCrash "
            f"(killed {killed})")
    t0 = time.perf_counter()
    after = run_probe()["probe"]
    next_s = time.perf_counter() - t0
    fresh = int(after.iloc[0].split("|")[0])
    require(len(after) == 64 and fresh != killed[0]
            and after.iloc[0].split("|")[1:] == ["''", "0"],
            f"18b: the query after the kill: {after.iloc[0]}")
    pids.append(fresh)
    print(f"18b: worker {killed[0]} killed in the middle of a batch: the "
          f"query failed with WorkerCrash after {crash_s:.2f} s ({crash}); "
          f"the pool's next query ran on worker {fresh} in {next_s:.3f} s",
          flush=True)
    D.PythonWorkerPool.reset()
    left = [p for p in pids if Path(f"/proc/{p}").exists()]
    require(not left, f"18b: workers {left} outlived the pool")
    return out


def regression_steps(torch, x, y, steps: int) -> tuple:
    """`steps` SGD steps of a torch.nn.Linear from `x` to `y` on their
    device: (the losses, the model's device)."""
    torch.manual_seed(0)
    model = torch.nn.Linear(x.shape[1], 1).to(x.device)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.item()))
    return losses, model.weight.device


def plugin_part(torch, dev, tables: dict, gold: dict, GW, K,
                cases) -> dict:
    """18c: the API audit of the five versions, their shuffle managers,
    then plugin.activate() on the card: planner Q1 under the session's
    rules, Q3 through the spark301 RapidsShuffleManager over four
    executors, Q6's input exported as tensors on the card and a
    torch.nn.Linear regression over them; deactivate() gives the device
    memory back."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import plugin as P
    from spark_rapids_tpu_torch.api_validation import audit_all_versions
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    from spark_rapids_tpu_torch.ml import ColumnarRdd
    from spark_rapids_tpu_torch.models import tpch_bench as TB
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import collect
    from spark_rapids_tpu_torch.shims import ALL_SHIMS, spark301
    from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager
    grouped_case, window_case = cases
    runs: dict = {}
    out: dict = {"runs": runs}
    t0 = time.perf_counter()
    reports = audit_all_versions()
    for r in reports:
        require(r.ok(), f"18c: the API audit found problems:\n{r}")
    print(f"18c: API audit of {len(reports)} versions clean ("
          + ", ".join(f"{r.version} {r.checked} checks" for r in reports)
          + f", {time.perf_counter() - t0:.2f} s)", flush=True)
    for p in ALL_SHIMS:
        shims = p()
        cls = shims.shuffle_manager_type()
        require(issubclass(cls, TpuShuffleManager)
                and shims.shuffle_manager_class().endswith(
                    f"{cls.SPARK_VERSION}.RapidsShuffleManager"),
                f"18c: {shims.shuffle_manager_class()} does not resolve")
    print("18c: " + ", ".join(p().shuffle_manager_class()
                              for p in ALL_SHIMS) + " resolve", flush=True)
    TpuShuffleManager.close_all()
    gc.collect()
    torch.cuda.synchronize(dev)
    # the process's first regression step (its matmuls, and their
    # backward on autograd's own thread) makes cuBLAS's and cuBLASLt's
    # workspaces, which live as long as the process: taken before the
    # baseline, the check below sees only what the session keeps
    warm0 = torch.cuda.memory_allocated(dev)
    regression_steps(torch, torch.rand(64, 2, device=dev),
                     torch.rand(64, 1, device=dev), 1)
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    print(f"18c: the process's first regression step left cuBLAS "
          f"workspaces of {before - warm0} bytes", flush=True)
    settings = {**TB.BENCH_CONF, C.TEST_ENABLED.key: True,
                C.EXPORT_COLUMNAR_RDD.key: True}
    t0 = time.perf_counter()
    conf = P.activate(settings, device=dev)
    activate_s = time.perf_counter() - t0
    try:
        env = ResourceEnv.peek()
        require(env is not None and env.device == dev,
                "18c: activate() did not bring the environment up on the "
                "card")
        rules = P.active_extensions().columnar_rules[0](conf)
        for q, check in ((1, lambda df: check_q1(df, gold[1], "18c q1")),
                         (6, lambda df: check_q6(df, gold[6], "18c q6"))):
            df, plan, info = run_plan(
                torch, dev, GW, K, lambda q=q: rules.pre_columnar_transitions(
                    QUERIES[q](TD.sources(tables, TB.SF10_PARTITIONS),
                               None)), lambda p: collect(p))
            del plan
            rel = check(df)
            runs[f"18c q{q} (plugin)"] = info
            out[f"q{q}"] = df
            print(f"18c q{q} under plugin.activate(): accelerate "
                  f"{info['accelerate_s']:.3f} s, collect "
                  f"{info['collect_s']:.3f} s, rel err {rel:.3g} against "
                  f"the golden, launches {info['launches']}", flush=True)
        # the recorded widest calls are checked, and their copies freed,
        # before the memory reading
        out["cases"] = plan_cases("18c", runs, window_case, grouped_case)
        out["q3"] = shuffle_query(
            torch, dev, 3, tables, gold,
            shuffle_conf(3, **{C.SPARK_VERSION.key: "3.0.1"}),
            "18c q3 (spark301)", GW, K, cases)
        managers = list(TpuShuffleManager._managers.values())
        require(len(managers) == SHUFFLE_EXECUTORS and all(
            type(m) is spark301.RapidsShuffleManager for m in managers),
            f"18c: q3's executors are {[type(m) for m in managers]}")
        TpuShuffleManager.close_all()
        print(f"18c q3: {len(managers)} executors, each a "
              f"spark301.RapidsShuffleManager", flush=True)
        # Q6's input, exported
        t0 = time.perf_counter()
        q6_input = N.CpuProject(
            [col("l_quantity"), col("l_extendedprice"), col("l_discount")],
            QUERIES[6](TD.sources(tables, TB.SF10_PARTITIONS), None).child)
        arrays = ColumnarRdd.collect_arrays(q6_input, conf, device=dev)
        export_s = time.perf_counter() - t0
        require(all(a.device == dev for a in arrays.values()),
                f"18c: exported tensors are not on {dev}")
        revenue = float((arrays["l_extendedprice"]
                         * arrays["l_discount"]).sum().item())
        rel = abs(revenue - gold[6]) / abs(gold[6])
        require(rel <= 1e-9, f"18c: exported revenue rel err {rel}")
        rel_collect = abs(revenue - float(out.pop("q6")["revenue"][0])) \
            / abs(revenue)
        require(rel_collect <= 1e-3,
                f"18c: exported revenue against the collect {rel_collect}")
        # a few steps of a linear regression on the card: price from
        # quantity and discount, standardized
        x = torch.stack([arrays["l_quantity"], arrays["l_discount"]],
                        1).float()
        y = arrays["l_extendedprice"].float().unsqueeze(1)
        x = (x - x.mean(0)) / x.std(0)
        y = (y - y.mean()) / y.std()
        t0 = time.perf_counter()
        losses, on_dev = regression_steps(torch, x, y, 20)
        train_s = time.perf_counter() - t0
        require(on_dev == dev and losses[-1] < losses[0],
                f"18c: the regression did not learn: {losses}")
        n_rows = arrays["l_discount"].numel()
        print(f"18c: Q6's input exported in {export_s:.3f} s as "
              f"{len(arrays)} tensors on {dev} of {n_rows} "
              f"rows; their revenue {revenue!r} equals the golden (rel err "
              f"{rel:.3g}) and the collect ({rel_collect:.3g}); 20 SGD "
              f"steps of torch.nn.Linear(2, 1) on the card in {train_s:.3f}"
              f" s, loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
        del arrays, x, y
    finally:
        P.deactivate()
    require(ResourceEnv.peek() is None, "18c: deactivate() left the "
            "environment up")
    out["memory"] = settled_memory(torch, dev, GW, K, before, state0,
                                   "18c plugin.deactivate()")
    out["activate_s"] = activate_s
    return out


def udf_phase(torch, dev, tables: dict, gold: dict, spec: tuple, GW, K,
              cases) -> dict:
    """Phase 18 over `tables` (the TPC-H tables of `spec`, (seed, sf)):
    18a, 18b and 18c, each part's wall printed; the widest call of each
    kernel in each of its plans against its twin."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    grouped_case, window_case = cases
    out: dict = {}
    runs: dict = {}
    with ProcessPoolExecutor(1, multiprocessing.get_context(
            "spawn")) as draw:
        # 18a's tables are drawn meanwhile
        tables_future = draw.submit(udf_tables, spec[0], UDF_SCALE)
        t_part = time.perf_counter()
        execs = udf_execs_part(torch, dev, tables, spec, GW, K)
        runs.update(execs["runs"])
        print(f"phase 18b: {time.perf_counter() - t_part:.1f} s wall",
              flush=True)
        t_part = time.perf_counter()
        plugin = plugin_part(torch, dev, tables, gold, GW, K, cases)
        print(f"phase 18c: {time.perf_counter() - t_part:.1f} s wall",
              flush=True)
        t_part = time.perf_counter()
        runs.update(udf_queries_part(torch, dev, tables_future, GW, K))
        print(f"phase 18a: {time.perf_counter() - t_part:.1f} s wall",
              flush=True)
    out["launches"] = {label: info["launches"] for label, info in
                       {**runs, **plugin["runs"]}.items()}
    out["launches"]["18c q3 (spark301)"] = plugin["q3"]["launches"]
    out["cases"] = plan_cases("18", runs, window_case, grouped_case)
    for name, cases18c in plugin["cases"].items():
        out["cases"][name] += cases18c
    for name, case in plugin["q3"].get("cases", {}).items():
        out["cases"][name].append({**case, "plan": "18c q3 (spark301)"})
    out["execs_seconds"] = execs["seconds"]
    return out


# ---------------------------------------------------------------------------
# phase 19: distribution, the device mesh
MESH_SLOTS = 4
MESH_QUERIES = (1, 3, 5, 9)


def mesh_conf(q: int):
    """The TPC bench conf with test.enabled, the SPMD lane on and the
    query profiled, so its movement ledger carries the collective edge."""
    from spark_rapids_tpu_torch import config as C
    return tpch_conf(q, **{C.SPMD_ENABLED.key: True,
                           C.PROFILE_ENABLED.key: True})


def mesh_query(torch, dev, mesh, q: int, tables: dict, gold: dict, GW, K,
               cases) -> dict:
    """One TPC-H query as a user submits it with `mesh` active, over
    MESH_SLOTS partitions: the result against its golden, accelerate and
    collect apart, the mesh exchanges and gang dispatches it ran, the
    collective edge's bytes, the launches, the widest call of each
    kernel held against its twin, peak device memory; device memory back
    to its value before the query once the plan is dropped."""
    import threading

    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import spmd as SP
    from spark_rapids_tpu_torch.models import tpch_data as TD
    from spark_rapids_tpu_torch.parallel.mesh import active_mesh
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.utils import profile as P
    grouped_case, window_case = cases
    label = f"19a q{q}"
    gc.collect()
    torch.cuda.synchronize(dev)
    state0 = kernel_state_bytes(GW, K)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    launches0 = launch_counts(GW, K)
    ShuffleExchangeExec._MESH_EXCHANGES_RUN = 0
    splits0 = ShuffleExchangeExec._OVERSIZED_SPLITS
    SP.reset_spmd_stats()
    wcalls, gcalls, AGG.window_group_sums, AGG.grouped_sum = \
        threadsafe_recorders(GW, K, threading.Lock())
    try:
        with active_mesh(mesh):
            df, sub, sec = submit_tpch(
                torch, dev, q, tables, mesh_conf(q), label,
                source=TD.sources(tables, MESH_SLOTS))
    finally:
        AGG.window_group_sums = GW.window_group_sums
        AGG.grouped_sum = K.grouped_sum
    launches = {k: v - launches0[k] for k, v in launch_counts(GW, K).items()}
    rel = check_tpch(q, df, gold, sub)
    gang = SP.spmd_stats()
    exchanges = ShuffleExchangeExec._MESH_EXCHANGES_RUN
    prof = P.last_profile()
    edge = (prof.movement or {}).get("edges", {}).get("collective", {})
    sites = {k: int(v["bytes"]) for k, v in edge.get("sites", {}).items()}
    del prof
    out = {**sec, "rel": rel, "rows": len(df), "launches": launches,
           "mesh_exchanges": exchanges,
           "oversized_splits": ShuffleExchangeExec._OVERSIZED_SPLITS
           - splits0, "gang": gang,
           "collective_bytes": int(edge.get("bytes", 0)),
           "collective_sites": sites,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"mesh {label} {sf_of(tables)} over {mesh.size} slots: accelerate "
          f"{sec['accelerate']:.3f} s, collect {sec['collect']:.3f} s, "
          f"{len(df)} rows, rel err {rel:.3g}; mesh exchanges {exchanges} "
          f"({out['oversized_splits']} oversized batches cut), gang "
          f"dispatches {gang['gang_dispatches']} over "
          f"{gang['gang_batches']} batches in {gang['gang_slots']} slots, "
          f"deopts {gang['deopts']}; collective edge {out['collective_bytes']}"
          f" bytes {sites}; peak device memory {out['peak_gib']:.2f} GiB; "
          f"launches {launches}", flush=True)
    if q != 1:
        require(exchanges > 0, f"{label}: no exchange took the mesh lane")
    require(gang["gang_dispatches"] > 0, f"{label}: no gang dispatched")
    require(out["collective_bytes"] > 0,
            f"{label}: nothing on the collective edge")
    out["cases"] = {}
    if wcalls:
        gid, vals, cap = wcalls
        case = window_case(gid, vals, cap)
        case.update(query=q, launches=launches["window_group_sums"],
                    shape=f"{label} widest call: capacity {gid.numel()}, "
                    f"out_cap {cap}, M={len(vals)}")
        print(kernel_text("window_group_sums", case), flush=True)
        out["cases"]["window_group_sums"] = case
        del gid, vals
    if gcalls:
        keys, gvals, nrows, groups = gcalls
        case = grouped_case(keys, gvals, nrows, groups, None)
        case.update(query=q, launches=launches["grouped_sum"],
                    shape=f"{label} widest call: capacity {keys.numel()}, "
                    f"G={groups}, M={len(gvals)}, tier {case['tier']}")
        print(kernel_text("grouped_sum", case), flush=True)
        out["cases"]["grouped_sum"] = case
        del keys, gvals
    for name in ("window_group_sums", "grouped_sum"):
        require(not launches[name] or name in out["cases"],
                f"{label}: {name} launched but no call was recorded")
    del wcalls[:], gcalls[:], wcalls, gcalls, sub
    out["memory"] = settled_memory(torch, dev, GW, K, before, state0,
                                   f"mesh {label}")
    return out


def mesh_phase(torch, dev, tables: dict, gold: dict, GW, K, cases) -> dict:
    """Phase 19 (see the module docstring): 19a and 19b, each part's wall
    printed.  Returns each query's figures and the launches per part."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import graft_entry as GE
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    cards = torch.cuda.device_count()
    mesh = make_mesh(MESH_SLOTS, slots_per_device=-(-MESH_SLOTS // cards))
    where = ", ".join(f"{d} x{len(s)}" for d, s in mesh.groups)
    print(f"mesh: {mesh.size} slots over {len(mesh.groups)} of {cards} "
          f"card(s) ({where})"
          + ("; one card: no byte crossed an interconnect, the collective "
             "edge counts the lane's payload within the card" if
             len(mesh.groups) == 1 else ""), flush=True)
    out: dict = {"19a": {}, "launches": {}}
    t_part = time.perf_counter()
    for q in MESH_QUERIES:
        out["19a"][q] = mesh_query(torch, dev, mesh, q, tables, gold, GW, K,
                                   cases)
        out["launches"][f"19a q{q}"] = out["19a"][q]["launches"]
    print(f"phase 19a: {time.perf_counter() - t_part:.1f} s wall",
          flush=True)
    t_part = time.perf_counter()
    launches0 = launch_counts(GW, K)
    dry = GE.dryrun_multichip(MESH_SLOTS, device=dev)
    require(dry["grouped_sum_launches"] == MESH_SLOTS,
            f"19b dryrun: grouped_sum launched {dry['grouped_sum_launches']}"
            f" times, not once a slot")
    out["launches"]["19b dryrun"] = {
        k: v - launches0[k] for k, v in launch_counts(GW, K).items()}
    # entry()'s step on the card: the q1_fused kernel against the plain
    # torch step over the same batch
    launches0 = launch_counts(GW, K)
    with C.session(C.RapidsConf({C.PALLAS_Q1_ENABLED.key: True})):
        fn, args = GE.entry(device=dev)
        got = [t.cpu().numpy() for t in fn(*args)]
    out["launches"]["19b entry"] = {
        k: v - launches0[k] for k, v in launch_counts(GW, K).items()}
    fn, args = GE.entry(device=dev)
    want = [t.cpu().numpy() for t in fn(*args)]
    require(out["launches"]["19b entry"]["q1_fused"] >= 1,
            "19b entry: q1_fused never launched")
    for i in (0, 1, 7):
        require(np.array_equal(got[i], want[i]),
                f"19b entry: output {i} differs from the plain step")
    entry_rel = max(float(np.max(np.abs(got[i] - want[i])
                                 / np.maximum(np.abs(want[i]), 1.0)))
                    for i in range(2, 7))
    require(entry_rel <= 1e-5, f"19b entry rel err {entry_rel}")
    print(f"19b: dryrun_multichip({MESH_SLOTS}) {dry}; entry() step with "
          f"q1_fused against the plain step: keys and counts exact, max "
          f"rel err {entry_rel:.3g}; launches {out['launches']['19b dryrun']}"
          f" and {out['launches']['19b entry']}", flush=True)
    print(f"phase 19b: {time.perf_counter() - t_part:.1f} s wall",
          flush=True)
    out["dryrun"] = dry
    out["entry_rel"] = entry_rel
    return out


def kernel_cases(torch, dev, GW, K):
    """(grouped_case, window_case): a kernel's call on `dev` held
    against its plain twin, its second call's bits, and its times (the
    wrapper, the kernel alone, the twin and the library call), for
    phases 3 and 7-13.  The kernel alone: from torch.profiler with
    `profile` (phase 3's shapes), else from CUDA events queued behind a
    sleep kernel (every main-path call; the profiler records no device
    activity after phase 7)."""
    def grouped_case(keys, vals, nrows, n_groups, tier, reps=10,
                     profile=False):
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
        # a dictionary batch of counts alone (Q13's) has no measure
        err = (got_s - want_s).abs().max().item() if vals else 0.0
        rel = ((got_s - want_s).abs() / want_s.abs().clamp_min(1.0)
               ).max().item() if vals else 0.0
        require(rel <= 1e-4, f"grouped_sum vs plain rel err {rel}")
        m = len(vals)
        kept = ((keys >= 0) & (keys < n_groups)
                & (torch.arange(keys.numel(), device=dev) < nrows))
        n_kept = int(kept.sum().item())
        b_ms, b_by = bound(keys.numel() * 4 + n_kept * m * 4
                           + n_groups * (m + 1) * 4, n_kept * (m + 1))
        seg = torch.where(kept, keys, n_groups).to(torch.int64)
        lib_vals = torch.where(kept[:, None], torch.stack(vals, 1), 0.0) \
            if vals else torch.zeros((keys.numel(), 0), device=dev)

        def library():
            torch.zeros((n_groups + 1, m), device=dev).index_add_(
                0, seg, lib_vals)
            torch.bincount(seg, minlength=n_groups + 1)

        prof_ms = device_ms(torch, call, "grouped_sum", reps) \
            if profile else None
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

    def window_case(gid, vals, out_cap, reps=10, profile=False):
        def call():
            return GW.window_group_sums(gid, vals, out_cap=out_cap,
                                        capacity=gid.numel())

        before = GW.window_group_sums.launches
        got = call()
        require(GW.window_group_sums.launches
                == before + -(-len(vals) // K.MAX_MEASURES),
                "window_group_sums did not launch its kernel")
        same_bits((got,), (call(),), "window_group_sums")
        # the twin over float64 copies, rounded to f32: in f32 its
        # index_add_ adds with atomics in no fixed order, 2.3e-3 off over
        # one group of ~940,000 rows (a partitioned file's batch, 14a)
        want = GW.window_group_sums_plain(
            gid, [v.double() for v in vals], out_cap=out_cap).float()
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
        prof_ms = device_ms(torch, call, "window_group_sums", reps) \
            if profile else None
        ev_ms = event_ms(torch, call, reps)
        return {
            "max_abs_err": err, "max_rel_err": rel, "rtol": 1e-4,
            "ms": cuda_ms(torch, call, reps),
            "device_ms": ev_ms if prof_ms is None else prof_ms,
            "device_ms_by": "events" if prof_ms is None else "profiler",
            "event_ms": ev_ms,
            "plain_ms": cuda_ms(torch, lambda: GW.window_group_sums_plain(
                gid, vals, out_cap=out_cap), reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, lambda: torch.zeros(
                (out_cap + 1, m), device=dev).index_add_(0, seg, lib_vals),
                reps)}

    return grouped_case, window_case


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
    # a collection, automatic or ds_query's before each memory check,
    # traverses only the objects made since the last freeze: not the
    # modules, nor (frozen again before 13a) what earlier phases keep
    gc.freeze()
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

    grouped_case, window_case = kernel_cases(torch, dev, GW, K)

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
    gs = grouped_case(slot, q1_vals, TB.BATCH_CAP, 26, "A", 20, True)
    gs.update(name="grouped_sum", route="cuda",
              source="spark_rapids_tpu_torch/csrc/grouped_sum.cu",
              replaces="spark_rapids_tpu/ops/pallas_kernels.py:291",
              shape="2^23 rows, G=26, M=14")
    kernels["grouped_sum"] = gs
    g_rng = torch.Generator(device=dev).manual_seed(args.seed)
    wide_keys = torch.randint(0, 32769, (TB.BATCH_CAP,), generator=g_rng,
                              device=dev, dtype=torch.int32)
    gs_wide = grouped_case(wide_keys, q1_vals, TB.BATCH_CAP, 32769, "C", 5,
                           True)
    gs_wide["shape"] = "2^23 rows, G=32769, M=14"
    # a table past the lane-private tier: one table per warp
    mid_keys = torch.remainder(wide_keys, 300)
    gs_mid = grouped_case(mid_keys, q1_vals, TB.BATCH_CAP, 300, "B", 10, True)
    gs_mid["shape"] = "2^23 rows, G=300, M=14"

    # Q1's merge shape: 8 partials x 6 groups sorted into a 16384-row
    # batch, 17 measures (4 Sum x 2, 3 Average x 2, 1 Count, 2 limbs)
    merge_cap, live = 1 << 14, TB.N_BATCHES * 6
    gid = torch.clamp(torch.arange(merge_cap, device=dev) // TB.N_BATCHES,
                      max=5).to(torch.int32)
    row_live = torch.arange(merge_cap, device=dev) < live
    mvals = [torch.where(row_live, torch.rand(merge_cap, generator=g_rng,
                                              device=dev) * 1e6, 0.0)
             for _ in range(17)]
    wg = window_case(gid, mvals, merge_cap, 50, True)
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
    wg_big = window_case(big_gid, big_vals, 1 << 20, 10, True)
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
    wg_runs = window_case(run_gid, run_vals, 1 << 14, 10, True)
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

    # 14a. the same lineitem columns written as Parquet and read back
    io_a = io_scan_phase(torch, dev, planner, GW, K)
    del planner["frame"]
    io_runs = {i["label"]: i for i in io_a["queries"].values()}
    io_cases = plan_cases("14a", io_runs, window_case, grouped_case)
    lap("14a (Q1 and Q6 at SF10 over Parquet)")

    # 7. the join queries, with the earlier phases' device data freed
    del plan, fresh, batches, stacked, nums, step, b0, slot, keep0
    del q, p, d, t, dp64, val_cols, flag, g_rng, gid, row_live, iota
    del run_gid
    torch.cuda.empty_cache()
    from spark_rapids_tpu_torch.models import tpch_data as TD
    t0 = time.perf_counter()
    tables, arrays = TB.sf10_tables(args.seed, sf=JOIN_SF)
    print("join data: " + ", ".join(f"{k} {len(v)}" for k, v in
                                    tables.items())
          + f" rows, {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    gold = golden_joins(arrays, TD)
    gold_parts = golden_parts(arrays, tables["customer"], TD, TB)
    t1 = time.perf_counter()
    gold_rest = golden_rest(arrays, tables, TD, TB)
    print(f"float64 goldens: Q3-Q10 {t1 - t0:.1f} s, Q2 and Q11-Q22 "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    t0 = time.perf_counter()
    gold_etl = golden_etl(arrays, tables, args.seed)
    print(f"phase 10 goldens: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # phase 14c's Q1 golden (sf10_tables' arrays hold no l_tax)
    gold_q1, gold_q6 = golden_planner({**arrays, "l_tax": tables[
        "lineitem"]["l_tax"].to_numpy()}, TD.days)
    green = arrays["p_green"]
    del arrays
    # one plan per query in phases 7 and 8 (their second, hot plan went
    # with phase 9, to keep the script within half its time limit)
    joins = join_phase(torch, dev, tables, gold, GW, K, runs=("cold",))

    def check_join_calls(phase: dict, queries) -> list:
        """The widest window_group_sums call of each query's checked collect
        against the twin (rtol 1e-4, exact on integer measures)."""
        cases = []
        for q in queries:
            require(q in phase["calls"],
                    f"q{q}: no window_group_sums call on the card to check")
            j_gid, j_vals, j_cap = phase["calls"].pop(q)
            case = window_case(j_gid, j_vals, j_cap)
            live = int((j_gid[1:] != j_gid[:-1]).sum().item()) + 1
            case.update(query=q, launches=phase["window_group_sums"][
                f"q{q}"], shape=f"Q{q} widest call: capacity "
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
    parts = join_phase(torch, dev, tables, gold_parts, GW, K,
                       runs=("cold",))
    join_cases += check_join_calls(parts, (7, 8, 9, 10))
    like = like_case(torch, dev, tables["part"], green)
    lap("8 (join queries Q7, Q8, Q9, Q10)")

    # 9. Q2 and Q11-Q22: InSet, Min/Max, scalar subqueries, Cast, and
    # Q21's two CPU islands
    rest = join_phase(
        torch, dev, tables, gold_rest, GW, K, check=check_rest_query,
        runs=("cold",), trees={q: [TREE_CODES[c] for c in t.split()]
               for q, t in REST_TREES.items()})
    print(f"Q15's aggregate lanes on the card: "
          f"{rest['agg_lanes']['q15_cold']}; its revenue equals the "
          f"subquery's max to the bit", flush=True)
    join_cases += check_join_calls(
        rest, [q for q in gold_rest if rest["window_group_sums"][f"q{q}"]])
    by_query = {**joins["grouped_sum"], **parts["grouped_sum"],
                **rest["grouped_sum"]}
    grouped_cases = []
    for q, (g_keys, g_vals, g_rows, g_groups) in sorted(
            {**joins["grouped_calls"], **parts["grouped_calls"],
             **rest["grouped_calls"]}.items()):
        case = grouped_case(g_keys, g_vals, g_rows, g_groups, None)
        case.update(query=q, launches=by_query[f"q{q}"],
                    shape=f"Q{q} widest call: capacity {g_keys.numel()}, "
                    f"G={g_groups}, M={len(g_vals)}, tier {case['tier']}")
        print(kernel_text("grouped_sum", case), flush=True)
        grouped_cases.append(case)
        del g_keys, g_vals
    checked = {c["query"] for c in grouped_cases}
    require(all(q in checked for q in gold.keys() | gold_parts.keys()
                | gold_rest.keys() if by_query[f"q{q}"]),
            "grouped_sum launched in a query whose call was not checked")
    lap("9 (Q2 and Q11-Q22)")

    # 10. the type and expression layer: ETL plans over the same tables
    etl = etl_phase(torch, dev, tables, gold_etl, GW, K)
    del gold_etl
    # the widest call of each ETL plan's last collect against the twins
    etl_cases: dict = {"window_group_sums": [], "grouped_sum": []}
    for name, (e_gid, e_vals, e_cap) in sorted(etl["calls"].items()):
        case = window_case(e_gid, e_vals, e_cap)
        case.update(plan=name, launches=etl["launches"][name][
            "window_group_sums"], shape=f"{name} widest call: capacity "
            f"{e_gid.numel()}, out_cap {e_cap}, M={len(e_vals)}")
        print(kernel_text("window_group_sums", case), flush=True)
        etl_cases["window_group_sums"].append(case)
    for name, (e_keys, e_vals, e_rows, e_groups) in sorted(
            etl["grouped_calls"].items()):
        case = grouped_case(e_keys, e_vals, e_rows, e_groups, None)
        case.update(plan=name, launches=etl["launches"][name][
            "grouped_sum"], shape=f"{name} widest call: capacity "
            f"{e_keys.numel()}, G={e_groups}, M={len(e_vals)}, tier "
            f"{case['tier']}")
        print(kernel_text("grouped_sum", case), flush=True)
        etl_cases["grouped_sum"].append(case)
    for kernel, cases in etl_cases.items():
        checked = {c["plan"] for c in cases}
        require(all(p in checked for p, v in etl["launches"].items()
                    if v[kernel]),
                f"{kernel} launched in an ETL plan whose call was not "
                f"checked")
    require(not any(v["q1_fused"] for v in etl["launches"].values()),
            "q1_fused launched in an ETL plan: no call of it is checked")
    lap("10 (ETL expressions X1-X4)")

    # 12. the memory layer over the same tables, before phase 11 frees
    # them: Q18, Q9, a lineitem sort and Q17's subquery aggregate under a
    # quarter of their peaks, and Q5 under OOM injection
    mem = memory_phase(
        torch, dev, tables,
        {q: {"frame": ph["frames"][q],
             "peak": ph["peak_gb_by_query"][q] * 2**30,
             "seconds": sum(ph["seconds"][f"q{q}_cold"].values())}
         for q, ph in ((18, rest), (9, parts))},
        {18: lambda df: check_rest_query(18, df, gold_rest[18]),
         9: lambda df: check_part_query(9, df, gold_parts[9])},
        gold[5], GW, K)
    mem_cases = plan_cases("12", mem["runs"], window_case, grouped_case)
    lap("12 (memory layer: Q18, Q9, a lineitem sort and aggregate under "
        "budgets, Q5 under OOM injection)")

    # 14b and 14c: the same tables as Parquet, ORC and CSV files, and
    # the planner's sort-merge join, repartition, cached columnar scan
    # and sort aggregate
    io_b = io_files_phase(torch, dev, tables, gold, gold_parts, GW, K)
    lap("14b (Q3, Q5, Q9 over Parquet, ORC and CSV files)")
    gaps = plan_gaps_phase(torch, dev, tables, gold, gold_q1, GW, K)
    lap("14c (sort-merge join, repartition, cached columnar, sort "
        "aggregate)")

    # 15. the runtime over the same tables: two concurrent TPC-H streams,
    # admission and the result cache, the watchdog, AQE, the wrappers
    # under threads; every result against phases 6-9's goldens
    single_s = sum(sec["collect"] for ph in (joins, parts, rest)
                   for sec in ph["seconds"].values())
    runtime = runtime_phase(
        torch, dev, tables, {1: gold_q1, 6: gold_q6, **gold, **gold_parts,
                             **gold_rest},
        GW, K, (grouped_case, window_case), single_s, orders=HALF_STREAMS)
    # 14b's files stay for phase 17
    lap("15 (the runtime: TPC-H throughput test, admission, result cache, "
        "watchdog, AQE, wrappers under threads)")

    # 16. the shuffle manager lane over the same tables: four executors
    # of the card, the TCP lane, peer loss, a straggler, a second process
    # and the brute-force joins
    shuffle = shuffle_phase(
        torch, dev, tables, {1: gold_q1, 6: gold_q6, **gold, **gold_parts,
                             **gold_rest},
        GW, K, (grouped_case, window_case), args.seed)
    lap("16 (the shuffle manager lane: Q3, Q5, Q9, Q18 over four "
        "executors, TCP with zstd, peer kill, speculation, a second "
        "process, the brute-force joins)")

    # 17. the observability layer over the same tables and 14b's files:
    # profiled Q1 three ways and Q5, the kernel catalog against phase 3's
    # timings, Q5 under a budget and OOM injection, Q3 over four
    # executors, two streams under the telemetry sampler
    obs = profile_phase(
        torch, dev, tables, {1: gold_q1, 6: gold_q6, **gold, **gold_parts,
                             **gold_rest},
        GW, K, kernels, args.seed)
    io_reset()
    lap("17 (the observability layer: profiled Q1 and Q5, the kernel "
        "catalog, Q3 over four executors, unbudgeted and under budgets "
        "and OOM injection, two streams under the sampler)")

    # 18. the UDF layer: TPCx-BB q18 and q27 at SF1 compiled and not, the
    # pandas execs through the worker daemon over SF1 lineitem, the
    # plugin's lifecycle on the card, the shims, the audit, the export
    udf = udf_phase(
        torch, dev, tables, {1: gold_q1, 6: gold_q6, **gold, **gold_parts,
                             **gold_rest},
        (args.seed, JOIN_SF), GW, K, (grouped_case, window_case))
    lap("18 (the UDF layer: TPCx-BB q18 and q27 at SF1, the pandas execs "
        "through the worker daemon, plugin.activate(), the shims, the API "
        "audit, the ML export)")

    # 19. distribution: Q1, Q3, Q5 and Q9 over a mesh of MESH_SLOTS slots
    # with the SPMD lane on, then the graft entry's multi-slot dry run and
    # its Q1 step
    mesh = mesh_phase(
        torch, dev, tables, {1: gold_q1, **gold, **gold_parts}, GW, K,
        (grouped_case, window_case))
    del tables
    lap(f"19 (distribution: TPC-H Q1, Q3, Q5, Q9 at SF1 over a "
        f"{MESH_SLOTS}-slot mesh with the SPMD lane, the multi-slot dry "
        f"run, the entry step)")
    io_more = {i["label"]: i for i in list(io_b["queries"].values())
               + list(gaps.values())}
    for name, cases in plan_cases("14b and 14c", io_more, window_case,
                                  grouped_case).items():
        io_cases[name] += cases
    io_runs.update(io_more)

    # 11 and 13: TPC-DS, TPCx-BB and Mortgage, with phases 1-10's device
    # and host data freed.  13a holds all 103 TPC-DS queries (11a's 18
    # with them) against the CPU engine; 11b and 13b share one set of
    # tables at WL_SCALE
    for ph in (joins, parts, rest, etl):
        ph.pop("calls", None)
        ph.pop("grouped_calls", None)
    del gold, gold_parts, gold_rest, green
    gc.collect()
    gc.freeze()
    torch.cuda.empty_cache()
    # CARD_HELPERS processes run 13a's, 11b's and 13b's queries on the
    # card beside this one (spread); 11b's and 13b's kernel calls are
    # timed here after their queries, with the card to this process
    spec = ("workload", args.seed, WL_SCALE)
    with card_pool(dev) as pool:
        workloads_check_phase(torch, dev, args.seed, pool)
        lap(f"13a (TPC-DS 103 with 11a's 18, TPCx-BB 30 at "
            f"{WL_CHECK_SCALE} store_sales rows and Mortgage at "
            f"{WL_CHECK_LOANS} loans against the CPU engine, in this "
            f"process and {CARD_HELPERS} more on the card)")
        t0 = time.perf_counter()
        tables = workload_tables(*spec[1:])
        print("workload data: " + ", ".join(f"{k} {len(v)}" for k, v in
                                            tables.items())
              + f" rows, {time.perf_counter() - t0:.1f} s", flush=True)
        ds = ds_phase(torch, dev, args.seed, GW, K, queries=list(DS_SLICE),
                      tables=tables, pool=pool, spec=spec)
        lap(f"11b (TPC-DS's 18 queries at {WL_SCALE} store_sales rows, in "
            f"this process and {CARD_HELPERS} more on the card)")
        # 13b: every second one of TPC-DS's other 85, then Mortgage
        # here; TPCx-BB's 30 run by scripts/torch_workloads_phase.py (the
        # docstring's Cuts)
        ds_more = ds_phase(torch, dev, args.seed, GW, K,
                           queries=ds_rest_cut(), tables=tables, pool=pool,
                           spec=spec)
    del tables
    wl = workloads_scale_phase(torch, dev, args.seed, GW, K, WL_SCALE,
                               MORTGAGE_LOANS, xbb_queries=())
    wl["tpcds"] = ds_more
    for name in ("window_group_sums", "grouped_sum"):
        require(any(v["launches"][name] for suite in wl.values()
                    for v in suite.values()),
                f"{name} never launched in phase 13b")
    lap(f"13b (TPC-DS {len(ds_rest_cut())} of the 85 at {WL_SCALE} "
        f"store_sales rows, in this process and {CARD_HELPERS} more on the "
        f"card, Mortgage at {MORTGAGE_LOANS} loans x {MORTGAGE_MONTHS} "
        f"months)")

    kernels["q1_fused"]["launches"] = step_launches
    kernels["grouped_sum"]["launches"] = engine_launches["grouped_sum"]
    kernels["window_group_sums"]["launches"] = \
        engine_launches["window_group_sums"]
    kernels["window_group_sums"]["planner_q1_launches"] = \
        planner["q1_launches"]
    for name in ("grouped_sum", "window_group_sums"):
        kernels[name]["join_queries_launches"] = {
            **joins[name], **parts[name], **rest[name]}
    for name in kernels:
        kernels[name]["etl_launches"] = {
            p: v[name] for p, v in etl["launches"].items() if v[name]}
        kernels[name]["tpcds_launches"] = {
            q: v["launches"][name] for q, v in sorted(
                {**ds, **wl["tpcds"]}.items(),
                key=lambda kv: query_order(kv[0]))}
        for suite in ("tpcxbb", "mortgage"):
            kernels[name][f"{suite}_launches"] = {
                q: v["launches"][name] for q, v in wl.get(suite,
                                                          {}).items()}
    case_keys = ("query", "plan", "shape", "launches", "max_abs_err",
                 "max_rel_err", "ms", "device_ms", "device_ms_by",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels["window_group_sums"]["join_cases"] = [
        {k: c[k] for k in case_keys if k in c} for c in join_cases]
    kernels["grouped_sum"]["join_cases"] = [
        {k: c[k] for k in case_keys if k in c} for c in grouped_cases]
    for name, cases in etl_cases.items():
        kernels[name]["etl_cases"] = [
            {k: c[k] for k in case_keys if k in c} for c in cases]
    for name in kernels:
        kernels[name]["io_launches"] = {
            label: i["launches"][name] for label, i in io_runs.items()}
    for name, cases in io_cases.items():
        kernels[name]["io_cases"] = [
            {k: c[k] for k in case_keys if k in c} for c in cases]
    for name, cases in mem_cases.items():
        kernels[name]["memory_launches"] = {
            p: v["launches"][name] for p, v in mem["runs"].items()
            if v["launches"][name]}
        kernels[name]["memory_cases"] = [
            {k: c[k] for k in case_keys if k in c} for c in cases]
    kernels["q1_fused"]["memory_launches"] = {}
    for name in kernels:
        kernels[name]["runtime_launches"] = {
            part: v[name] for part, v in runtime["launches"].items()}
    for name in kernels:
        kernels[name]["shuffle_launches"] = {
            part: v[name] for part, v in shuffle["launches"].items()}
        kernels[name]["shuffle_cases"] = [
            {k: c["cases"][name][k] for k in case_keys
             if k in c["cases"][name]}
            for c in shuffle["16a"].values() if name in c["cases"]]
    for name in kernels:
        kernels[name]["observability_launches"] = {
            part: v[name] for part, v in obs["launches"].items()}
        kernels[name]["catalog_device_ms"] = obs["catalog"][name]["mean_ms"]
        kernels[name]["catalog_reference_ms"] = \
            obs["catalog"][name]["reference_ms"]
    for name in kernels:
        kernels[name]["udf_launches"] = {
            part: v[name] for part, v in udf["launches"].items()}
        kernels[name]["udf_cases"] = [
            {k: c[k] for k in case_keys if k in c}
            for c in udf["cases"].get(name, [])]
    for name in kernels:
        kernels[name]["mesh_launches"] = {
            part: v[name] for part, v in mesh["launches"].items()}
        kernels[name]["mesh_cases"] = [
            {k: c["cases"][name][k] for k in case_keys
             if k in c["cases"][name]}
            for c in mesh["19a"].values() if name in c["cases"]]
    for name in ("window_group_sums", "grouped_sum"):
        kernels[name]["runtime_cases"] = [
            {k: runtime["15a"]["cases"][name][k] for k in case_keys
             if k in runtime["15a"]["cases"][name]}]
    for name, key in (("window_group_sums", "window_case"),
                      ("grouped_sum", "grouped_case")):
        kernels[name]["tpcds_cases"] = [
            {k: v[key][k] for k in case_keys if k in v[key]}
            for v in ds.values() if key in v]
        kernels[name]["workload_cases"] = [
            {"suite": suite, **{k: v[key][k] for k in case_keys
                                if k in v[key]}}
            for suite in ("tpcds", "tpcxbb", "mortgage")
            for v in wl.get(suite, {}).values() if key in v]
    print(f"like over {like['rows']} rows: {like['ms']:.4f} ms "
          f"(Contains {like['contains_ms']:.4f} ms), same rows as "
          f"Contains and the p_name green mask", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "planner_q1_launches",
            "join_queries_launches", "join_cases", "etl_launches",
            "etl_cases", "tpcds_launches", "tpcds_cases", "memory_launches",
            "memory_cases", "tpcxbb_launches", "mortgage_launches",
            "workload_cases", "io_launches", "io_cases",
            "runtime_launches", "runtime_cases", "shuffle_launches",
            "shuffle_cases", "observability_launches", "catalog_device_ms",
            "catalog_reference_ms", "udf_launches", "udf_cases",
            "mesh_launches", "mesh_cases")
    line = {"kernels": [{k: v[k] for k in keys if k in v}
                        for v in kernels.values()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
