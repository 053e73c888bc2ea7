"""spark_rapids_tpu_torch's prefetch pipeline (exec/pipeline.py) against
spark_rapids_tpu's, twins of 15 of the 17 tests of tests/test_pipeline.py
(17 cases of its 19): the PrefetchIterator contract (order, bounded
depth, errors and cancellation, conf and retry-flag propagation, the
semaphore discipline), TPC-H Q1 and Q5 pipelined against the same run
synchronous (bit-exact) and against the JAX package's engine on the same
seeded tables (compare_frames' rtol 1e-5), also under seeded OOM
injection, a pipelined group-by against pandas, and AQE's streaming
stage materialization.  The port prefetches at the file scan alone (the
reference also at coalesce and the exchange; exec/pipeline.py says why),
so the tests that need producers read their tables from Parquet files
written by the port's writer (`write_tpch_files`, `run_tpch_files`, also
used by the scheduler, watchdog and out-of-core tests).

Left out, with the layer that brings them: the two host-sync counter
tests (`test_host_sync_counter_counts_lazy_num_rows`,
`test_metricset_lazy_resolve_one_sync_per_dtype_wave`): the port has no
host-sync counter yet (ROADMAP.md item 9, observability).

Added: a producer reads its query's conf, not the defaults (the conf
key that flips the aggregate's float lane, read on the scan's producer
thread).  That
a producer enqueues on its creator's CUDA stream is a card test
(tests/test_torch_gpu.py).  Every thread join and queue wait here has
its own timeout.
"""
import threading
import time

import numpy as np
import pandas as pd
import pytest
from pandas.testing import assert_frame_equal
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exec.pipeline import PrefetchIterator as RPrefetch
from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec.pipeline import (PrefetchIterator,
                                                  maybe_prefetch,
                                                  pipeline_live,
                                                  pipeline_stats,
                                                  reset_pipeline_stats)
from spark_rapids_tpu_torch.memory.semaphore import TaskContext, TpuSemaphore
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.utils import checks as CK
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


def _wait_for(pred, seconds: float) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ---------------------------------------------------------------------------
# PrefetchIterator unit contract, each against the reference's iterator
def test_prefetch_passthrough_order():
    got = list(PrefetchIterator(iter(range(100)), depth=3))
    assert got == list(RPrefetch(iter(range(100)), depth=3)) \
        == list(range(100))


def test_prefetch_empty_source():
    assert list(PrefetchIterator(iter(()), depth=2)) == []
    assert list(RPrefetch(iter(()), depth=2)) == []


def test_maybe_prefetch_disabled_returns_plain_iter():
    conf = C.RapidsConf({"spark.rapids.sql.pipeline.enabled": False})
    assert not isinstance(maybe_prefetch(iter([1, 2]), conf=conf),
                          PrefetchIterator)
    conf0 = C.RapidsConf({"spark.rapids.sql.pipeline.prefetchDepth": 0})
    assert not isinstance(maybe_prefetch(iter([1]), conf=conf0),
                          PrefetchIterator)
    # on by default, as in the reference
    assert isinstance(maybe_prefetch(iter([1]), conf=C.RapidsConf()),
                      PrefetchIterator)
    assert C.RapidsConf()[C.PIPELINE_ENABLED] is \
        RC.RapidsConf()[RC.PIPELINE_ENABLED] is True


def test_prefetch_error_propagates_after_good_items():
    def src():
        yield 1
        yield 2
        raise RuntimeError("producer exploded")

    for cls in (PrefetchIterator, RPrefetch):
        got = []
        with pytest.raises(RuntimeError, match="producer exploded"):
            for x in cls(src(), depth=2):
                got.append(x)
        assert got == [1, 2]


def test_prefetch_bounded_depth_backpressure():
    """The producer never runs more than `depth` items ahead: with the
    consumer parked, at most depth items are queued plus the one in the
    blocked put's hand."""
    produced = []

    def src():
        for i in range(50):
            produced.append(i)
            yield i

    it = PrefetchIterator(src(), depth=2)
    assert next(it) == 0
    assert _wait_for(it.blocked.is_set, 10.0), \
        "producer should be parked on the full queue"
    assert len(produced) <= 4
    assert pipeline_live()["in_flight"] >= 2
    assert list(it) == list(range(1, 50))
    assert len(produced) == 50


def test_prefetch_close_cancels_producer():
    stopped = threading.Event()

    def src():
        try:
            for i in range(10_000):
                yield i
        finally:
            stopped.set()

    it = PrefetchIterator(src(), depth=2)
    assert next(it) == 0
    it.close()
    assert stopped.wait(5.0), "a cancelled producer must close its source"
    with pytest.raises(StopIteration):
        next(it)
    assert not it._thread.is_alive()


def test_prefetch_propagates_session_conf_to_producer():
    seen = []
    conf = C.RapidsConf({C.VARIABLE_FLOAT_AGG.key: True})

    def src():
        seen.append((C.get_active_conf()[C.VARIABLE_FLOAT_AGG],
                     threading.current_thread().name))
        yield 1

    with C.session(conf):
        it = PrefetchIterator(src(), depth=1)
    assert list(it) == [1]
    assert seen[0][0] is True
    assert seen[0][1].startswith("tpu-prefetch")


def test_prefetch_propagates_retry_flag_to_producer():
    seen = []

    def src():
        seen.append(CK.is_retrying())
        yield 1

    CK.set_retrying(True)
    try:
        it = PrefetchIterator(src(), depth=1)
    finally:
        CK.set_retrying(False)
    assert list(it) == [1]
    assert seen == [True]


# ---------------------------------------------------------------------------
# semaphore discipline
def test_producer_blocked_on_full_queue_never_holds_semaphore():
    """A producer whose source took the semaphore yields it while parked
    on a full prefetch queue, so another task can use the card."""
    TpuSemaphore.initialize(1)
    sem = TpuSemaphore.get()
    try:
        def src():
            sem.acquire_if_necessary()
            for i in range(10):
                yield i

        it = PrefetchIterator(src(), depth=1)
        assert next(it) == 0
        assert _wait_for(it.blocked.is_set, 10.0)
        assert _wait_for(lambda: sem.available_permits() >= 1, 10.0), (
            "a producer blocked on a full prefetch queue holds the "
            "semaphore")
        with TaskContext(777) as probe:
            sem.acquire_if_necessary(probe)
            assert sem.holds(probe) == 1
            sem.release_if_necessary(probe)
        assert list(it) == list(range(1, 10))
    finally:
        TpuSemaphore.shutdown()


def test_same_task_concurrent_first_acquire_single_permit():
    """Two threads of one task racing acquire_if_necessary end with the
    task holding exactly one permit."""
    TpuSemaphore.initialize(2)
    sem = TpuSemaphore.get()
    try:
        ctx = TaskContext(42)
        start = threading.Barrier(2, timeout=10)

        def worker():
            TaskContext.set_current(ctx)
            start.wait()
            sem.acquire_if_necessary()

        ts = [threading.Thread(target=worker) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert sem.holds(ctx) == 2
        assert sem.available_permits() == 1
        sem.release_all(ctx)
        assert sem.available_permits() == 2
    finally:
        TpuSemaphore.shutdown()


# ---------------------------------------------------------------------------
# pipelined against synchronous execution, and against the reference
SCALE, SEED = 2000, 23


@pytest.fixture(scope="module")
def tables():
    return TD.gen_tables(np.random.default_rng(SEED), SCALE)


@pytest.fixture(scope="module")
def ref_tables():
    return RD.gen_tables(np.random.default_rng(SEED), SCALE)


def _conf(pipe: bool, extra: dict):
    return {**TB.BENCH_CONF, **extra,
            "spark.rapids.sql.pipeline.enabled": pipe,
            "spark.rapids.sql.pipeline.prefetchDepth": 2}


def write_tpch_files(tables: dict, root, names=None):
    """The TPC-H tables (or those of `names`) written as Parquet under
    root/<name>, two files each, by the port's writer on the CPU."""
    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.models.data_util import split_partitions
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = C.RapidsConf(dict(TB.BENCH_CONF))
    for name in names or TD.SCHEMAS:
        collect(accelerate(pio.write(
            N.CpuSource(split_partitions(tables[name], 2), TD.SCHEMAS[name]),
            str(root / name), "parquet"), conf, device="cpu"), conf)
    return root


def run_tpch_files(query: int, root, conf, names=None):
    """TPC-H `query` over the Parquet tables under `root` (see
    write_tpch_files) on the CPU: each file scan prefetches."""
    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect

    def run(plan):
        return collect(accelerate(plan, conf, device="cpu"), conf)
    return run(QUERIES[query]({n: pio.read_parquet(str(root / n))
                               for n in names or TD.SCHEMAS}, run))


@pytest.fixture(scope="module")
def file_root(tables, tmp_path_factory):
    return write_tpch_files(tables, tmp_path_factory.mktemp("tpch"))


def _port(query: int, tables, pipe: bool, extra=None):
    return TB.run_query(query, tables, device="cpu",
                        conf=C.RapidsConf(_conf(pipe, extra or {})))


def _port_files(query: int, root, pipe: bool):
    return run_tpch_files(query, root, C.RapidsConf(_conf(pipe, {})))


_REF: dict = {}


def _reference(query: int, ref_tables):
    """The JAX package's pipelined result, once per module."""
    if query not in _REF:
        _REF[query] = RB.run_query(query, ref_tables, conf=RC.RapidsConf(
            _conf(True, {})))
    return _REF[query]


@pytest.mark.parametrize("query", [1, 5])
def test_tpch_pipelined_bit_exact(query, file_root, ref_tables):
    """Pipelining changes no bit of Q1/Q5 over files: same kernels, same
    batch grouping, same accumulation order; only where the scans' host
    work runs moves.  Both agree with the reference's pipelined run."""
    reset_pipeline_stats()
    sync_df = _port_files(query, file_root, False)
    assert pipeline_stats()["producers"] == 0
    pipe_df = _port_files(query, file_root, True)
    assert pipeline_stats()["producers"] > 0
    assert_frame_equal(sync_df, pipe_df, check_exact=True)
    compare_frames(_reference(query, ref_tables), pipe_df, f"q{query}")
    assert _wait_for(lambda: pipeline_live()["producers"] == 0, 5.0)


@pytest.mark.parametrize("query", [1, 5])
def test_tpch_pipelined_bit_exact_under_oom_injection(query, tables):
    """Seeded OOM injection under pipelining: producer-side reservation
    failures reach the consuming exec, split-and-retry fires there, and
    the result is bit-exact against the synchronous run under the same
    seed."""
    from spark_rapids_tpu_torch.memory import retry as R
    overrides = {
        "spark.rapids.memory.faultInjection.oomRate": 0.05,
        "spark.rapids.memory.faultInjection.seed": 7,
        "spark.rapids.memory.faultInjection.maxInjections": 64,
    }
    frames = {}
    for pipe in (False, True):
        R.reset_oom_injection()
        frames[pipe] = _port(query, tables, pipe, overrides)
    R.reset_oom_injection()
    assert_frame_equal(frames[False], frames[True], check_exact=True)


def _parquet_source(df: pd.DataFrame, root, parts: int):
    """`df` written as `parts` Parquet files under `root`, read back as
    the port's file-scan leaf."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch import io as pio
    root.mkdir(parents=True, exist_ok=True)
    step = -(-len(df) // parts)
    for i in range(parts):
        pq.write_table(pa.Table.from_pandas(
            df.iloc[i * step:(i + 1) * step], preserve_index=False),
            root / f"part-{i:05d}.parquet")
    return pio.read_parquet(str(root))


def test_groupby_pipelined_matches_pandas(tmp_path):
    from spark_rapids_tpu_torch.exprs.aggregates import Count, Sum
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"k": rng.integers(0, 97, 60_000).astype(np.int64),
                       "v": rng.uniform(0, 10, 60_000)})
    plan = N.CpuAggregate([col("k")],
                          [Sum(col("v")).alias("sv"),
                           Count(col("v")).alias("c")],
                          _parquet_source(df, tmp_path / "kv", 4))
    conf = C.RapidsConf({
        "spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.sql.pipeline.enabled": True,
        "spark.rapids.sql.pipeline.prefetchDepth": 2})
    reset_pipeline_stats()
    got = collect(accelerate(plan, conf, device="cpu"), conf) \
        .sort_values("k", ignore_index=True)
    exp = df.groupby("k").agg(sv=("v", "sum"),
                              c=("v", "size")).reset_index()
    assert np.allclose(got["sv"].astype(float), exp["sv"], rtol=1e-3)
    assert (got["c"].astype(int).to_numpy() == exp["c"].to_numpy()).all()
    assert pipeline_stats()["producers"] > 0, \
        "a pipelined run should have started prefetch producers"


def _float_groupby(conf, root):
    from spark_rapids_tpu_torch.exprs.aggregates import Sum
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan import nodes as N
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"k": rng.integers(0, 50, 20_000).astype(np.int64),
                       "v": rng.uniform(0, 10, 20_000)})
    plan = N.CpuAggregate([col("k")], [Sum(col("v")).alias("sv")],
                          _parquet_source(df, root, 4))
    return collect(accelerate(plan, conf, device="cpu"), conf) \
        .sort_values("k", ignore_index=True)


def test_producer_reads_its_querys_conf_not_the_defaults(tmp_path):
    """The reference's captured-default-conf bug class (a producer that
    read the defaults flipped Q15's aggregation from float64 to f32):
    with variableFloatAgg on (the default is off), the conf the scan's
    code reads on its prefetch producer thread has it on, and the f32
    lane of the group-by above it runs; the result is bit-exact against
    the synchronous run.  With it off, the producer reads it off and no
    f32 lane runs."""
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.io.exec import TpuFileSourceScanExec
    seen: list = []
    lanes: list = []
    saved_iter = TpuFileSourceScanExec._partition_iter
    saved_gs = AGG.grouped_sum

    def spy_iter(self, part):
        for b in saved_iter(self, part):
            seen.append((threading.current_thread().name,
                         C.get_active_conf()[C.VARIABLE_FLOAT_AGG]))
            yield b

    def spy_gs(*a, **k):
        lanes.append(threading.current_thread().name)
        return saved_gs(*a, **k)

    def conf(pipe: bool, vfa: bool):
        return C.RapidsConf({C.VARIABLE_FLOAT_AGG.key: vfa,
                             C.PIPELINE_ENABLED.key: pipe})
    TpuFileSourceScanExec._partition_iter = spy_iter
    AGG.grouped_sum = spy_gs
    try:
        on = _float_groupby(conf(True, True), tmp_path / "a")
        assert seen and all(t.startswith("tpu-prefetch") and vfa
                            for t, vfa in seen), seen
        assert lanes, "the f32 lane did not run under its conf"
        seen.clear()
        sync = _float_groupby(conf(False, True), tmp_path / "b")
        assert seen and not any(t.startswith("tpu-prefetch")
                                for t, _ in seen), seen
        seen.clear()
        lanes.clear()
        _float_groupby(conf(True, False), tmp_path / "c")
        assert seen and all(t.startswith("tpu-prefetch") and not vfa
                            for t, vfa in seen), seen
        assert lanes == [], "the f32 lane ran without its conf"
    finally:
        TpuFileSourceScanExec._partition_iter = saved_iter
        AGG.grouped_sum = saved_gs
    assert_frame_equal(on, sync, check_exact=True)


# ---------------------------------------------------------------------------
# AQE streaming stage materialization
def _aqe_plan(n_rows: int):
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exprs.base import col
    from spark_rapids_tpu_torch.plan.nodes import schema_of_df
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioning
    rng = np.random.default_rng(11)
    df = pd.DataFrame({"k": rng.integers(0, 1000, n_rows).astype(np.int64),
                       "v": rng.uniform(0, 1, n_rows)})
    schema = schema_of_df(df)
    step = -(-n_rows // 3)
    src = LocalBatchSource(
        [[batch_from_df(df.iloc[i:i + step].reset_index(drop=True), schema,
                        "cpu")] for i in range(0, n_rows, step)],
        schema, device="cpu")
    return df, ShuffleExchangeExec(HashPartitioning([col("k")], 4), src)


@pytest.mark.parametrize("pipe", [False, True])
def test_aqe_stage_materialization_row_parity(pipe):
    from spark_rapids_tpu_torch.plan import aqe
    df, ex = _aqe_plan(20_000)
    conf = C.RapidsConf({"spark.sql.adaptive.enabled": True,
                         "spark.rapids.sql.pipeline.enabled": pipe})
    with C.session(conf):
        stage = aqe.ShuffleQueryStageExec(ex).materialize()
        assert (stage._fill is not None) is pipe
        total = sum(b.num_rows for it in stage.execute_partitions()
                    for b in it)
        assert total == len(df)
        # statistics read after streaming consumption see every byte
        assert sum(stage.partition_sizes()) > 0
        # a second read (a deopt retry's) serves the held buckets
        total2 = sum(b.num_rows for it in stage.execute_partitions()
                     for b in it)
        assert total2 == len(df)
        stage.release_buckets()
        assert stage._buckets is None


def test_aqe_streaming_fill_error_propagates():
    from spark_rapids_tpu_torch.plan import aqe

    class BoomExec(Exception):
        pass

    _, ex = _aqe_plan(5_000)

    def boom():
        raise BoomExec("map side died")
    ex.execute_partitions = boom
    conf = C.RapidsConf({"spark.rapids.sql.pipeline.enabled": True})
    with C.session(conf):
        stage = aqe.ShuffleQueryStageExec(ex).materialize()
        with pytest.raises(BoomExec):
            stage.partition_sizes()
