"""spark_rapids_tpu_torch's serving layer (exec/scheduler.py) against
spark_rapids_tpu's, twins of 13 of the 16 tests of tests/test_scheduler.py:
a concurrent TPC-H / TPC-DS soak bit-exact against its serial runs,
admission control (queue full, queue timeout, FIFO wait, budget gate),
conf isolation between concurrent queries, OOM and hang injection aimed
at one victim query, the fair-share semaphore, the result cache and the
nested collect's one QueryContext.  The serial results are held against
the JAX package's engine on the same seeded tables (compare_frames' rtol
1e-5), and the admission messages and cache keys against the
reference's.

Left out, with the layer that brings them: `test_peer_kill_recovery_
isolated` (the shuffle manager's peer-kill recovery, ROADMAP.md item 8)
and `test_scheduler_events_in_profile` (the query profile, item 9).
`test_conf_isolation_pipeline_on_off_concurrent` and
`test_oom_injection_hits_victim_only` check through the producers each
query started and the injectors it drove instead of the profile's
spans and events (item 9).

The port prefetches at the file scan alone, so the tests that need
producers read their tables from Parquet files (test_torch_pipeline's
`write_tpch_files`).

Added: two collects on two threads under different confs, each equal to
its serial result; result-cache keys that tell apart two Q19 plans
differing in one literal deep in their filter, and refuse what they
cannot key; the default admission budget against the reference's;
the semaphore's group falling back to the current query; a yielded
thread rejoining its task's hold that a sibling thread re-took (a
deadlock the card showed).  Every thread join and queue wait has its own
timeout; watchdog polls are 0.1 s and task timeouts 2 s.
"""
import threading
import time

import numpy as np
import pandas as pd
import pytest
from pandas.testing import assert_frame_equal
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.exec import scheduler as RS
from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import pipeline as PL
from spark_rapids_tpu_torch.exec import scheduler as S
from spark_rapids_tpu_torch.exec.base import TpuExec, UnaryExecBase
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exec.scheduler import (QueryContext,
                                                   QueryScheduler,
                                                   TpuQueryRejected,
                                                   result_cache)
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.memory.semaphore import TaskContext, TpuSemaphore
from spark_rapids_tpu_torch.models import tpcds_data, tpcds_queries
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.overrides import accelerate
from spark_rapids_tpu_torch.plan.overrides import collect as plan_collect
from spark_rapids_tpu_torch.plan.transitions import batch_from_df
from spark_rapids_tpu_torch.utils import watchdog as W
from test_torch_pipeline import run_tpch_files, write_tpch_files
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

SCALE = 400
JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def tables():
    return TD.gen_tables(np.random.default_rng(11), SCALE)


@pytest.fixture(scope="module")
def file_root(tables, tmp_path_factory):
    """`tables` as Parquet files: a query over them prefetches at its
    scans, the one place the port runs producers."""
    return write_tpch_files(tables, tmp_path_factory.mktemp("tpch"))


@pytest.fixture(scope="module")
def ds_tables():
    return tpcds_data.gen_tables(np.random.default_rng(3), 4000)


def _conf(**extra) -> C.RapidsConf:
    settings = dict(TB.BENCH_CONF)
    settings.update({k.replace("__", "."): v for k, v in extra.items()})
    return C.RapidsConf(settings)


def _run_tpch(q, tables, conf):
    return TB.run_query(q, tables, device="cpu", conf=conf)


def _run_tpcds(name, ds_tables, conf):
    fn = tpcds_queries.QUERIES[name]

    def run(plan):
        return plan_collect(accelerate(plan, conf, device="cpu"), conf)
    return run(fn(tpcds_data.sources(ds_tables, 2), run))


def _join_all(threads) -> None:
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a worker never ended"


def _assert_no_leaks():
    snap = TpuSemaphore.get().snapshot()
    assert snap["refs"] == {}, f"leaked semaphore permits: {snap}"
    dm = DeviceManager.peek()
    if dm is not None:
        assert dm.admissions() == {}, \
            f"leaked admissions: {dm.admissions()}"
        assert dm.reserved_bytes == 0, \
            f"leaked reservations: {dm.reserved_bytes}"
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        live = [t for t in threading.enumerate()
                if t.name.startswith("tpu-prefetch")
                or t.name.startswith("tpu-aqe-stage-fill")]
        if not live:
            break
        time.sleep(0.05)
    assert not live, f"leaked producer threads: {live}"


# ---------------------------------------------------------------------------
# soak: mixed TPC-H / TPC-DS under concurrency, bit-exact against serial
def test_soak_mixed_queries_bit_exact(tables, ds_tables):
    conf = _conf()
    mix = [("tpch", 1), ("tpch", 5), ("tpch", 6), ("tpcds", "q3"),
           ("tpcds", "q42"), ("tpch", 1), ("tpch", 6), ("tpcds", "q3")]
    serial = {}
    for kind, q in set(mix):
        serial[(kind, q)] = (_run_tpch(q, tables, conf) if kind == "tpch"
                             else _run_tpcds(q, ds_tables, conf))
    # the serial TPC-H results hold against the reference's engine
    ref_tables = RD.gen_tables(np.random.default_rng(11), SCALE)
    for q in (1, 6):
        compare_frames(RB.run_query(q, ref_tables, conf=RC.RapidsConf(
            dict(RB.BENCH_CONF))), serial[("tpch", q)], f"q{q}")
    results: dict = {}
    errors: list = []

    def worker(i, kind, q):
        try:
            got = (_run_tpch(q, tables, conf) if kind == "tpch"
                   else _run_tpcds(q, ds_tables, conf))
            results[i] = ((kind, q), got)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append((i, kind, q, repr(e)))

    before = QueryScheduler.get().stats()["max_admitted"]
    threads = [threading.Thread(target=worker, args=(i, kind, q),
                                name=f"soak-{i}")
               for i, (kind, q) in enumerate(mix)]
    for t in threads:
        t.start()
    _join_all(threads)
    assert not errors, errors
    assert len(results) == len(mix)
    for i, (key, got) in results.items():
        assert_frame_equal(got.reset_index(drop=True),
                           serial[key].reset_index(drop=True))
    assert QueryScheduler.get().stats()["max_admitted"] >= max(before, 1)
    _assert_no_leaks()


def test_two_sessions_under_different_confs_match_their_serial_runs(
        tables):
    """Two collects on two threads at once, one with the pipeline and
    the f32 float lane on, one with both off: each equals its own serial
    result bit for bit."""
    conf_a = _conf(**{C.PIPELINE_ENABLED.key: True,
                      C.VARIABLE_FLOAT_AGG.key: True})
    conf_b = _conf(**{C.PIPELINE_ENABLED.key: False,
                      C.VARIABLE_FLOAT_AGG.key: False})
    serial = {"a": _run_tpch(1, tables, conf_a),
              "b": _run_tpch(1, tables, conf_b)}
    got: dict = {}
    errors: list = []
    barrier = threading.Barrier(2, timeout=30)

    def worker(name, conf):
        try:
            barrier.wait()
            for _ in range(3):
                got.setdefault(name, []).append(_run_tpch(1, tables, conf))
        except BaseException as e:  # noqa: BLE001
            errors.append((name, repr(e)))

    ts = [threading.Thread(target=worker, args=("a", conf_a)),
          threading.Thread(target=worker, args=("b", conf_b))]
    for t in ts:
        t.start()
    _join_all(ts)
    assert not errors, errors
    for name in ("a", "b"):
        for df in got[name]:
            assert_frame_equal(df, serial[name], check_exact=True)
    _assert_no_leaks()


# ---------------------------------------------------------------------------
# admission control
class _GatedExec(UnaryExecBase):
    """Passes batches through, parking on `gate` first: holds its query
    in the executing state until the test releases it."""

    def __init__(self, child, gate: threading.Event,
                 entered: threading.Event):
        super().__init__(child)
        self.gate = gate
        self.entered = entered

    def output_schema(self):
        return self.child.output_schema()

    def process_partition(self, batches):
        self.entered.set()
        deadline = time.monotonic() + 60.0
        while not self.gate.wait(0.05):
            W.check_cancelled()
            assert time.monotonic() < deadline, "test gate never opened"
        yield from batches


def _source(n):
    df = pd.DataFrame({"x": np.arange(n, dtype=np.int64)})
    return LocalBatchSource([[batch_from_df(df, schema_of_df(df), "cpu")]],
                            device="cpu")


def _gated_plan(gate, entered):
    return _GatedExec(_source(32), gate, entered)


def _run_plan_under(conf, plan):
    with C.session(conf):
        return plan.collect()


def test_admission_queue_full_rejects():
    gate, entered = threading.Event(), threading.Event()
    conf = _conf(**{"spark.rapids.sql.scheduler.maxConcurrentQueries": 1,
                    "spark.rapids.sql.scheduler.queueDepth": 0})
    plan = _gated_plan(gate, entered)
    out: list = []

    def holder():
        with C.session(conf):
            out.append(plan.collect().to_pandas())

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert entered.wait(30), "holder query never started"
        with C.session(conf):
            with pytest.raises(TpuQueryRejected) as ei:
                _gated_plan(threading.Event(), threading.Event()).collect()
        msg = str(ei.value)
        assert "queue is full" in msg and "queueDepth" in msg
    finally:
        gate.set()
        t.join(JOIN_S)
    assert len(out) == 1 and len(out[0]) == 32
    _assert_no_leaks()


def test_admission_queue_timeout_rejects():
    gate, entered = threading.Event(), threading.Event()
    conf = _conf(**{"spark.rapids.sql.scheduler.maxConcurrentQueries": 1,
                    "spark.rapids.sql.scheduler.queueDepth": 8,
                    "spark.rapids.sql.scheduler.queueTimeout": 0.3})
    plan = _gated_plan(gate, entered)
    t = threading.Thread(target=_run_plan_under, args=(conf, plan))
    t.start()
    try:
        assert entered.wait(30)
        t0 = time.monotonic()
        with C.session(conf):
            with pytest.raises(TpuQueryRejected) as ei:
                _gated_plan(threading.Event(), threading.Event()).collect()
        assert time.monotonic() - t0 < 10
        msg = str(ei.value)
        assert "admission queue" in msg and "queueTimeout" in msg
    finally:
        gate.set()
        t.join(JOIN_S)
    _assert_no_leaks()


def test_admission_waits_then_admits():
    """A queued query is admitted (FIFO) the moment the holder's slot
    frees: no rejection, result intact."""
    gate, entered = threading.Event(), threading.Event()
    conf = _conf(**{"spark.rapids.sql.scheduler.maxConcurrentQueries": 1,
                    "spark.rapids.sql.scheduler.queueDepth": 8})
    before = QueryScheduler.get().stats()
    t = threading.Thread(target=_run_plan_under,
                         args=(conf, _gated_plan(gate, entered)))
    t.start()
    try:
        assert entered.wait(30)
        waiter_out: list = []

        def waiter():
            with C.session(conf):
                waiter_out.append(_source(8).collect().to_pandas())

        wt = threading.Thread(target=waiter)
        wt.start()
        time.sleep(0.3)
        assert not waiter_out, "the waiter ran while the slot was held"
        assert QueryScheduler.get().queue_depth() == 1
        gate.set()
        wt.join(JOIN_S)
        assert waiter_out and waiter_out[0]["x"].sum() == 28
    finally:
        gate.set()
        t.join(JOIN_S)
    after = QueryScheduler.get().stats()
    assert after["queued"] == before["queued"] + 1
    assert after["longest_queue_wait_ms"] > 0
    _assert_no_leaks()


def test_admission_budget_gates_concurrency():
    """Two queries each declaring more than half the device budget are
    not admitted together, even under a generous query-count cap."""
    _source(1).collect()   # the DeviceManager exists from here on
    dm = DeviceManager.peek()
    budget = max(1, dm.budget)
    conf = _conf(**{
        "spark.rapids.sql.scheduler.maxConcurrentQueries": 8,
        "spark.rapids.sql.scheduler.queryBudgetBytes": (budget * 2) // 3,
        "spark.rapids.sql.scheduler.queueDepth": 8})
    gate, entered = threading.Event(), threading.Event()
    t = threading.Thread(target=_run_plan_under,
                         args=(conf, _gated_plan(gate, entered)))
    t.start()
    try:
        assert entered.wait(30)
        assert len(dm.admissions()) == 1
        admitted_during: list = []

        def second():
            with C.session(conf):
                _source(4).collect()
            admitted_during.append(time.monotonic())

        wt = threading.Thread(target=second)
        wt.start()
        time.sleep(0.3)
        assert not admitted_during, \
            "a second over-budget query was admitted beside the first"
        gate.set()
        wt.join(JOIN_S)
        assert admitted_during
    finally:
        gate.set()
        t.join(JOIN_S)
    _assert_no_leaks()


def test_admission_budget_matches_the_reference():
    """The default per-query budget is the device budget over
    maxConcurrentQueries, in both packages."""
    for maxq in (1, 4, 7):
        conf = C.RapidsConf({C.SCHED_MAX_CONCURRENT.key: maxq})
        rconf = RC.RapidsConf({RC.SCHED_MAX_CONCURRENT.key: maxq})

        class _Dm:
            budget = 1 << 30
        assert QueryScheduler._budget_for(conf, _Dm) == \
            RS.QueryScheduler._budget_for(rconf, _Dm)


# ---------------------------------------------------------------------------
# cross-query conf isolation
def test_conf_isolation_pipeline_on_off_concurrent(file_root):
    """Two concurrent queries over files with conflicting pipeline confs
    each honor their own: only the enabled one starts producers (at its
    scans), and both are bit-exact."""
    ref = run_tpch_files(1, file_root, _conf())
    conf_on = _conf(**{"spark.rapids.sql.pipeline.enabled": True})
    conf_off = _conf(**{"spark.rapids.sql.pipeline.enabled": False})
    producers: dict = {}
    lock = threading.Lock()
    saved = PL.PrefetchIterator.__init__

    def spy(self, *a, **k):
        saved(self, *a, **k)
        with lock:
            name = threading.current_thread().name
            producers[name] = producers.get(name, 0) + 1

    results: dict = {}
    errors: list = []
    barrier = threading.Barrier(2, timeout=30)

    def worker(name, conf):
        try:
            barrier.wait()
            results[name] = run_tpch_files(1, file_root, conf)
        except BaseException as e:  # noqa: BLE001
            errors.append((name, repr(e)))

    PL.PrefetchIterator.__init__ = spy
    try:
        ts = [threading.Thread(target=worker, args=("on", conf_on),
                               name="q-on"),
              threading.Thread(target=worker, args=("off", conf_off),
                               name="q-off")]
        for t in ts:
            t.start()
        _join_all(ts)
    finally:
        PL.PrefetchIterator.__init__ = saved
    assert not errors, errors
    for name in ("on", "off"):
        assert_frame_equal(results[name].reset_index(drop=True),
                           ref.reset_index(drop=True))
    # the off query's thread (and no producer it could have started)
    # made no prefetch iterator; the on query made some
    assert producers.get("q-off", 0) == 0, producers
    assert sum(producers.values()) > 0, producers
    _assert_no_leaks()


# ---------------------------------------------------------------------------
# targeted fault injection: the victim alone is affected
def test_oom_injection_hits_victim_only(tables):
    from spark_rapids_tpu_torch.memory import retry as R
    victim_conf = _conf(**{
        "spark.rapids.memory.faultInjection.oomRate": 1.0,
        "spark.rapids.memory.faultInjection.seed": 7,
        "spark.rapids.memory.faultInjection.maxInjections": 16})
    clean_conf = _conf()
    ref = {q: _run_tpch(q, tables, _conf()) for q in (1, 5)}
    R.reset_oom_injection()
    results: dict = {}
    errors: list = []

    def worker(name, q, conf):
        try:
            results[name] = _run_tpch(q, tables, conf)
        except BaseException as e:  # noqa: BLE001
            errors.append((name, repr(e)))

    ts = [threading.Thread(target=worker, args=("victim", 1, victim_conf)),
          threading.Thread(target=worker, args=("clean-1", 5, clean_conf)),
          threading.Thread(target=worker, args=("clean-2", 1, clean_conf))]
    for t in ts:
        t.start()
    _join_all(ts)
    assert not errors, errors
    assert_frame_equal(results["victim"].reset_index(drop=True),
                       ref[1].reset_index(drop=True))
    assert_frame_equal(results["clean-1"].reset_index(drop=True),
                       ref[5].reset_index(drop=True))
    assert_frame_equal(results["clean-2"].reset_index(drop=True),
                       ref[1].reset_index(drop=True))
    # injectors are keyed by their conf: only the victim's exists
    assert set(R._injectors) <= {(1.0, 7, 16)}, R._injectors
    R.reset_oom_injection()
    _assert_no_leaks()


def test_hang_injection_cancels_victim_only(tables, file_root):
    """A hang injected at the producer of the victim's file scan cancels
    the victim alone; two clean queries beside it complete."""
    victim_conf = _conf(**{
        "spark.rapids.memory.faultInjection.hangSite": "producer",
        "spark.rapids.memory.faultInjection.hangAfterBatches": 1,
        "spark.rapids.sql.watchdog.taskTimeout": 2.0,
        "spark.rapids.sql.watchdog.pollInterval": 0.1})
    clean_conf = _conf()
    ref = _run_tpch(5, tables, _conf())
    results: dict = {}
    outcomes: dict = {}
    W.reset_hang_injection()

    def victim():
        try:
            run_tpch_files(1, file_root, victim_conf)
            outcomes["victim"] = "completed"
        except W.TpuQueryTimeout:
            outcomes["victim"] = "cancelled"
        except BaseException as e:  # noqa: BLE001
            outcomes["victim"] = f"unexpected: {e!r}"

    def clean(name):
        try:
            results[name] = _run_tpch(5, tables, clean_conf)
            outcomes[name] = "completed"
        except BaseException as e:  # noqa: BLE001
            outcomes[name] = f"unexpected: {e!r}"

    ts = [threading.Thread(target=victim),
          threading.Thread(target=clean, args=("clean-1",)),
          threading.Thread(target=clean, args=("clean-2",))]
    for t in ts:
        t.start()
    _join_all(ts)
    W.reset_hang_injection()
    assert outcomes.get("victim") == "cancelled", outcomes
    for name in ("clean-1", "clean-2"):
        assert outcomes.get(name) == "completed", outcomes
        assert_frame_equal(results[name].reset_index(drop=True),
                           ref.reset_index(drop=True))
    _assert_no_leaks()
    # the process stays healthy: the victim's query runs again clean
    rerun = run_tpch_files(1, file_root, clean_conf)
    assert_frame_equal(rerun.reset_index(drop=True), run_tpch_files(
        1, file_root, _conf()).reset_index(drop=True))


# ---------------------------------------------------------------------------
# fair-share semaphore
def _ctx_for(qc: QueryContext, tid: int) -> TaskContext:
    ctx = TaskContext(tid)
    ctx.query_ctx = qc
    return ctx


def test_semaphore_fair_share_across_queries():
    """A heavy query holding permits with a FIFO backlog does not starve
    a light one: the waiter of the query with the FEWEST holds wins the
    freed permit, even arriving last."""
    sem = TpuSemaphore(2)
    heavy, light = QueryContext(C.RapidsConf()), QueryContext(C.RapidsConf())
    order: list = []
    h1, h2 = _ctx_for(heavy, 1), _ctx_for(heavy, 2)
    sem.acquire_if_necessary(h1)
    sem.acquire_if_necessary(h2)

    def waiter(name, ctx):
        sem.acquire_if_necessary(ctx)
        order.append(name)
        sem.release_all(ctx)

    t_h3 = threading.Thread(target=waiter,
                            args=("heavy-3", _ctx_for(heavy, 3)))
    t_h4 = threading.Thread(target=waiter,
                            args=("heavy-4", _ctx_for(heavy, 4)))
    t_h3.start()
    t_h4.start()
    time.sleep(0.2)
    t_l = threading.Thread(target=waiter,
                           args=("light-1", _ctx_for(light, 5)))
    t_l.start()
    time.sleep(0.2)
    snap = sem.snapshot()
    assert len(snap["waiters"]) == 3, snap
    assert snap["queryHolds"] == {heavy.query_id: 2}, snap
    sem.release_all(h1)
    for t in (t_h3, t_h4, t_l):
        t.join(30)
    assert order[0] == "light-1", order
    sem.release_all(h2)
    assert sem.snapshot()["refs"] == {}
    assert sem.snapshot()["longestWaitMs"] > 0


def test_semaphore_yielded_keeps_queue_position():
    """A task re-acquiring after yielded() outranks waiters that arrived
    while it was parked."""
    sem = TpuSemaphore(1)
    qa, qb = QueryContext(C.RapidsConf()), QueryContext(C.RapidsConf())
    a = _ctx_for(qa, 1)
    sem.acquire_if_necessary(a)
    in_yield = threading.Event()
    release_yield = threading.Event()
    order: list = []

    def yielder():
        with sem.yielded(a):
            in_yield.set()
            assert release_yield.wait(30)
        order.append("yielder-back")
        sem.release_all(a)

    t_y = threading.Thread(target=yielder)
    t_y.start()
    assert in_yield.wait(30)
    b = _ctx_for(qb, 2)
    sem.acquire_if_necessary(b)

    def late_waiter():
        ctx = _ctx_for(qb, 3)
        sem.acquire_if_necessary(ctx)
        order.append("late-waiter")
        sem.release_all(ctx)

    t_l = threading.Thread(target=late_waiter)
    t_l.start()
    time.sleep(0.2)
    release_yield.set()
    time.sleep(0.2)
    sem.release_all(b)
    t_y.join(30)
    t_l.join(30)
    assert order == ["yielder-back", "late-waiter"], order
    assert sem.snapshot()["refs"] == {}


def test_semaphore_group_falls_back_to_the_current_query():
    """A task with no query of its own charges the thread's current
    query (the reference's fallback)."""
    qc = QueryContext(C.RapidsConf())
    with S.scoped(qc):
        assert TpuSemaphore._group_of(TaskContext(9)) == qc.query_id
    assert TpuSemaphore._group_of(TaskContext(9)) == ("task", 9)


# ---------------------------------------------------------------------------
# result cache
def test_result_cache_hit_bit_exact_and_conf_invalidation(tables):
    cache = result_cache()
    cache.clear()
    base = cache.stats()
    t = TD.sources(tables, 2)
    conf = _conf(**{"spark.rapids.sql.scheduler.resultCache.enabled": True})

    def run(plan):
        return plan_collect(accelerate(plan, conf, device="cpu"), conf)

    first = run(QUERIES[1](t, run))
    assert cache.stats()["stores"] == base["stores"] + 1
    second = run(QUERIES[1](t, run))
    assert cache.stats()["hits"] == base["hits"] + 1
    assert_frame_equal(second.reset_index(drop=True),
                       first.reset_index(drop=True), check_exact=True)
    # a hit is a COPY: mutating it does not poison the cache
    second.iloc[0, second.columns.get_loc("sum_qty")] = -1
    third = run(QUERIES[1](t, run))
    assert_frame_equal(third.reset_index(drop=True),
                       first.reset_index(drop=True))
    # ANY conf change misses
    conf2 = conf.set("spark.rapids.sql.pipeline.prefetchDepth", 3)

    def run2(plan):
        return plan_collect(accelerate(plan, conf2, device="cpu"), conf2)

    hits_before = cache.stats()["hits"]
    fourth = run2(QUERIES[1](t, run2))
    assert cache.stats()["hits"] == hits_before
    assert_frame_equal(fourth.reset_index(drop=True),
                       first.reset_index(drop=True))
    # new source objects also miss: identity keys the entry
    t2 = TD.sources(tables, 2)
    hits_before = cache.stats()["hits"]
    fifth = run(QUERIES[1](t2, run))
    assert cache.stats()["hits"] == hits_before
    assert_frame_equal(fifth.reset_index(drop=True),
                       first.reset_index(drop=True))
    # another query over the same sources misses (structure keys it)
    hits_before = cache.stats()["hits"]
    run(QUERIES[6](t, run))
    assert cache.stats()["hits"] == hits_before
    cache.clear()


@pytest.mark.parametrize("old,new", [("Brand#12", "Brand#13"),
                                     ("SM PKG", "WRAP PKG")])
def test_result_cache_keys_literals_at_any_depth(tables, monkeypatch, old,
                                                 new):
    """Two Q19 plans over the same sources that differ in one literal (a
    brand, or one container of an InSet, deep in the filter's left-deep
    AND/OR tree, as a throughput stream's substitution parameters make
    them) get different keys: the second misses, and each equals its own
    uncached run."""
    from spark_rapids_tpu_torch.models import tpch_queries as TQ
    cache = result_cache()
    cache.clear()
    # eight lineitems of Q19's small-quantity bracket on parts 0-7:
    # parts 0-3 Brand#13 in an SM BOX, parts 4-7 Brand#12 in a WRAP PKG,
    # so either substitution selects four of them and the original none
    li, part = tables["lineitem"].copy(), tables["part"].copy()
    li.loc[:7, "l_partkey"] = np.arange(8)
    li.loc[:7, "l_quantity"] = 5.0
    li.loc[:7, "l_shipmode"] = "AIR"
    li.loc[:7, "l_shipinstruct"] = "DELIVER IN PERSON"
    part.loc[:7, "p_size"] = 3
    part.loc[:3, "p_brand"] = "Brand#13"
    part.loc[:3, "p_container"] = "SM BOX"
    part.loc[4:7, "p_brand"] = "Brand#12"
    part.loc[4:7, "p_container"] = "WRAP PKG"
    t = TD.sources({**tables, "lineitem": li, "part": part}, 2)
    conf = _conf(**{"spark.rapids.sql.scheduler.resultCache.enabled": True})

    def run(plan, c=conf):
        return plan_collect(accelerate(plan, c, device="cpu"), c)

    lit, inset = TQ.lit, TQ.InSet
    first = run(TQ.q19(t, run))
    monkeypatch.setattr(TQ, "lit", lambda v: lit(new if v == old else v))
    monkeypatch.setattr(TQ, "InSet", lambda c, vs: inset(
        c, tuple(new if v == old else v for v in vs)))
    stats = cache.stats()
    second = run(TQ.q19(t, run))
    assert cache.stats()["hits"] == stats["hits"], "a changed literal hit"
    assert cache.stats()["stores"] == stats["stores"] + 1
    uncached = run(TQ.q19(t, run), _conf())
    assert_frame_equal(second.reset_index(drop=True),
                       uncached.reset_index(drop=True), check_exact=True)
    monkeypatch.undo()
    assert_frame_equal(first.reset_index(drop=True),
                       run(TQ.q19(t, run), _conf()).reset_index(drop=True),
                       check_exact=True)
    assert not first.equals(second), \
        f"substituting {new} for {old} left Q19's revenue as it was"
    cache.clear()


def test_result_cache_key_refuses_what_it_cannot_key():
    """A value the fingerprint cannot key exactly (a foreign object such
    as an array, or a cycle) makes the plan uncached, never keyed by its
    type name alone; scalars are keyed by type and value."""
    import torch
    sig = S._value_sig
    assert len({sig((1,)), sig((True,)), sig((1.0,)), sig(("1",))}) == 4
    for bad in (object(), np.arange(4), torch.tensor([1.0])):
        with pytest.raises(S._Unkeyable):
            sig(bad)
    loop: list = []
    loop.append(loop)
    with pytest.raises(S._Unkeyable):
        sig(loop)


def test_result_cache_byte_bound_evicts():
    from spark_rapids_tpu_torch.exec.scheduler import ResultCache, _CacheKey
    big = pd.DataFrame({"x": np.arange(1000, dtype=np.int64)})
    for cache_cls, key_cls in ((ResultCache, _CacheKey),
                               (RS.ResultCache, RS._CacheKey)):
        rc = cache_cls()
        keys = [key_cls(f"k{i}", (), ()) for i in range(4)]
        nbytes = cache_cls._df_bytes(big)
        for k in keys:
            rc.put(k, big, max_bytes=nbytes * 2 + 16)
        st = rc.stats()
        assert st["entries"] == 2 and st["evictions"] == 2, st
        assert rc.get(keys[0]) is None
        assert rc.get(keys[3]) is not None
        rc2 = cache_cls()
        rc2.put(keys[0], big, max_bytes=nbytes - 1)
        assert rc2.stats()["stores"] == 0


def test_result_cache_disabled_by_default(tables):
    cache = result_cache()
    cache.clear()
    before = cache.stats()
    _run_tpch(6, tables, _conf())
    after = cache.stats()
    assert after["stores"] == before["stores"]
    assert after["hits"] == before["hits"]
    assert C.RapidsConf()[C.RESULT_CACHE_ENABLED] is \
        RC.RapidsConf()[RC.RESULT_CACHE_ENABLED] is False


# ---------------------------------------------------------------------------
# scheduler bookkeeping
def test_query_context_reuse_nested_collect():
    """A nested collect inside a query reuses the QueryContext: one
    admission, one query id."""

    class _NestedCollectExec(UnaryExecBase):
        def __init__(self, child, inner: TpuExec):
            super().__init__(child)
            self.inner = inner
            self.seen_qids: list = []

        def output_schema(self):
            return self.child.output_schema()

        def process_partition(self, batches):
            self.seen_qids.append(S.current().query_id)
            self.inner.collect()      # nested: must NOT admit again
            self.seen_qids.append(S.current().query_id)
            yield from batches

    plan = _NestedCollectExec(_source(8), _source(8))
    sched_before = QueryScheduler.get().stats()["admitted"]
    with C.session(_conf()):
        out = plan.collect().to_pandas()
    assert out["x"].sum() == 28
    assert len(set(plan.seen_qids)) == 1
    assert QueryScheduler.get().stats()["admitted"] == sched_before + 1
    _assert_no_leaks()


def test_semaphore_yield_with_a_sibling_thread_of_the_task():
    """A prefetch producer shares its creator's task: while one thread of
    the task is yielded (parked on a full queue), a sibling thread of the
    same task takes the permit again and ends without releasing it (the
    task still holds it).  The yielded thread must rejoin that hold, not
    wait for a second permit behind its own task (the deadlock a file
    scan under concurrentGpuTasks=1 hit on the card)."""
    sem = TpuSemaphore(1)
    ctx = TaskContext(7)
    sem.acquire_if_necessary(ctx)
    in_yield = threading.Event()
    sibling_done = threading.Event()
    out: list = []

    def yielder():
        TaskContext.set_current(ctx)
        with sem.yielded():
            in_yield.set()
            assert sibling_done.wait(30)
        out.append(sem.holds(ctx))

    def sibling():
        assert in_yield.wait(30)
        TaskContext.set_current(ctx)
        sem.acquire_if_necessary()   # the task's permit, taken again
        sibling_done.set()

    ts = [threading.Thread(target=yielder), threading.Thread(target=sibling)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert not any(t.is_alive() for t in ts), "the yielded thread deadlocked"
    assert out == [2]                 # its own ref and the sibling's
    assert sem.available_permits() == 0
    sem.release_all(ctx)
    assert sem.available_permits() == 1
