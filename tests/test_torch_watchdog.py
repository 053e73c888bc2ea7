"""spark_rapids_tpu_torch's query watchdog (utils/watchdog.py) against
spark_rapids_tpu's, twins of 13 of the 16 tests of tests/test_watchdog.py:
the cancel token, heartbeats and the scanner (stalled, beating, paused,
disabled), deadline resolution, the dump's sections, cancellable sleeps,
the single-flight build waiter, leaked-producer accounting, seeded hangs
through TPC-H (each times out within 2x its deadline plus a margin,
names its site, leaks nothing, and the same query then runs clean and
bit-exact), the watchdog metrics on the plan root, and results with the
watchdog on and off (and against the JAX package's engine).  Added: the
AttemptToken and the seeded slow injector against the reference's (the
speculation layer, ROADMAP.md item 8, calls them).

Intended differences: the reference's "compile" site is its XLA compile
(KernelCache); the port's kernels are built by nvcc in ops/cuda_build.py,
so the compile site and the single-flight waiter are held on `build()`
with a stand-in nvcc (no compiler runs on the CPU), not on a TPC-H query,
whose CPU run builds no kernel.  The port prefetches at the file scan
alone, so the seeded producer hangs run their TPC-H query over the
tables as Parquet files (the reference's run over memory).  The dump
has no section for in-flight
shuffle fetches (the shuffle manager, ROADMAP.md item 8).

Left out, with the layer that brings them: the shuffle-server stall and
the collective hang (the shuffle manager and the device mesh, item 8)
and the pyudf worker hang (the Python UDF workers, item 10).

Watchdog polls are 0.1 s and deadlines at most 2 s; every thread join
and wait has its own timeout.
"""
import logging
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.models import tpch_bench as RB
from spark_rapids_tpu.models import tpch_data as RD
from spark_rapids_tpu.utils import watchdog as RW
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import scheduler as S
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.ops import cuda_build
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import watchdog as W
from test_torch_pipeline import run_tpch_files, write_tpch_files
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

DEADLINE = 2.0
POLL = 0.1


@pytest.fixture(autouse=True)
def clean_watchdog(one_torch_thread):  # noqa: F811
    W.reset_hang_injection()
    W.begin_query()
    yield
    W.reset_hang_injection()
    W.begin_query()


def _no_leaks(grace: float = 3.0):
    """Zero semaphore permits held and no live producer thread
    (cancelled producers unwind cooperatively: allow a short grace)."""
    sem = TpuSemaphore.get()
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        producers = [t for t in threading.enumerate()
                     if t.name.startswith("tpu-prefetch") and t.is_alive()]
        if sem.holders() == 0 and not producers:
            return
        time.sleep(0.05)
    assert sem.holders() == 0, f"leaked permits: {sem.snapshot()}"
    assert not producers, f"leaked producers: {producers}"


def _wd(site=None, after=0, deadline=DEADLINE, **extra):
    kv = {"spark.rapids.sql.watchdog.taskTimeout": deadline,
          "spark.rapids.sql.watchdog.collectiveTimeout": deadline,
          "spark.rapids.sql.watchdog.compileTimeout": deadline,
          "spark.rapids.sql.watchdog.pollInterval": POLL}
    if site is not None:
        kv["spark.rapids.memory.faultInjection.hangSite"] = site
        kv["spark.rapids.memory.faultInjection.hangAfterBatches"] = after
    kv.update(extra)
    return kv


# ---------------------------------------------------------------------------
# unit: token / heartbeat / scanner
def test_cancel_token_check_raises_with_dump():
    for mod in (W, RW):
        tok = mod.CancelToken()
        tok.check()  # not cancelled: no-op
        tok.cancel("stuck somewhere", dump="THE-DUMP")
        with pytest.raises(mod.TpuQueryTimeout,
                           match="stuck somewhere") as ei:
            tok.check()
        assert ei.value.dump == "THE-DUMP"
        assert "THE-DUMP" in str(ei.value)
        # one-shot: a second cancel cannot overwrite the first reason
        tok.cancel("other", dump=None)
        assert tok.reason == "stuck somewhere"


def test_watchdog_fires_on_stalled_heartbeat_within_2x_deadline():
    tok = W.begin_query()
    with C.session(C.RapidsConf(_wd(deadline=0.3))):
        hb = W.heartbeat("stalled-unit")
    t0 = time.monotonic()
    try:
        assert tok.wait(2 * 0.3 + 1.0), "the watchdog never fired"
        assert time.monotonic() - t0 <= 2 * 0.3 + 0.5
        assert "stalled-unit" in tok.reason
        assert "stalled-unit" in tok.dump
        qs = W.query_stats()
        assert qs["timeouts"] == 1 and qs["cancels"] == 1 \
            and qs["dumps"] == 1
    finally:
        hb.close()


def test_beating_heartbeat_does_not_fire():
    tok = W.begin_query()
    with C.session(C.RapidsConf(_wd(deadline=0.3))):
        hb = W.heartbeat("healthy-unit")
    try:
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end:
            hb.beat()
            time.sleep(0.05)
        assert not tok.cancelled
    finally:
        hb.close()


def test_paused_heartbeat_does_not_fire():
    """Backpressure parking (a producer on a full queue) is no hang."""
    tok = W.begin_query()
    with C.session(C.RapidsConf(_wd(deadline=0.3))):
        hb = W.heartbeat("parked-unit")
    try:
        with hb.pause():
            time.sleep(1.0)
        assert not tok.cancelled
    finally:
        hb.close()


def test_disabled_watchdog_registers_nothing():
    conf = C.RapidsConf({"spark.rapids.sql.watchdog.enabled": False})
    with C.session(conf):
        hb = W.heartbeat("disabled-unit")
    assert hb is W._NULL_HB
    hb.beat()
    with hb.pause():
        pass
    hb.close()
    assert all(h.name != "disabled-unit" for h in W.active_heartbeats())


def test_deadline_resolution_conf_beats_global_default():
    conf = C.RapidsConf({C.WATCHDOG_TASK_TIMEOUT.key: 1.25})
    W.configure_global(task_timeout=420.0)
    try:
        # an explicit session setting beats the harness default ...
        assert W.deadline_for("task", conf) == 1.25
        # ... which beats the registry default
        assert W.deadline_for("task", C.RapidsConf()) == 420.0
        assert W.deadline_for("compile", C.RapidsConf()) == 600.0
    finally:
        W.configure_global()
    # the registry defaults are the reference's
    for kind in ("task", "collective", "compile"):
        assert W.deadline_for(kind, C.RapidsConf()) == \
            RW.deadline_for(kind, RC.RapidsConf({
                RW._DEADLINE_ENTRIES[kind].key:
                    RW._DEADLINE_ENTRIES[kind].default}))


def test_dump_sections_present():
    dump = W.build_dump()
    for section in ("heartbeats", "semaphore", "query scheduler",
                    "prefetch pipeline", "device memory", "hang injection",
                    "thread stacks"):
        assert f"-- {section} --" in dump, f"dump misses {section!r}"
    assert "MainThread" in dump


def test_cancellable_sleep_aborts_on_cancel():
    tok = W.begin_query()

    def cancel_soon():
        time.sleep(0.2)
        tok.cancel("abort the backoff")

    threading.Thread(target=cancel_soon, daemon=True).start()
    t0 = time.monotonic()
    with pytest.raises(W.TpuQueryTimeout):
        W.cancellable_sleep(30.0)
    assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# the nvcc build: single-flight waiter and the compile hang site
@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A stand-in kernel source and nvcc (a script that writes its -o
    file), so build() runs its whole path on the CPU."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// stand-in source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('built')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", csrc / "build")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    return csrc / "build" / "libfake.so"


def test_kernel_single_flight_waiter_timeout_builds_itself(fake_build):
    """A build waiter whose peer's build outlives the compile deadline
    builds in its own thread (a benign double build), never waits on a
    wedged peer nor goes on without the library."""
    held = threading.Event()
    release = threading.Event()

    def wedged_peer():
        with cuda_build._LOCK:
            held.set()
            release.wait(20.0)

    t = threading.Thread(target=wedged_peer, daemon=True)
    t.start()
    assert held.wait(5.0)
    conf = C.RapidsConf({"spark.rapids.sql.watchdog.compileTimeout": 0.4,
                         "spark.rapids.sql.watchdog.taskTimeout": 60.0})
    t0 = time.monotonic()
    try:
        with C.session(conf):
            logs = cuda_build.build(("fake",))
        assert set(logs) == {"fake"}
        assert fake_build.read_text() == "built"
        assert 0.3 < time.monotonic() - t0 < 5.0
    finally:
        release.set()
        t.join(5.0)
    # nothing stale now: a second build is a no-op
    with C.session(conf):
        assert cuda_build.build(("fake",)) == {}


def test_compile_hang_site_times_out_then_builds_clean(fake_build):
    """The compile site: the first nvcc build hangs, the watchdog's
    compile deadline cancels it with a dump naming the site, and the
    same build then runs clean."""
    conf = C.RapidsConf(_wd(site="compile", after=0))
    t0 = time.monotonic()
    with C.session(conf):
        scope = S.QueryScope(conf)
        try:
            with pytest.raises(W.TpuQueryTimeout) as ei:
                cuda_build.build(("fake",))
        finally:
            scope.close()
    assert time.monotonic() - t0 < 2 * DEADLINE + 5.0
    msg = str(ei.value)
    assert "compile" in msg and "watchdog" in msg
    assert not fake_build.exists()
    W.reset_hang_injection()
    with C.session(C.RapidsConf(_wd())):
        assert set(cuda_build.build(("fake",))) == {"fake"}
    assert fake_build.read_text() == "built"


# ---------------------------------------------------------------------------
# leaked producer accounting
def test_leaked_producer_counted_and_stack_logged(monkeypatch, caplog):
    from spark_rapids_tpu_torch.exec import pipeline as P
    monkeypatch.setattr(P, "_JOIN_TIMEOUT_S", 0.2)
    release = threading.Event()

    def wedged():
        yield 1
        release.wait(10.0)  # ignores close(); outlives the join
        yield 2

    before = P.pipeline_stats()["leaked_producers"]
    it = P.PrefetchIterator(wedged(), depth=1)
    assert next(it) == 1
    time.sleep(0.1)  # the producer enters the wedged wait
    try:
        with caplog.at_level(logging.WARNING,
                             logger="spark_rapids_tpu_torch.pipeline"):
            it.close()
        assert P.pipeline_stats()["leaked_producers"] == before + 1
        assert any("survived" in r.message and "wedged" in r.message
                   for r in caplog.records)
        assert "leaked_producers" in W.build_dump()
    finally:
        release.set()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and any(
                t.name.startswith("tpu-prefetch")
                for t in threading.enumerate()):
            time.sleep(0.05)


# ---------------------------------------------------------------------------
# hang injection through TPC-H
SCALE = 600


@pytest.fixture(scope="module")
def tables():
    return TD.gen_tables(np.random.default_rng(11), SCALE)


@pytest.fixture(scope="module")
def file_root(tables, tmp_path_factory):
    return write_tpch_files(tables, tmp_path_factory.mktemp("tpch"))


def _run_q(query, tables, extra=None):
    conf = C.RapidsConf({**TB.BENCH_CONF, **(extra or {})})
    return TB.run_query(query, tables, device="cpu", conf=conf)


def _run_q_files(query, root, extra=None):
    conf = C.RapidsConf({**TB.BENCH_CONF, **(extra or {})})
    return run_tpch_files(query, root, conf)


def _assert_bit_exact(expected, got, label):
    pd.testing.assert_frame_equal(expected, got, check_exact=True,
                                  obj=f"{label} (bit-exact)")


@pytest.mark.parametrize("query,site,after", [
    (1, "producer", 1),
    (5, "producer", 2),
])
def test_tpch_hang_site_times_out_then_runs_clean(file_root, query, site,
                                                  after):
    """A seeded hang mid-query (in a file scan's producer) raises a
    descriptive TpuQueryTimeout within ~2x the deadline, names the stuck
    site, leaks nothing, and leaves the process healthy: the same query
    runs again bit-exact."""
    base = _run_q_files(query, file_root)
    W.reset_hang_injection()
    t0 = time.monotonic()
    with pytest.raises(W.TpuQueryTimeout) as ei:
        _run_q_files(query, file_root, extra=_wd(site=site, after=after))
    elapsed = time.monotonic() - t0
    assert elapsed < 2 * DEADLINE + 10.0, f"took {elapsed:.1f}s"
    msg = str(ei.value)
    assert site in msg, f"the dump does not name {site}: {msg[:400]}"
    assert "watchdog" in msg
    _no_leaks()
    W.reset_hang_injection()
    W.begin_query()
    got = _run_q_files(query, file_root)
    _assert_bit_exact(base, got, f"q{query} after the {site} timeout")
    assert TpuSemaphore.get().holders() == 0


def test_watchdog_metrics_charged_to_plan_root(file_root):
    from spark_rapids_tpu_torch import io as pio
    from spark_rapids_tpu_torch.models.tpch_queries import QUERIES
    from spark_rapids_tpu_torch.plan.overrides import accelerate, collect
    conf = C.RapidsConf({**TB.BENCH_CONF, **_wd(site="producer", after=1)})
    W.reset_hang_injection()
    plans = []

    def run(p):
        plan = accelerate(p, conf, device="cpu")
        plans.append(plan)
        return collect(plan, conf)

    with pytest.raises(W.TpuQueryTimeout):
        run(QUERIES[1]({"lineitem": pio.read_parquet(
            str(file_root / "lineitem"))}, run))
    m = plans[-1].metrics.as_dict()
    assert m.get(M.NUM_WATCHDOG_TIMEOUTS, 0) >= 1, m
    assert m.get(M.NUM_CANCELS, 0) >= 1, m
    assert m.get(M.WATCHDOG_DUMPS, 0) >= 1, m
    assert m.get(M.SLOWEST_HEARTBEAT, 0) >= DEADLINE * 1000, m
    _no_leaks()


def test_tpch_unaffected_by_enabled_watchdog(tables):
    """The watchdog only observes: on (default deadlines) and off give
    the same bits, and both agree with the reference's engine."""
    on = _run_q(1, tables)
    off = _run_q(1, tables,
                 extra={"spark.rapids.sql.watchdog.enabled": False})
    _assert_bit_exact(on, off, "q1 watchdog on/off")
    ref = RB.run_query(1, RD.gen_tables(np.random.default_rng(11), SCALE),
                       conf=RC.RapidsConf(dict(RB.BENCH_CONF)))
    compare_frames(ref, on, "q1")


def test_attempt_token_and_slow_injection_match_the_reference():
    """The pieces the speculation layer (ROADMAP.md item 8) will call,
    against the reference's: an AttemptToken honors its parent, a lost
    race is marked, and the seeded slow injector delays the same sites
    by the same seeded amounts."""
    for mod in (W, RW):
        parent = mod.CancelToken()
        att = mod.AttemptToken(parent)
        with mod.attempt_scope(att):
            assert mod.current_token() is att
            mod.check_cancelled()
        att.cancel_race_lost("the sibling won")
        assert att.race_lost and att.cancelled and not parent.cancelled
        other = mod.AttemptToken(parent)
        parent.cancel("query cancelled")
        assert other.cancelled and other.wait(0.01)
        with pytest.raises(mod.TpuQueryTimeout, match="query cancelled"):
            other.check()
    settings = {"spark.rapids.memory.faultInjection.slowSite": "map-task",
                "spark.rapids.memory.faultInjection.slowFactor": 2.0,
                "spark.rapids.memory.faultInjection.slowSeed": 5,
                "spark.rapids.memory.faultInjection.slowUnitMs": 1.0}
    W.reset_slow_injection()
    RW.reset_slow_injection()
    W.begin_query()
    RW.begin_query()
    got = [W.maybe_slow("map-task", C.RapidsConf(settings))
           for _ in range(5)]
    want = [RW.maybe_slow("map-task", RC.RapidsConf(settings))
            for _ in range(5)]
    assert got == want and all(d > 0 for d in got)
    assert W.maybe_slow("shuffle-server", C.RapidsConf(settings)) == 0.0
    assert W.slow_injection_counts() == {"map-task": 5}
    W.reset_slow_injection()
    RW.reset_slow_injection()


def test_a_consumer_waiting_on_a_beating_producer_is_not_hung():
    """A producer whose source waits on an upstream producer (a reduce
    side behind its map side) for longer than the deadline, while the
    upstream keeps beating, is not declared hung: its wait is the
    upstream's to answer for (at SF10 under three streams a coalesce
    producer behind a long exchange map side was cancelled)."""
    from spark_rapids_tpu_torch.exec.pipeline import PrefetchIterator

    def slow_upstream():
        for i in range(6):
            time.sleep(0.5)   # well under the deadline each, 3 s in all
            yield i

    def downstream(up):
        # like an exchange: the whole upstream before the first item
        yield sum(up)

    conf = C.RapidsConf(_wd(deadline=DEADLINE))
    with C.session(conf):
        scope = S.QueryScope(conf)
        try:
            up = PrefetchIterator(slow_upstream(), depth=2)
            got = list(PrefetchIterator(downstream(up), depth=2))
            assert not scope.qc.token.cancelled, scope.qc.token.reason
        finally:
            scope.close()
    assert got == [15]
