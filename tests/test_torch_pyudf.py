"""spark_rapids_tpu_torch's pandas UDF execs, Python worker semaphore,
worker pool and daemon (pyudf/) against spark_rapids_tpu's: twins of the
15 pandas-exec, semaphore, worker-pool and daemon cases of
tests/test_udf.py (its compiler and planner cases are in
tests/test_torch_udf.py), and the daemon's crash and hang paths.

Each exec's result through the port's planner (device="cpu") is held
against the JAX package's accelerated result on the same frame, and
against the port's own CPU engine; rows exact, floats equal.  The pool
tests hold the worker's answers against the values Python gives.  The
twin of test_worker_pins_cpu_platform checks that a daemon worker runs
with CUDA_VISIBLE_DEVICES empty and never imports torch or the port's
kernels.  The daemon's pools of one or two workers are spawned per test
(a worker imports pandas, pyarrow and cloudpickle, ~1 s here).  ~15 s
alone.
"""
import os
import threading
import time
import types

import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import pyudf as rpyudf
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.exec.base import TpuExec as RTpuExec
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.exprs.base import lit as rlit
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import pyudf
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exprs.base import col, lit
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O
from spark_rapids_tpu_torch.pyudf import daemon
from test_torch_profile import reset_observability
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture
from test_torch_udf import _assert_same, _df

REF = types.SimpleNamespace(C=RC, T=RT, col=rcol, lit=rlit, N=RN,
                            P=rpyudf, Exec=RTpuExec, kw={},
                            accelerate=RO.accelerate, collect=RO.collect)
PORT = types.SimpleNamespace(C=C, T=T, col=col, lit=lit, N=N, P=pyudf,
                             Exec=TpuExec, kw={"device": "cpu"},
                             accelerate=O.accelerate, collect=O.collect)
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield
    pyudf.PythonWorkerSemaphore.shutdown()
    daemon.PythonWorkerPool.reset()


def _run(m, plan, c):
    out = m.accelerate(plan, c, **m.kw)
    return out, m.collect(out, c)


def _both(build, enable: str, extra=None, sort_by=None):
    """`build(m)` accelerated in each package with the exec `enable`d:
    both plans run wholly on the device; the port's result equals the
    reference's and the port's CPU engine's.  Returns the port's."""
    settings = {f"spark.rapids.sql.exec.{enable}": True, **(extra or {})}
    outs = []
    for m in BOTH:
        plan, out = _run(m, build(m), m.C.RapidsConf(settings))
        assert isinstance(plan, m.Exec), plan
        outs.append(out)
    want, got = outs
    cpu = build(PORT).collect()
    if sort_by:
        want, got, cpu = (f.sort_values(sort_by, ignore_index=True)
                          for f in (want, got, cpu))
    _assert_same(want, got)
    _assert_same(cpu, got)
    return got


def _vscale(x):
    return x.astype("Float64") * 2.5


def _scaled(m, df=None):
    spec = m.P.exec.PandasUdfSpec("scaled", m.P.pandas_udf(m.T.FLOAT64)(
        _vscale), m.T.FLOAT64, (m.col("a"),))
    return m.P.CpuArrowEvalPython(
        [spec], m.N.CpuSource.from_pandas(_df() if df is None else df, 2))


# -- the pandas UDF execs ----------------------------------------------------
def test_arrow_eval_python_exec_parity():
    got = _both(_scaled, "CpuArrowEvalPython")
    assert got["scaled"].tolist()[:2] == [2.5, 12.5]


def test_arrow_eval_python_disabled_by_default():
    for m in BOTH:
        spec = m.P.exec.PandasUdfSpec("r", lambda s: s, m.T.INT64,
                                      (m.col("a"),))
        plan = m.P.CpuArrowEvalPython([spec],
                                      m.N.CpuSource.from_pandas(_df()))
        assert not isinstance(m.accelerate(plan, m.C.RapidsConf(), **m.kw),
                              m.Exec)


def _doubler(frames):
    for df in frames:
        yield pd.DataFrame({"x2": df["a"].astype("Int64") * 2})


def test_map_in_pandas_parity():
    _both(lambda m: m.P.CpuMapInPandas(
        _doubler, m.T.Schema.of(("x2", m.T.INT64)),
        m.N.CpuSource.from_pandas(_df(), 2)), "CpuMapInPandas")


def test_python_worker_semaphore_caps_concurrency():
    sem = pyudf.PythonWorkerSemaphore.initialize(2)
    peak = [0]

    def work():
        with sem.held():
            peak[0] = max(peak[0], sem.active)
            time.sleep(0.02)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] == 2 and sem.active == 0


def _grouped_df():
    return pd.DataFrame({
        "k": pd.array([1, 2, 1, None, 2, 1], dtype="Int64"),
        "v": pd.array([10.0, 20.0, 30.0, 40.0, None, 60.0],
                      dtype="Float64"),
    })


def _summarize(g):
    return pd.DataFrame({
        "k": g["k"].iloc[:1],
        "total": pd.array([g["v"].sum(skipna=True)], dtype="Float64")})


def test_flat_map_groups_in_pandas_parity():
    _both(lambda m: m.P.CpuFlatMapGroupsInPandas(
        ["k"], _summarize, m.T.Schema.of(("k", m.T.INT64),
                                         ("total", m.T.FLOAT64)),
        m.N.CpuSource.from_pandas(_grouped_df(), 2)),
        "CpuFlatMapGroupsInPandas")


def _vmean(x):
    return float(x.mean()) if x.notna().any() else None


def test_aggregate_in_pandas_parity():
    out = _both(lambda m: m.P.CpuAggregateInPandas(
        ["k"], [m.P.exec.PandasUdfSpec("mean_v", _vmean, m.T.FLOAT64,
                                       (m.col("v"),))],
        m.N.CpuSource.from_pandas(_grouped_df(), 2)),
        "CpuAggregateInPandas")
    assert len(out) == 3  # keys 1 and 2 and the null group


def _vmax(x):
    return float(x.max()) if x.notna().any() else None


def test_window_in_pandas_parity():
    out = _both(lambda m: m.P.CpuWindowInPandas(
        ["k"], [m.P.exec.PandasUdfSpec("max_v", _vmax, m.T.FLOAT64,
                                       (m.col("v"),))],
        m.N.CpuSource.from_pandas(_grouped_df(), 2)),
        "CpuWindowInPandas", sort_by=["k", "v"])
    assert len(out) == 6
    assert out[out["k"] == 1]["max_v"].tolist() == [60.0, 60.0, 60.0]


def _merge(lg, rg):
    k = lg["k"].iloc[0] if len(lg) else rg["k2"].iloc[0]
    return pd.DataFrame({
        "k": pd.array([k], dtype="Int64"),
        "lsum": pd.array([lg["lv"].sum() if len(lg) else None],
                         dtype="Float64"),
        "rsum": pd.array([rg["rv"].sum() if len(rg) else None],
                         dtype="Float64")})


def test_flat_map_cogroups_in_pandas_parity():
    left = pd.DataFrame({"k": pd.array([1, 2, 1], dtype="Int64"),
                         "lv": pd.array([1.0, 2.0, 3.0], dtype="Float64")})
    right = pd.DataFrame({"k2": pd.array([2, 3], dtype="Int64"),
                          "rv": pd.array([20.0, 30.0], dtype="Float64")})
    out = _both(lambda m: m.P.CpuFlatMapCoGroupsInPandas(
        ["k"], ["k2"], _merge,
        m.T.Schema.of(("k", m.T.INT64), ("lsum", m.T.FLOAT64),
                      ("rsum", m.T.FLOAT64)),
        m.N.CpuSource.from_pandas(left, 2), m.N.CpuSource.from_pandas(right)),
        "CpuFlatMapCoGroupsInPandas")
    assert sorted(out["k"].tolist()) == [1, 2, 3]


def test_grouped_pandas_execs_disabled_by_default():
    for m in BOTH:
        spec = m.P.exec.PandasUdfSpec("r", lambda s: 0.0, m.T.FLOAT64,
                                      (m.col("v"),))
        schema = m.T.Schema.of(("k", m.T.INT64))
        src = m.N.CpuSource.from_pandas(_grouped_df())
        for plan in (m.P.CpuFlatMapGroupsInPandas(
                ["k"], lambda g: g[["k"]], schema, src),
                m.P.CpuAggregateInPandas(["k"], [spec], src),
                m.P.CpuWindowInPandas(["k"], [spec], src)):
            assert not isinstance(
                m.accelerate(plan, m.C.RapidsConf(), **m.kw), m.Exec)


# -- the worker pool and the daemon ------------------------------------------
def test_worker_pool_roundtrip_and_reuse():
    pool = daemon.PythonWorkerPool(max_workers=1)
    try:
        df = pd.DataFrame({"x": pd.array([1, 2, 3], dtype="Int64")})
        out1 = pool.run_udf(
            lambda f: pd.DataFrame({"y": f["x"] * 2, "pid": os.getpid()}),
            df)
        assert out1["y"].tolist() == [2, 4, 6]
        # the same worker process serves the second call
        out2 = pool.run_udf(
            lambda f: pd.DataFrame({"n": [len(f)], "pid": [os.getpid()]}),
            df)
        assert out2["n"].tolist() == [3]
        assert out1["pid"].iloc[0] == out2["pid"].iloc[0] != os.getpid()
    finally:
        pool.close()


def test_worker_pool_propagates_udf_errors_and_reuses_worker():
    def boom(frame):
        raise ValueError("udf exploded")

    pool = daemon.PythonWorkerPool(max_workers=1)
    try:
        with pytest.raises(daemon.PythonUdfError, match="udf exploded"):
            pool.run_udf(boom, pd.DataFrame({"x": [1]}))
        # the healthy worker survived and serves again: no respawn, no
        # leaked slot (which would deadlock with max_workers=1)
        out = pool.run_udf(lambda f: pd.DataFrame({"n": [len(f)]}),
                           pd.DataFrame({"x": [1, 2]}))
        assert out["n"].tolist() == [2]
    finally:
        pool.close()


def test_worker_pool_unpicklable_fn_does_not_leak_slot():
    pool = daemon.PythonWorkerPool(max_workers=1)
    try:
        with pytest.raises(Exception, match="[Pp]ickl"):
            pool.run_udf(lambda f, s=threading.Lock(): f,
                         pd.DataFrame({"x": [1]}))
        out = pool.run_udf(lambda f: pd.DataFrame({"n": [len(f)]}),
                           pd.DataFrame({"x": [1]}))
        assert out["n"].tolist() == [1]
    finally:
        pool.close()


def _probe(x):
    import sys
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("torch", "spark_rapids_tpu_torch"))
    return pd.Series([f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}|"
                      + ",".join(loaded)] * len(x))


def test_worker_pins_cpu_platform():
    """A daemon worker must not take the card from the executor: it runs
    with CUDA_VISIBLE_DEVICES empty unless
    spark.rapids.python.onTpu.enabled, and neither the protocol nor the
    exec's shipped UDF imports torch or the port's kernels there."""
    spec = pyudf.PandasUdfSpec("probe", _probe, T.STRING, (col("a"),))
    plan = pyudf.CpuArrowEvalPython([spec], N.CpuSource.from_pandas(_df()))
    c = C.RapidsConf({"spark.rapids.sql.exec.CpuArrowEvalPython": True,
                      "spark.rapids.python.daemon.enabled": True,
                      "spark.rapids.python.concurrentPythonWorkers": 1})
    out = O.collect(O.accelerate(plan, c, "cpu"), c)
    env, mods = out["probe"].iloc[0].split("|")
    assert env == "''"
    assert "torch" not in mods.split(",")
    assert set(mods.split(",")) <= {
        "spark_rapids_tpu_torch", "spark_rapids_tpu_torch.pyudf",
        "spark_rapids_tpu_torch.pyudf.worker"}
    # onTpu: the worker keeps the executor's CUDA_VISIBLE_DEVICES
    env_on = daemon._worker_env_from_conf(C.RapidsConf(
        {"spark.rapids.python.onTpu.enabled": True,
         "spark.rapids.python.memory.limitBytes": 1 << 40}))
    assert env_on == {"RAPIDS_PYTHON_ON_TPU": "true",
                      "RAPIDS_PYTHON_MEM_LIMIT_BYTES": str(1 << 40)}
    pool = daemon.PythonWorkerPool(1, env_on)
    try:
        assert pool._env.get("CUDA_VISIBLE_DEVICES") == \
            os.environ.get("CUDA_VISIBLE_DEVICES")
    finally:
        pool.close()


#: the daemon on, with one worker
DAEMON = {"spark.rapids.python.daemon.enabled": True,
          "spark.rapids.python.concurrentPythonWorkers": 1}


def test_arrow_eval_python_via_daemon_parity():
    """The daemon's result equals the JAX package's in-process one and
    the port's CPU engine's; a profiled query shows each worker round
    trip as a span of the udf category."""
    from spark_rapids_tpu_torch.utils import profile as P
    settings = {"spark.rapids.sql.exec.CpuArrowEvalPython": True}
    _, want = _run(REF, _scaled(REF), REF.C.RapidsConf(settings))
    c = C.RapidsConf({**settings, **DAEMON,
                      "spark.rapids.sql.profile.enabled": True})
    plan, got = _run(PORT, _scaled(PORT), c)
    assert isinstance(plan, TpuExec)
    _assert_same(want, got)
    _assert_same(_scaled(PORT).collect(), got)
    try:
        spans = [s for s in P.last_profile().spans if s.cat == P.CAT_UDF]
    finally:
        reset_observability()
    assert len(spans) == 2  # one per partition
    assert all(s.name.startswith("pyudf:pid") for s in spans)


def test_daemon_udf_with_all_literal_args():
    """A UDF whose arguments are all literals gets its row count
    through the worker pipe."""
    def const(x):
        return x * 1.0

    for m in BOTH:
        spec = m.P.exec.PandasUdfSpec("c", const, m.T.FLOAT64,
                                      (m.lit(2.5),))
        plan = m.P.CpuArrowEvalPython([spec],
                                      m.N.CpuSource.from_pandas(_df()))
        # the JAX package's in-process result (its daemon's workers
        # import JAX, seconds each) against the port's daemon
        _, m.got = _run(m, plan, m.C.RapidsConf(
            {"spark.rapids.sql.exec.CpuArrowEvalPython": True,
             **(DAEMON if m is PORT else {})}))
    assert PORT.got["c"].tolist() == [2.5] * 5
    _assert_same(REF.got, PORT.got)

    # no arguments at all: the worker still sees the batch's row count
    spec = pyudf.PandasUdfSpec("n", lambda: 7, T.INT64, ())
    plan = pyudf.CpuArrowEvalPython([spec], N.CpuSource.from_pandas(_df()))
    _, got = _run(PORT, plan, C.RapidsConf(
        {"spark.rapids.sql.exec.CpuArrowEvalPython": True,
         **DAEMON}))
    assert got["n"].tolist() == [7] * 5


def _crash(x):
    os._exit(3)


def test_a_worker_crash_fails_the_query_and_the_pool_recovers():
    """A worker that dies in the middle of a batch fails the query with
    WorkerCrash and records the crash event; the pool's next query
    spawns a fresh worker and runs."""
    from spark_rapids_tpu_torch.utils import profile as P
    settings = {"spark.rapids.sql.exec.CpuArrowEvalPython": True,
                **DAEMON}
    c = C.RapidsConf(settings)
    crash = pyudf.PandasUdfSpec("x", _crash, T.INT64, (col("a"),))
    plan = pyudf.CpuArrowEvalPython([crash], N.CpuSource.from_pandas(_df()))
    events = []
    real = P.event
    try:
        P.event = lambda kind, **f: events.append(kind)
        with pytest.raises(daemon.WorkerCrash):
            O.collect(O.accelerate(plan, c, "cpu"), c)
    finally:
        P.event = real
    assert P.EV_UDF_WORKER_CRASH in events
    _, got = _run(PORT, _scaled(PORT), c)
    assert got["scaled"].tolist()[:2] == [2.5, 12.5]


def test_a_hung_worker_is_cancelled_by_the_watchdog():
    """The pyudf hang site: the watchdog's task deadline cancels the
    query, and the pool's slot comes back (the next query runs)."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    settings = {"spark.rapids.sql.exec.CpuArrowEvalPython": True,
                **DAEMON}
    hang = C.RapidsConf({
        **settings, "spark.rapids.memory.faultInjection.hangSite": "pyudf",
        "spark.rapids.sql.watchdog.taskTimeout": 0.5,
        "spark.rapids.sql.watchdog.pollInterval": 0.1})
    W.reset_hang_injection()
    with pytest.raises(W.TpuQueryTimeout):
        O.collect(O.accelerate(_scaled(PORT), hang, "cpu"), hang)
    W.reset_hang_injection()
    c = C.RapidsConf(settings)
    _, got = _run(PORT, _scaled(PORT), c)
    assert got["scaled"].tolist()[:2] == [2.5, 12.5]
