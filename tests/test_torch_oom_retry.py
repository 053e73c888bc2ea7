"""spark_rapids_tpu_torch's OOM split-and-retry harness against
spark_rapids_tpu's, one twin per test of tests/test_oom_retry.py.

The lattice under test: reservation failure -> SpillCallback spill with
the semaphore yielded -> retry -> split-in-half -> recurse to the
minSplitRows floor -> graceful fallback (bestEffort) or actionable error.
Failures are synthetic (seeded `spark.rapids.memory.faultInjection.*`),
spills are real (tiny accounted budgets).  Every plan the port runs under
injection must equal the JAX package's UNINJECTED result on the same
seeded inputs, computed once per module: bit-exact (integer sums,
counts, keys, join pairs, sort order; the one float column, the window's
integer sums, exact too)."""
import threading

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exec import aggregate as RA
from spark_rapids_tpu.exec import joins as RJ
from spark_rapids_tpu.exec import sort as RSo
from spark_rapids_tpu.exec import window as RW
from spark_rapids_tpu.exec.basic import LocalBatchSource as RSource
from spark_rapids_tpu.exprs import aggregates as RAg
from spark_rapids_tpu.exprs.base import col as rcol
from spark_rapids_tpu.memory import retry as RR
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import aggregate as A
from spark_rapids_tpu_torch.exec import joins as J
from spark_rapids_tpu_torch.exec import sort as So
from spark_rapids_tpu_torch.exec import window as W
from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
from spark_rapids_tpu_torch.exprs import aggregates as Ag
from spark_rapids_tpu_torch.exprs.base import col
from spark_rapids_tpu_torch.memory import BufferId, ResourceEnv
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory.semaphore import TaskContext, TpuSemaphore
from spark_rapids_tpu_torch.plan.nodes import schema_of_df
from spark_rapids_tpu_torch.plan.transitions import batch_from_df
from spark_rapids_tpu_torch.utils import metrics as M

#: the reference suite's injection shape: rate 0.2, seeded, low floor
RATE = 0.2
FLOOR = 64
SEED = 7


class _Ns:
    """One package's names, so a test builds the same plan in both."""

    def __init__(self, port: bool):
        self.port = port
        self.A, self.J, self.So, self.W = (A, J, So, W) if port else \
            (RA, RJ, RSo, RW)
        self.Ag = Ag if port else RAg
        self.col = col if port else rcol

    def src(self, df: pd.DataFrame, nb: int = 1):
        """One partition of `nb` batches."""
        step = -(-len(df) // nb)
        chunks = [df.iloc[i:i + step].reset_index(drop=True)
                  for i in range(0, len(df), step)]
        if self.port:
            schema = schema_of_df(df)
            return LocalBatchSource(
                [[batch_from_df(c, schema, "cpu") for c in chunks]],
                device="cpu")
        return RSource([[RBatch.from_pandas(c) for c in chunks]])

    def parts(self, df: pd.DataFrame, n: int):
        """`n` partitions of one batch each."""
        step = -(-len(df) // n)
        chunks = [df.iloc[i:i + step].reset_index(drop=True)
                  for i in range(0, len(df), step)]
        if self.port:
            schema = schema_of_df(df)
            return LocalBatchSource(
                [[batch_from_df(c, schema, "cpu")] for c in chunks],
                device="cpu")
        return RSource.from_pandas(df, num_partitions=n)


PORT, REF = _Ns(True), _Ns(False)


def _inject(rate=RATE, seed=SEED, **extra):
    s = {C.OOM_INJECT_RATE.key: rate, C.OOM_INJECT_SEED.key: seed,
         C.RETRY_MIN_SPLIT_ROWS.key: FLOOR}
    s.update(extra)
    return C.RapidsConf(s)


def _run(plan, conf=None):
    R.reset_oom_injection()
    with C.session(conf or C.RapidsConf()):
        return plan.collect().to_pandas()


def _ref_run(plan):
    RR.reset_oom_injection()
    with RC.session(RC.RapidsConf()):
        return plan.collect().to_pandas()


def _tree_metric(exec_, name) -> float:
    total = exec_.metrics.value(name)
    for c in exec_.children:
        total += _tree_metric(c, name)
    return total


def _rows(df: pd.DataFrame) -> list:
    return [tuple(None if v is None or v is pd.NA
                  or (isinstance(v, float) and v != v) else v for v in r)
            for r in df.astype(object).itertuples(index=False)]


def _key(row):
    return tuple((v is None, 0 if v is None else v) for v in row)


def _assert_same(want: pd.DataFrame, got: pd.DataFrame, label: str,
                 ordered: bool = False) -> None:
    """The same rows, bit-exact (as a set unless `ordered`)."""
    assert list(want.columns) == list(got.columns), label
    w, g = _rows(want), _rows(got)
    if not ordered:
        w, g = sorted(w, key=_key), sorted(g, key=_key)
    assert w == g, label


def _soak_until_split(make_plan, want, label, ordered=False, sweep=40):
    """Run the port's plan under rate-0.2 injection over derived seeds
    until the split-and-retry lane fires; every injected run must equal
    the reference's uninjected result."""
    fired = splits = 0
    for s in range(SEED, SEED + sweep):
        plan = make_plan()
        got = _run(plan, _inject(seed=s))
        fired += R.injected_oom_count()
        splits += _tree_metric(plan, M.NUM_SPLIT_RETRIES)
        _assert_same(want, got, f"{label} (seed {s})", ordered)
        if splits > 0:
            break
    assert fired > 0, f"{label}: injector never fired"
    assert splits > 0, f"{label}: split-and-retry lane never exercised"


# -- the plans and the reference's uninjected results ------------------------
def _sales(seed=SEED, n=4000):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 40, n).astype(np.int64),
        "v": rng.integers(-1000, 1000, n).astype(np.int64)})


def _agg_plan(ns, df, nb=6):
    return ns.A.HashAggregateExec(
        [ns.col("k")],
        [ns.Ag.Sum(ns.col("v")).alias("s"),
         ns.Ag.Count(ns.col("v")).alias("c")], ns.src(df, nb))


def _join_frames(seed, dup_build=False):
    rng = np.random.default_rng(seed)
    n, m = 4000, 600
    left = pd.DataFrame({
        "k": rng.integers(0, m, n).astype(np.int64),
        "v": rng.integers(0, 10_000, n).astype(np.int64)})
    # duplicate build keys disqualify the dense table -> sort-merge lane
    rk = (rng.integers(0, m // 2, m).astype(np.int64) if dup_build
          else np.arange(m, dtype=np.int64))
    right = pd.DataFrame({
        "rk": rk, "w": rng.integers(0, 100, m).astype(np.int64)})
    return left, right


def _join_plan(ns, left, right, jt="INNER", nb=6):
    return ns.J.HashJoinExec(getattr(ns.J.JoinType, jt), [ns.col("k")],
                             [ns.col("rk")], ns.src(left, nb),
                             ns.parts(right, 2))


def _outer_frames():
    left, right = _join_frames(5)
    left.loc[:50, "k"] = 10_000  # unmatched probe rows -> null build side
    return left, right


def _orders(seed=SEED, n=5000):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "x": rng.integers(-500, 500, n).astype(np.int64),
        "y": rng.integers(0, 1_000_000, n).astype(np.int64)})


def _sort_plan(ns, df, nb=4):
    return ns.So.SortExec([ns.So.asc(ns.col("x")), ns.So.desc(ns.col("y"))],
                          ns.src(df, nb))


def _window_frame():
    rng = np.random.default_rng(3)
    n = 2000
    return pd.DataFrame({
        "g": rng.integers(0, 20, n).astype(np.int64),
        "o": rng.permutation(n).astype(np.int64),
        "v": rng.integers(0, 100, n).astype(np.int64)})


def _window_plan(ns, df):
    return ns.W.WindowExec(
        [(ns.W.WinSum(ns.col("v")), "s")],
        ns.W.WindowSpec([ns.col("g")], [ns.So.asc(ns.col("o"))]),
        ns.src(df, 3))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's uninjected results, once per module."""
    out = {"agg": _ref_run(_agg_plan(REF, _sales()))}
    for dup in (False, True):
        left, right = _join_frames(SEED, dup)
        out[f"join{dup}"] = _ref_run(_join_plan(REF, left, right))
    left, right = _outer_frames()
    out["outer"] = _ref_run(_join_plan(REF, left, right, "LEFT_OUTER"))
    out["sort"] = _ref_run(_sort_plan(REF, _orders()))
    out["window"] = _ref_run(_window_plan(REF, _window_frame()))
    return out


# -- aggregate ---------------------------------------------------------------
def test_aggregate_parity_under_injection(ref):
    df = _sales()
    exp = df.groupby("k", as_index=False).agg(s=("v", "sum"),
                                              c=("v", "count"))
    _assert_same(exp, ref["agg"], "reference against pandas")
    _assert_same(ref["agg"], _run(_agg_plan(PORT, df)), "uninjected")
    _soak_until_split(lambda: _agg_plan(PORT, df), ref["agg"],
                      "agg under injection")


def test_aggregate_no_injection_no_retries(ref):
    plan = _agg_plan(PORT, _sales())
    _assert_same(ref["agg"], _run(plan), "agg")
    for name in (M.NUM_RETRIES, M.NUM_SPLIT_RETRIES,
                 M.NUM_OOM_FALLBACKS, M.SPILL_BYTES):
        assert _tree_metric(plan, name) == 0, name
    assert _tree_metric(plan, M.NUM_OUTPUT_ROWS) > 0


# -- join --------------------------------------------------------------------
@pytest.mark.parametrize("dup_build", [False, True],
                         ids=["denseLane", "sortLane"])
def test_join_parity_under_injection(ref, dup_build):
    left, right = _join_frames(SEED, dup_build)
    want = ref[f"join{dup_build}"]
    _assert_same(left.merge(right, left_on="k", right_on="rk"), want,
                 "reference against pandas")
    plan = _join_plan(PORT, left, right)
    _assert_same(want, _run(plan), "uninjected")
    assert plan.lane == ("sort-merge" if dup_build else "dense")
    _soak_until_split(lambda: _join_plan(PORT, left, right), want,
                      "join under injection")


def test_left_outer_join_parity_under_injection(ref):
    left, right = _outer_frames()
    got = _run(_join_plan(PORT, left, right, "LEFT_OUTER"),
               _inject(seed=5))
    assert R.injected_oom_count() > 0
    _assert_same(ref["outer"], got, "left outer under injection")


# -- sort --------------------------------------------------------------------
def test_sort_parity_under_injection(ref):
    df = _orders()
    exp = df.sort_values(["x", "y"], ascending=[True, False],
                         ignore_index=True)
    _assert_same(exp, ref["sort"], "reference against pandas", True)
    # equal (x, y) keys are equal rows, so the order is exact
    _soak_until_split(lambda: _sort_plan(PORT, df), ref["sort"],
                      "sort under injection", ordered=True)


# -- window (no-split lane) --------------------------------------------------
def test_window_parity_under_forced_fallback(ref):
    """Window frames need the whole partition batch, so the no-split
    lane handles pressure: spill + retry, then the floor fallback.
    rate=1.0 with a small injection cap forces the fallback."""
    p = _window_plan(PORT, _window_frame())
    got = _run(p, _inject(rate=1.0, seed=3, **{C.OOM_INJECT_MAX.key: 8}))
    assert R.injected_oom_count() > 0
    assert _tree_metric(p, M.NUM_SPLIT_RETRIES) == 0  # no-split lane
    assert (_tree_metric(p, M.NUM_RETRIES)
            + _tree_metric(p, M.NUM_OOM_FALLBACKS)) > 0
    _assert_same(ref["window"], got, "window under injection")


# -- harness unit behavior ---------------------------------------------------
def _batch_of(n):
    df = pd.DataFrame({"x": np.arange(n, dtype=np.int64)})
    return batch_from_df(df, schema_of_df(df), "cpu")


def _ref_batch_of(n):
    return RBatch.from_pandas(
        pd.DataFrame({"x": np.arange(n, dtype=np.int64)}))


def _harness(port: bool, n: int, conf_keys: dict):
    """with_split_retry over an n-row batch in one package: the piece
    sizes and the metrics."""
    mod, cmod = (R, C) if port else (RR, RC)
    from spark_rapids_tpu.utils import metrics as RM
    ms = (M if port else RM).MetricSet()
    mod.reset_oom_injection()
    b = _batch_of(n) if port else _ref_batch_of(n)
    with cmod.session(cmod.RapidsConf(conf_keys)):
        outs = list(mod.with_split_retry(b, lambda p: p.num_rows,
                                         metrics=ms, label="t"))
    return outs, ms.as_dict(), mod.injected_oom_count()


def _keys(rate, seed, **extra):
    k = {C.OOM_INJECT_RATE.key: rate, C.OOM_INJECT_SEED.key: seed,
         C.RETRY_MIN_SPLIT_ROWS.key: FLOOR}
    k.update(extra)
    return k


def _no_time(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != M.RETRY_BLOCK_TIME}


def test_split_retry_splits_to_floor_then_falls_back():
    """rate=1.0: every reservation fails, so the batch halves down to
    the floor and each floor piece still produces its result via the
    bestEffort fallback — as in the reference."""
    keys = _keys(1.0, 1, **{C.RETRY_MIN_SPLIT_ROWS.key: 25,
                            C.OOM_INJECT_MAX.key: 10_000})
    outs, ms, _ = _harness(True, 100, keys)
    assert outs == [25, 25, 25, 25]
    assert ms[M.NUM_SPLIT_RETRIES] == 3
    assert ms[M.NUM_OOM_FALLBACKS] == 4
    r_outs, r_ms, _ = _harness(False, 100, keys)
    assert outs == r_outs and _no_time(ms) == _no_time(r_ms)


def test_floor_error_mode_is_actionable():
    keys = _keys(1.0, 2, **{C.RETRY_MIN_SPLIT_ROWS.key: 1 << 20,
                            C.RETRY_FALLBACK.key: "error",
                            C.OOM_INJECT_MAX.key: 10_000})
    with pytest.raises(R.TpuOutOfCoreError) as ei:
        _harness(True, 100, keys)
    with pytest.raises(RR.TpuOutOfCoreError) as rei:
        _harness(False, 100, keys)
    msg = str(ei.value)
    assert "minSplitRows" in msg
    assert "allocFraction" in msg  # actionable: names the knobs
    assert msg.split(":")[0] == str(rei.value).split(":")[0]


def test_injection_cap_guarantees_progress():
    keys = _keys(1.0, 4, **{C.OOM_INJECT_MAX.key: 3,
                            C.RETRY_MIN_SPLIT_ROWS.key: 8})
    outs, ms, fired = _harness(True, 400, keys)
    assert sum(outs) == 400
    assert fired == 3
    assert ms.get(M.NUM_OOM_FALLBACKS, 0) == 0  # cap hit before floor
    r_outs, r_ms, r_fired = _harness(False, 400, keys)
    assert (outs, fired) == (r_outs, r_fired)
    assert _no_time(ms) == _no_time(r_ms)


def test_injector_is_deterministic():
    """The port's injector fires on the reference's draws for the same
    seed (both draw Python's random.Random stream)."""
    for rate, seed, cap in ((0.5, 3, 0), (0.2, 7, 0), (1.0, 1, 5)):
        a, b = R.OomInjector(rate, seed, cap), R.OomInjector(rate, seed, cap)
        r = RR.OomInjector(rate, seed, cap)
        fa = [a.fire() for _ in range(64)]
        assert fa == [b.fire() for _ in range(64)]
        assert fa == [r.fire() for _ in range(64)]


def test_reservation_released_after_body_and_on_error():
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    dm = DeviceManager.get("cpu")
    base = dm.reserved_bytes
    R.reset_oom_injection()
    with C.session(C.RapidsConf()):
        assert R.with_retry(lambda: 42, out_bytes=12345,
                            metrics=M.MetricSet(), label="t") == 42
        assert dm.reserved_bytes == base

        def boom():
            raise ValueError("body failure")
        with pytest.raises(ValueError):
            R.with_retry(boom, out_bytes=12345, metrics=M.MetricSet(),
                         label="t")
        assert dm.reserved_bytes == base


# -- real pressure against a tiny accounted budget ---------------------------
TINY = {C.HBM_ALLOC_FRACTION.key: 1.0, C.HBM_RESERVE.key: 0,
        C.HOST_SPILL_STORAGE.key: 1 << 22, C.CONCURRENT_TPU_TASKS.key: 1}


@pytest.fixture
def tiny_env(tmp_path):
    C.set_active_conf(C.RapidsConf(TINY))
    env = ResourceEnv.init(hbm_total=1 << 16, spill_dir=str(tmp_path),
                           device="cpu")
    yield env
    ResourceEnv.shutdown()
    C.set_active_conf(C.RapidsConf())


def _park_spillable(env, n=1000, seed=0):
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    rng = np.random.default_rng(seed)
    bid = BufferId(env.catalog.next_table_id())
    env.device_store.add_batch(bid, ColumnarBatch.from_numpy({
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.random(n)}, device="cpu"))
    return bid


def _ref_pressure(tmp_path) -> dict:
    """The reference's metrics for the same parked buffer and
    reservation."""
    from spark_rapids_tpu.memory import BufferId as RBufferId
    from spark_rapids_tpu.memory import ResourceEnv as RResourceEnv
    from spark_rapids_tpu.utils import metrics as RM
    RC.set_active_conf(RC.RapidsConf(TINY))
    env = RResourceEnv.init(hbm_total=1 << 16, spill_dir=str(tmp_path))
    try:
        rng = np.random.default_rng(0)
        bid = RBufferId(env.catalog.next_table_id())
        env.device_store.add_batch(bid, RBatch.from_numpy({
            "a": rng.integers(0, 100, 1000).astype(np.int64),
            "b": rng.random(1000)}))
        ms = RM.MetricSet()
        RR.reset_oom_injection()
        with RC.session(RC.get_active_conf()):
            assert RR.with_retry(lambda: "ok", out_bytes=60_000,
                                 metrics=ms, label="t") == "ok"
        with env.catalog.acquired(bid) as buf:
            tier = buf.tier.name
        return {"retries": ms.value(RM.NUM_RETRIES), "tier": tier,
                "spilled": ms.value(RM.SPILL_BYTES) > 0,
                "left": env.device_store.current_size}
    finally:
        RResourceEnv.shutdown()
        RC.set_active_conf(RC.RapidsConf())


def test_real_pressure_spills_and_reserves(tiny_env, tmp_path):
    """No injection: a reservation over the tiny accounted budget spills
    the parked device buffer down a tier and then succeeds."""
    bid = _park_spillable(tiny_env)
    assert tiny_env.device_store.current_size > 0
    ms = M.MetricSet()
    R.reset_oom_injection()
    with C.session(C.get_active_conf()):
        got = R.with_retry(lambda: "ok", out_bytes=60_000, metrics=ms,
                           label="t")
    assert got == "ok"
    with tiny_env.catalog.acquired(bid) as buf:
        tier = buf.tier.name
    port = {"retries": ms.value(M.NUM_RETRIES), "tier": tier,
            "spilled": ms.value(M.SPILL_BYTES) > 0,
            "left": tiny_env.device_store.current_size}
    assert port == {"retries": 1, "tier": "HOST", "spilled": True,
                    "left": 0}
    ResourceEnv.shutdown()
    assert port == _ref_pressure(tmp_path / "ref")


def test_semaphore_released_during_spill(tiny_env):
    """While task 1 blocks in the synchronous spill, task 2 can take the
    (max_concurrent=1) semaphore: the harness yields the hold around the
    spill and reacquires it with the refcount restored."""
    _park_spillable(tiny_env)
    sem = TpuSemaphore.get()
    assert sem.max_concurrent == 1
    store = tiny_env.device_store
    orig = store.synchronous_spill
    in_spill = threading.Event()
    t2_acquired = threading.Event()

    def slow_spill(target):
        in_spill.set()
        assert t2_acquired.wait(10), \
            "task 2 never got the semaphore while task 1 spilled"
        return orig(target)
    store.synchronous_spill = slow_spill

    def task2():
        assert in_spill.wait(10)
        with TaskContext(2) as c2:
            sem.acquire_if_necessary(c2)
            t2_acquired.set()
            sem.release_if_necessary(c2)

    t = threading.Thread(target=task2)
    t.start()
    ms = M.MetricSet()
    R.reset_oom_injection()
    with C.session(C.get_active_conf()):
        with TaskContext(1) as ctx:
            sem.acquire_if_necessary(ctx)
            sem.acquire_if_necessary(ctx)  # nested hold: refcount 2
            assert R.with_retry(lambda: "ok", out_bytes=60_000,
                                metrics=ms, label="t") == "ok"
            assert sem.holders() == 1
            sem.release_if_necessary(ctx)
            assert sem.holders() == 1
            sem.release_if_necessary(ctx)
            assert sem.holders() == 0
    t.join(10)
    assert not t.is_alive()
    assert ms.value(M.SPILL_BYTES) > 0


def test_concurrent_tasks_complete_under_injection(tiny_env):
    """Two tasks hammering the harness under injection on a
    max_concurrent=1 semaphore both finish (no deadlock through the
    yield/reacquire path) with exact results."""
    results, errors = {}, []
    R.reset_oom_injection()
    conf = C.get_active_conf().set(C.OOM_INJECT_RATE.key, 0.5) \
        .set(C.OOM_INJECT_SEED.key, 9) \
        .set(C.OOM_INJECT_MAX.key, 200) \
        .set(C.RETRY_MIN_SPLIT_ROWS.key, 16)

    def work(tid):
        try:
            with C.session(conf):
                with TaskContext(tid) as ctx:
                    TpuSemaphore.get().acquire_if_necessary(ctx)
                    outs = list(R.with_split_retry(
                        _batch_of(200), lambda p: p.num_rows,
                        metrics=M.MetricSet(), label=f"task{tid}"))
                    results[tid] = sum(outs)
        except Exception as e:  # surfaced to the main thread below
            errors.append((tid, e))

    ts = [threading.Thread(target=work, args=(i,)) for i in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert results == {1: 200, 2: 200}
    assert TpuSemaphore.get().holders() == 0
