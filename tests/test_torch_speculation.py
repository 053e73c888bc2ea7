"""spark_rapids_tpu_torch's tail tolerance against spark_rapids_tpu's:
twins of tests/test_speculation.py (speculative map tasks against a slow
executor, hedged fetches against map-output replicas, replica promotion on
peer loss, the wire-corruption metric, the seeded slow and spill
corruption injectors, the atomic manager registry, the advertised-but-
missing output, and the two soaks).

The exchange cases run the same frame through both packages' manager
lane with and without the injection, and hold the rows of every
partition equal, in order (the port's reduce side merges a partition's
batches, so rows are compared, not batches).

test_losing_hedge_charged_to_wasted_site, which reads the movement
ledger, has its twin with the ledger's in tests/test_torch_movement.py.

The soaks run at the reference's sizes (TPC-H at 800 orders, four
threads, q1 and q5) and hold the port's injected results against its
clean ones, to the bit; the clean manager lane of q1 and q5 at this scale
is held against the reference's in test_torch_shuffle_recovery.py.
"""
import threading
import time

import numpy as np
import pandas as pd
import pytest

from test_torch_shuffle_manager import (PKGS, PORT, REF, conf, env_init,
                                        local_source, mod, reset_world, twin,
                                        values)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


def _reset(pkg):
    reset_world(pkg)
    mod(pkg, "utils.watchdog").reset_slow_injection()
    mod(pkg, "exec.speculation").reset_speculation_stats()
    mod(pkg, "shuffle.client_server").reset_fetch_latency()


@pytest.fixture(autouse=True)
def clean_world(one_torch_thread):  # noqa: F811
    for p in PKGS:
        _reset(p)
    yield
    for p in PKGS:
        _reset(p)


def _df(rows=4000, seed=7):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 50, rows).astype(np.int64),
        "v": rng.integers(0, 10**6, rows).astype(np.int64)})


def _exchange_parts(pkg, df, settings, num_partitions=4, reducers=3):
    C = mod(pkg, "config")
    c = C.RapidsConf(settings)
    with C.session(c):
        env_init(pkg, c)
        E = mod(pkg, "exprs.base")
        HP = mod(pkg, "shuffle.partitioning").HashPartitioning
        SEE = mod(pkg, "shuffle.exchange").ShuffleExchangeExec
        ex = SEE(HP([E.col("k")], reducers),
                 local_source(pkg, df, num_partitions))
        parts = [[(k, v) for b in it for k, v in zip(
            b.to_pandas()["k"].tolist(), b.to_pandas()["v"].tolist())]
            for it in ex.execute_partitions()]
    return parts, ex.metrics.as_dict()


def _mgr_conf(**extra):
    kv = {"spark.rapids.shuffle.enabled": True,
          "spark.rapids.shuffle.localExecutors": 3,
          "spark.rapids.sql.watchdog.pollInterval": 0.05}
    kv.update({k.replace("__", "."): v for k, v in extra.items()})
    return kv


SLOW_MAP = {
    "spark.rapids.memory.faultInjection.slowSite": "map-task",
    "spark.rapids.memory.faultInjection.slowFactor": 10.0,
    "spark.rapids.memory.faultInjection.slowUnitMs": 40.0,
    "spark.rapids.memory.faultInjection.slowVictim": "local-1",
    "spark.rapids.memory.faultInjection.slowSeed": 11,
}
SLOW_SERVER = {
    "spark.rapids.memory.faultInjection.slowSite": "shuffle-server",
    "spark.rapids.memory.faultInjection.slowFactor": 20.0,
    "spark.rapids.memory.faultInjection.slowUnitMs": 30.0,
    "spark.rapids.memory.faultInjection.slowVictim": "local-1",
    "spark.rapids.memory.faultInjection.slowSeed": 11,
}
SPECULATE = {
    "spark.rapids.sql.speculation.enabled": True,
    "spark.rapids.sql.speculation.minTaskRuntimeMs": 50.0,
    "spark.rapids.sql.speculation.minCompletedTasks": 1,
    "spark.rapids.sql.speculation.multiplier": 3.0,
}
HEDGE = {
    "spark.rapids.shuffle.replication.factor": 2,
    "spark.rapids.shuffle.hedge.enabled": True,
    "spark.rapids.shuffle.hedge.delayMs": 40.0,
}


# -- the slow injector -------------------------------------------------------
def test_slow_injector_targets_victim_only():
    def scenario(pkg):
        W = mod(pkg, "utils.watchdog")
        C = mod(pkg, "config")
        with C.session(C.RapidsConf(_mgr_conf(**SLOW_MAP))):
            obs = [W.maybe_slow("map-task", executor_id="local-0"),
                   W.maybe_slow("shuffle-server", executor_id="local-1"),
                   W.maybe_slow("map-task", executor_id="local-1") > 0]
        return obs + [W.slow_injection_counts()]
    assert twin(scenario) == [0.0, 0.0, True, {"map-task": 1}]


def test_slow_injector_off_by_default():
    def scenario(pkg):
        W = mod(pkg, "utils.watchdog")
        C = mod(pkg, "config")
        with C.session(C.RapidsConf()):
            obs = [W.maybe_slow("map-task", executor_id="x"),
                   W.maybe_slow("shuffle-server")]
        return obs + [W.slow_injection_counts()]
    assert twin(scenario) == [0.0, 0.0, {}]


def test_slow_injector_delay_is_cancellable():
    def scenario(pkg):
        W = mod(pkg, "utils.watchdog")
        C = mod(pkg, "config")
        c = C.RapidsConf(_mgr_conf(**{
            "spark.rapids.memory.faultInjection.slowSite": "map-task",
            "spark.rapids.memory.faultInjection.slowFactor": 100.0,
            "spark.rapids.memory.faultInjection.slowUnitMs": 20.0}))
        tok = W.AttemptToken()
        t = threading.Timer(0.1, lambda: tok.cancel_race_lost("test"))
        t.start()
        t0 = time.monotonic()
        with C.session(c), W.attempt_scope(tok):
            with pytest.raises(W.TpuQueryTimeout):
                W.maybe_slow("map-task", executor_id="any")
        # woke on the token, not at the 2 s cap
        return [time.monotonic() - t0 < 1.5, tok.race_lost]
    assert twin(scenario) == [True, True]


def test_attempt_token_links_to_parent():
    def scenario(pkg):
        W = mod(pkg, "utils.watchdog")
        parent = W.CancelToken()
        tok = W.AttemptToken(parent=parent)
        obs = [tok.cancelled]
        parent.cancel("query died")
        obs.append(tok.cancelled)
        with pytest.raises(W.TpuQueryTimeout):
            tok.check()
        # cancelling an attempt never touches the parent
        tok2 = W.AttemptToken(parent=W.CancelToken())
        tok2.cancel_race_lost("lost")
        return obs + [tok2.race_lost, tok2.cancelled, tok2.parent.cancelled]
    assert twin(scenario) == [False, True, True, True, False]


# -- speculative map tasks ---------------------------------------------------
def _clean_and_injected(df, injected: dict, clean: dict = None):
    """Both packages' manager lane, clean then injected: the injected rows
    equal the clean ones, in order, and the port's equal the
    reference's.  Returns the port's (rows, metrics, speculation stats)."""
    out = {}
    for pkg in PKGS:
        _reset(pkg)
        base, _ = _exchange_parts(pkg, df, _mgr_conf(**(clean or {})))
        _reset(pkg)
        got, m = _exchange_parts(pkg, df, _mgr_conf(**injected))
        assert got == base
        out[pkg] = (got, m, mod(pkg, "exec.speculation").speculation_stats())
    assert out[PORT][0] == out[REF][0]
    return out[PORT]


def test_speculation_wins_over_slow_victim_bit_exact():
    _, m, stats = _clean_and_injected(_df(), {**SLOW_MAP, **SPECULATE})
    assert m["numSpeculativeTasks"] >= 1, m
    assert m["numSpeculativeWins"] >= 1, m
    assert stats["losers_cancelled"] >= 1, stats


def test_speculation_idle_on_healthy_stage():
    def scenario(pkg):
        got, m = _exchange_parts(pkg, _df(), _mgr_conf(**SPECULATE))
        return [m.get("numSpeculativeTasks", 0), got]
    n, got = twin(scenario)
    assert n == 0 and sum(len(p) for p in got) == 4000


def test_speculation_defaults_off_even_under_slowdown():
    def scenario(pkg):
        got, m = _exchange_parts(pkg, _df(), _mgr_conf(**SLOW_MAP))
        return [m.get("numSpeculativeTasks", 0), got]
    n, got = twin(scenario)
    assert n == 0 and sum(len(p) for p in got) == 4000


# -- hedged fetches and replicas ---------------------------------------------
def test_hedged_fetch_beats_slow_server_bit_exact():
    _, m, _ = _clean_and_injected(_df(), {**SLOW_SERVER, **HEDGE})
    assert m["numHedgedFetches"] >= 1, m
    assert m["numHedgedWins"] >= 1, m
    assert m["replicatedBytes"] > 0, m


def test_hedge_without_replicas_never_fires():
    def scenario(pkg):
        got, m = _exchange_parts(pkg, _df(), _mgr_conf(**SLOW_SERVER, **{
            "spark.rapids.shuffle.hedge.enabled": True,
            "spark.rapids.shuffle.hedge.delayMs": 40.0}))
        return [m.get("numHedgedFetches", 0), got]
    n, got = twin(scenario)
    assert n == 0 and sum(len(p) for p in got) == 4000


def test_replica_promotion_recovers_peer_kill_without_recompute():
    df = _df()
    kill = {
        "spark.rapids.shuffle.localExecutors": 2,
        "spark.rapids.shuffle.replication.factor": 2,
        "spark.rapids.shuffle.bounceBuffers.size": 2048,
        "spark.rapids.shuffle.fetch.maxRetries": 1,
        "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
        "spark.rapids.shuffle.transport.faultInjection."
        "peerKillAfterFrames": 4}
    out = {}
    for pkg in PKGS:
        _reset(pkg)
        base, _ = _exchange_parts(pkg, df, _mgr_conf())
        _reset(pkg)
        got, m = _exchange_parts(pkg, df, _mgr_conf(**kill))
        assert m["numReplicaPromotions"] >= 1, m
        assert m.get("numMapRecomputes", 0) == 0, m
        # maps moved between executors: the same rows, the recovery
        # driver keeps the map order within each partition
        assert sorted(r for p in got for r in p) == \
            sorted(r for p in base for r in p)
        out[pkg] = got
    assert out[PORT] == out[REF]


# -- the wire-corruption metric ------------------------------------------------
def test_wire_corruption_surfaces_as_metric():
    def scenario(pkg):
        c = conf(pkg, **{
            "spark.rapids.shuffle.transport.faultInjection.corruptRate":
                0.05,
            "spark.rapids.shuffle.transport.faultInjection.seed": 7,
            "spark.rapids.shuffle.bounceBuffers.size": 2048,
            "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0})
        from test_torch_shuffle_manager import _advertise_tcp, _tcp_pair, batch
        _, m0, m1 = _tcp_pair(pkg, c, 70, ("wc-a", "wc-b"))
        w = m0.get_writer(70, 0)
        w.write_partition(0, batch(pkg, {"k": np.arange(4000,
                                                         dtype=np.int64)}))
        _advertise_tcp(pkg, 70, 0, w.commit(1), m0)
        metrics = mod(pkg, "utils.metrics").MetricSet()
        got = values(m1.get_reader(70, 0, timeout=10.0, metrics=metrics),
                     "k")
        n = m0.transport.faults.injected_corruptions
        return [got, n > 0, metrics.as_dict()["numWireCorruptions"] == n]
    got, fired, counted = twin(scenario)
    assert got == list(range(4000)) and fired and counted


# -- spill corruption ----------------------------------------------------------
@pytest.mark.parametrize("rate", [1.0, 0.0],
                         ids=["injection_raises_descriptive_error",
                              "off_by_default_roundtrips"])
def test_spill_corruption(rate, tmp_path):
    """The reference's test_spill_corruption_injection_raises_descriptive_
    error and test_spill_corruption_off_by_default_roundtrips."""
    def scenario(pkg):
        ST = mod(pkg, "memory.stores")
        B = mod(pkg, "memory.buffer")
        C = mod(pkg, "config")
        ser = mod(pkg, "columnar.serde")
        ST.reset_spill_corruption()
        settings = ({"spark.rapids.memory.faultInjection.spillCorruptRate":
                     rate, "spark.rapids.memory.faultInjection.seed": 11}
                    if rate else {})
        with C.session(C.RapidsConf(settings)):
            root = str(tmp_path / pkg)
            dbm = ST.DiskBlockManager(root)
            disk = (ST.DiskStore(dbm) if pkg == REF
                    else ST.DiskStore(dbm, device="cpu"))
            b = batch_of(pkg)
            buf = disk.add_blob(B.BufferId(1), ser.serialize_batch(b),
                                B.meta_for_batch(b))
            obs = [ST.injected_spill_corruptions()]
            if rate:
                with pytest.raises(ST.SpillCorruption) as ei:
                    buf.get_columnar_batch()
                obs.append("spill file" in str(ei.value))
            else:
                obs.append(values([buf.get_columnar_batch()], "k"))
            disk.close()
        return obs
    got = twin(scenario)
    assert got == ([1, True] if rate else [0, list(range(256))])


def batch_of(pkg):
    from test_torch_shuffle_manager import batch
    return batch(pkg, {"k": np.arange(256, dtype=np.int64)})


# -- the registry's races --------------------------------------------------------
def test_manager_get_or_create_is_atomic():
    """`get(id) or Manager(id)` raced under concurrent queries (the second
    server replaced the first's loopback registration: silent partial
    data); get_or_create builds one manager for eight threads."""
    def scenario(pkg):
        c = conf(pkg)
        env_init(pkg, c)
        TSM = mod(pkg, "shuffle.manager").TpuShuffleManager
        got: list = []
        barrier = threading.Barrier(8)

        def make():
            barrier.wait()
            got.append(TSM.get_or_create("race-x"))

        ts = [threading.Thread(target=make) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        return [len(got), all(m is got[0] for m in got)]
    assert twin(scenario) == [8, True]


def test_advertised_output_missing_from_peer_fetchfails():
    """A peer answering 'no such table' for an output the registry
    advertises as nonzero is a FetchFailedError, never an empty read."""
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        M = mod(pkg, "shuffle.manager")
        reader = M.TpuShuffleManager.get_or_create("sp-reader", env, c)
        peer = M.TpuShuffleManager.get_or_create("sp-peer", env, c)
        reader.register_shuffle(80)
        M.MapOutputRegistry.register(80, 0, M.MapStatus(
            "sp-peer", peer.loop_address, [1234],
            tcp_address=peer.tcp_address))
        CS = mod(pkg, "shuffle.client_server")
        with pytest.raises(CS.FetchFailedError) as ei:
            list(reader.get_reader(80, 0, timeout=5.0))
        return "advertise data" in str(ei.value)
    assert twin(scenario)


# -- the soaks -------------------------------------------------------------------
def _assert_no_leaks():
    TS = mod(PORT, "memory.semaphore").TpuSemaphore
    snap = TS.get().snapshot()
    assert snap["refs"] == {}, f"leaked semaphore permits: {snap}"
    dm = mod(PORT, "memory.device_manager").DeviceManager.peek()
    if dm is not None:
        assert dm.admissions() == {}, dm.admissions()
        assert dm.reserved_bytes == 0, dm.reserved_bytes
    deadline = time.monotonic() + 5.0
    live = []
    while time.monotonic() < deadline:
        live = [t for t in threading.enumerate()
                if t.name.startswith(("tpu-prefetch", "tpu-speculate",
                                      "tpu-shuffle-hedge",
                                      "tpu-shuffle-fetch",
                                      "tpu-aqe-stage-fill"))]
        if not live:
            break
        time.sleep(0.05)
    assert not live, f"leaked attempt/producer threads: {live}"


_TABLES = {}


def _tables():
    if not _TABLES:
        TD = mod(PORT, "models.tpch_data")
        _TABLES["t"] = TD.gen_tables(np.random.default_rng(11), 800)
    return _TABLES["t"]


def _soak_conf(pkg, injected: dict):
    TB = mod(pkg, "models.tpch_bench")
    kv = dict(TB.BENCH_CONF)
    kv.update({"spark.rapids.shuffle.enabled": True,
               "spark.rapids.shuffle.localExecutors": 3,
               "spark.rapids.sql.watchdog.pollInterval": 0.05})
    kv.update(injected)
    return mod(pkg, "config").RapidsConf(kv)


def _same_bits(want, got, label):
    e = want.sort_values(list(want.columns)).reset_index(drop=True)
    g = got.sort_values(list(got.columns)).reset_index(drop=True)
    assert list(e.columns) == list(g.columns)
    for c in e.columns:
        np.testing.assert_array_equal(e[c].to_numpy(), g[c].to_numpy(),
                                      err_msg=f"{label} column {c}")


def _port_query(q, conf_, plans=None):
    TD = mod(PORT, "models.tpch_data")
    O = mod(PORT, "plan.overrides")
    Q = mod(PORT, "models.tpch_queries").QUERIES

    def runner(p):
        return O.collect(O.accelerate(p, conf_, device="cpu"), conf_)
    plan = O.accelerate(Q[q](TD.sources(_tables(), 2), runner), conf_,
                        device="cpu")
    if plans is not None:
        plans.append(plan)
    return O.collect(plan, conf_)


def test_soak_scheduler_storm_under_combined_injection():
    """Four threads of q1/q5 at once under seeded slow peer, peer kill and
    OOM injection: every result bit-exact against the clean run,
    speculation wins on the meter, no leaked permits, admissions or
    threads, the losers cancelled."""
    R = mod(PORT, "memory.retry")
    SPEC = mod(PORT, "exec.speculation")
    W = mod(PORT, "utils.watchdog")
    clean = {}
    for q in (1, 5):
        clean[q] = _port_query(q, _soak_conf(PORT, {}))
    _reset(PORT)
    R.reset_oom_injection()
    injected = {**SPECULATE, **HEDGE, **SLOW_MAP,
                # peer kill rides along: replicas absorb it, recompute is
                # the fallback
                "spark.rapids.shuffle.transport.faultInjection."
                "peerKillAfterFrames": 24,
                "spark.rapids.shuffle.fetch.maxRetries": 1,
                "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
                "spark.rapids.memory.faultInjection.oomRate": 0.05,
                "spark.rapids.memory.faultInjection.seed": 11,
                "spark.rapids.memory.faultInjection.maxInjections": 4}
    conf_ = _soak_conf(PORT, injected)
    mix = [1, 5, 1, 5]
    results, errors = {}, []

    def worker(i, q):
        try:
            results[i] = (q, _port_query(q, conf_))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append((i, q, repr(e)))

    threads = [threading.Thread(target=worker, args=(i, q),
                                name=f"tail-soak-{i}")
               for i, q in enumerate(mix)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert len(results) == len(mix)
    for i, (q, got) in results.items():
        _same_bits(clean[q], got, f"q{q} under combined injection")
    stats = SPEC.speculation_stats()
    assert stats["wins"] >= 1, stats
    assert stats["losers_cancelled"] >= 1, stats
    assert W.slow_injection_counts().get("map-task", 0) > 0
    _assert_no_leaks()
    R.reset_oom_injection()


def test_soak_hedge_wins_under_slow_server_storm():
    """q1/q5 through the manager lane under a slow shuffle-server victim
    with replicas: hedged wins on the meter, bit-exact, no leaks."""
    SEE = mod(PORT, "shuffle.exchange").ShuffleExchangeExec

    def hedge_totals(plan):
        tot = {"numHedgedFetches": 0.0, "numHedgedWins": 0.0}

        def walk(node):
            if isinstance(node, SEE):
                d = node.metrics.as_dict()
                for k in tot:
                    tot[k] += d.get(k, 0)
            for ch in getattr(node, "children", []):
                walk(ch)
        walk(plan)
        return tot

    for q in (1, 5):
        _reset(PORT)
        expected = _port_query(q, _soak_conf(PORT, {}))
        _reset(PORT)
        plans: list = []
        got = _port_query(q, _soak_conf(PORT, {**HEDGE, **SLOW_SERVER}),
                          plans)
        tot = hedge_totals(plans[-1])
        assert tot["numHedgedFetches"] >= 1, (q, tot)
        assert tot["numHedgedWins"] >= 1, (q, tot)
        _same_bits(expected, got, f"q{q} under hedging")
    _assert_no_leaks()
