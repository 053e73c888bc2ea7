"""spark_rapids_tpu_torch's shuffle fault recovery against
spark_rapids_tpu's: twins of tests/test_shuffle_recovery.py (PeerHealth's
blacklist and decay, the registry's epochs and invalidation, the
partial-read guard, peer kill over both lanes, the recovery driver and its
exhaustion, the fetch backoff, AQE's stage re-materialization, the
exchange and TPC-H Q1 and Q5 through the manager lane under peer kill).

Each twin runs the same inputs through both packages and holds their
observations equal.  The TPC-H cases run the reference's manager lane
once, uninjected (its result is what the injected run must equal; a run
of its injected lane compiles for seconds more and shows nothing the
port's own injected-against-uninjected equality does not), and the
port's manager lane with and without peer kill: the port's two runs are
equal to the bit, and equal the reference's at compare_frames' rtol 1e-5
(the packages add floats in other orders).
"""
import time

import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from test_torch_shuffle_manager import (PKGS, PORT, REF, clean_world,  # noqa
                                        conf, env_init, kv_batch,
                                        local_source, manager, mod,
                                        reset_world, twin, values)
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture


# -- PeerHealth --------------------------------------------------------------
def test_blacklist_threshold_and_decay(monkeypatch):
    def scenario(pkg):
        conf(pkg, **{
            "spark.rapids.shuffle.recovery.blacklist.failureThreshold": 2,
            "spark.rapids.shuffle.recovery.blacklist.decaySeconds": 10.0})
        R = mod(pkg, "shuffle.recovery")
        clock = [1000.0]
        monkeypatch.setattr(R, "_now", lambda: clock[0])
        h = R.PeerHealth()
        obs = [h.record_failure("tcp://a:1"), h.is_blacklisted("tcp://a:1"),
               h.record_failure("tcp://a:1"), h.is_blacklisted("tcp://a:1"),
               h.blacklist_events, h.record_failure("tcp://a:1"),
               h.blacklist_events]
        clock[0] += 10.5  # decayed: a fresh budget
        return obs + [h.is_blacklisted("tcp://a:1"),
                      h.record_failure("tcp://a:1")]
    assert twin(scenario) == [False, False, True, True, 1, False, 1, False,
                              False]


def test_blacklist_success_resets_consecutive_count():
    def scenario(pkg):
        conf(pkg, **{
            "spark.rapids.shuffle.recovery.blacklist.failureThreshold": 2})
        h = mod(pkg, "shuffle.recovery").PeerHealth()
        h.record_failure("loop://x")
        h.record_success("loop://x")  # not CONSECUTIVE any more
        return [h.record_failure("loop://x"), h.is_blacklisted("loop://x")]
    assert twin(scenario) == [False, False]


# -- registry epochs / invalidation ------------------------------------------
def test_invalidate_address_bumps_epoch_and_returns_lost():
    def scenario(pkg):
        conf(pkg)
        M = mod(pkg, "shuffle.manager")
        R = M.MapOutputRegistry
        R.register(50, 0, M.MapStatus("e-a", "loop://e-a", [1]))
        R.register(50, 1, M.MapStatus("e-b", "loop://e-b", [1],
                                      tcp_address="tcp://h:9"))
        obs = [R.epoch(50)]
        lost = R.invalidate_address(50, "tcp://h:9")
        obs += [sorted(lost), lost[1].executor_id, R.epoch(50),
                sorted(R.outputs_for(50))]
        # an unknown address invalidates nothing and keeps the epoch
        return obs + [R.invalidate_address(50, "tcp://nope:1"), R.epoch(50)]
    assert twin(scenario) == [0, [1], "e-b", 1, [0], {}, 1]


def test_stale_epoch_registration_rejected():
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        M = mod(pkg, "shuffle.manager")
        R = M.MapOutputRegistry
        mgr = manager(pkg, "ep-a", env, c)
        mgr.register_shuffle(60)
        w = mgr.get_writer(60, 0)
        w.write_partition(0, kv_batch(pkg, 0, 8))
        w.commit(1)  # epoch 0
        seen = R.epoch(60)
        R.invalidate_address(60, mgr.loop_address)  # epoch 1
        w2 = mgr.get_writer(60, 0)
        w2.write_partition(0, kv_batch(pkg, 0, 8))
        with pytest.raises(M.StaleMapStatusError):
            w2.commit(1, epoch=seen)
        # the superseded run's buffers were freed, nothing registered
        obs = [len(env.catalog), R.outputs_for(60)]
        w3 = mgr.get_writer(60, 0)
        w3.write_partition(0, kv_batch(pkg, 0, 8))
        w3.commit(1, epoch=R.epoch(60))
        return obs + [sorted(R.outputs_for(60))]
    assert twin(scenario) == [0, {}, [0]]


def test_missing_map_outputs_fetchfail_not_partial_read():
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        mgr = manager(pkg, "pg-a", env, c)
        mgr.register_shuffle(61)
        w = mgr.get_writer(61, 0)
        w.write_partition(0, kv_batch(pkg, 0, 8))
        w.commit(1)
        mod(pkg, "shuffle.manager").MapOutputRegistry.set_expected_maps(61, 2)
        CS = mod(pkg, "shuffle.client_server")
        with pytest.raises(CS.FetchFailedError, match="missing map outputs"):
            list(mgr.get_reader(61, 0))
        return True
    assert twin(scenario)


# -- peer_kill over both lanes -------------------------------------------------
def _two_mgr_setup(pkg, shuffle_id, kill_frames, wire=False, rows=4000):
    c = conf(pkg, **{
        "spark.rapids.shuffle.transport.faultInjection."
        "peerKillAfterFrames": kill_frames,
        "spark.rapids.shuffle.bounceBuffers.size": 2048,
        "spark.rapids.shuffle.fetch.maxRetries": 1,
        "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
    })
    env = env_init(pkg, c)
    m0 = manager(pkg, "pk-a", env, c)
    m1 = manager(pkg, "pk-b", env, c)
    for m in (m0, m1):
        m.register_shuffle(shuffle_id)
    w = m0.get_writer(shuffle_id, 0)
    w.write_partition(0, kv_batch(pkg, 0, rows))
    status = w.commit(1)
    if wire:
        status.address = m0.tcp_address
        mod(pkg, "shuffle.manager").MapOutputRegistry.register(
            shuffle_id, 0, status)
    return m0, m1


@pytest.mark.parametrize("wire", [False, True])
def test_peer_kill_mid_stream_fetch_failed(wire):
    """After N served frames the peer dies on BOTH lanes: the bounded
    retries end in a FetchFailedError naming it, fast, and later
    connections are refused too."""
    def scenario(pkg):
        sid = 70 + int(wire)
        m0, m1 = _two_mgr_setup(pkg, sid, kill_frames=3, wire=wire)
        CS = mod(pkg, "shuffle.client_server")
        t0 = time.monotonic()
        with pytest.raises(CS.FetchFailedError) as ei:
            list(m1.get_reader(sid, 0, timeout=5.0))
        fast = time.monotonic() - t0 < 5.0
        ici = mod(pkg, "shuffle.ici_transport")
        with ici._LOOP_REGISTRY_LOCK:
            gone = "pk-a" not in ici._LOOP_REGISTRY
        with pytest.raises((ConnectionError, OSError)):
            m0.transport.make_client(m0.loop_address)
        named = "pk-a" in str(ei.value) or "tcp://" in str(ei.value)
        return [fast, m0.transport.faults.peer_killed, gone, named]
    assert twin(scenario) == [True, True, True, True]


# -- the recovery driver -------------------------------------------------------
def test_recovery_driver_recomputes_lost_maps():
    def scenario(pkg):
        c = conf(pkg, **{
            "spark.rapids.shuffle.transport.faultInjection."
            "peerKillAfterFrames": 2,
            "spark.rapids.shuffle.bounceBuffers.size": 2048,
            "spark.rapids.shuffle.fetch.maxRetries": 1,
            "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
            "spark.rapids.shuffle.recovery.blacklist.failureThreshold": 1,
        })
        env = env_init(pkg, c)
        m0 = manager(pkg, "rd-a", env, c)   # the reducer, stays alive
        m1 = manager(pkg, "rd-b", env, c)   # the doomed peer
        for m in (m0, m1):
            m.register_shuffle(80)
        w0 = m0.get_writer(80, 0)
        w0.write_partition(0, kv_batch(pkg, 0, 100))
        w0.commit(1)
        w1 = m1.get_writer(80, 1)
        w1.write_partition(0, kv_batch(pkg, 100, 3000))
        w1.commit(1)
        mod(pkg, "shuffle.manager").MapOutputRegistry.set_expected_maps(80, 2)
        recomputed = []

        def recompute(lost, epoch):
            recomputed.extend(lost)
            for map_id in lost:
                w = m0.get_writer(80, map_id)
                w.write_partition(0, kv_batch(pkg, 100, 3000))
                w.commit(1, epoch=epoch)

        Mx = mod(pkg, "utils.metrics")
        metrics = Mx.MetricSet()
        R = mod(pkg, "shuffle.recovery")
        driver = R.ShuffleRecoveryDriver(m0, 80, recompute, conf=c,
                                         metrics=metrics, read_timeout=5.0)
        got = driver.read_partition(0)
        md = metrics.as_dict()
        h = R.PeerHealth.get()
        return [values(got, "k"), recomputed,
                md["numFetchFailures"] >= 1, md["numMapRecomputes"],
                md["numStageRetries"] >= 1, md["numPeersBlacklisted"],
                md["recoveryTime"] > 0, h.is_blacklisted(m1.loop_address),
                h.is_blacklisted(m1.tcp_address)]
    got = twin(scenario)
    assert got[0] == list(range(3100))  # map order: map 0, then map 1
    assert got[1:] == [[1], True, 1, True, 1, True, True, True]


def test_recovery_exhaustion_raises_descriptive_not_hang():
    """A recompute that cannot restore the outputs: bounded attempts, then
    a FetchFailedError naming the key, within seconds."""
    def scenario(pkg):
        c = conf(pkg, **{
            "spark.rapids.shuffle.recovery.maxStageAttempts": 2,
            "spark.rapids.shuffle.fetch.maxRetries": 0,
            "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
        })
        env = env_init(pkg, c)
        mgr = manager(pkg, "ex-a", env, c)
        mgr.register_shuffle(90)
        M = mod(pkg, "shuffle.manager")
        # a ghost peer: nothing listens on this address
        M.MapOutputRegistry.register(
            90, 0, M.MapStatus("ghost", "tcp://127.0.0.1:1", [1]))
        M.MapOutputRegistry.set_expected_maps(90, 1)
        metrics = mod(pkg, "utils.metrics").MetricSet()
        driver = mod(pkg, "shuffle.recovery").ShuffleRecoveryDriver(
            mgr, 90, lambda lost, epoch: None, conf=c, metrics=metrics,
            read_timeout=5.0)
        CS = mod(pkg, "shuffle.client_server")
        t0 = time.monotonic()
        with pytest.raises(CS.FetchFailedError, match="maxStageAttempts=2"):
            driver.read_partition(0)
        return [time.monotonic() - t0 < 15.0,
                metrics.as_dict()["numStageRetries"]]
    assert twin(scenario) == [True, 1]  # two attempts in all


# -- fetch retry backoff -------------------------------------------------------
def _flaky_fetch_delays(pkg, seed, fail_times=3):
    from test_torch_shuffle_manager import _flaky_connection, _recorder
    c = conf(pkg, **{
        "spark.rapids.shuffle.bounceBuffers.size": 128,
        "spark.rapids.shuffle.fetch.maxRetries": 5,
        "spark.rapids.shuffle.fetch.backoff.baseMs": 100.0,
        "spark.rapids.shuffle.fetch.backoff.capMs": 300.0,
        "spark.rapids.shuffle.transport.faultInjection.seed": seed,
    })
    env = env_init(pkg, c)
    CAT = mod(pkg, "shuffle.catalog")
    CS = mod(pkg, "shuffle.client_server")
    cat = CAT.ShuffleBufferCatalog(env.catalog)
    cat.register_shuffle(9)
    transport = mod(pkg, "shuffle.ici_transport").IciShuffleTransport(c)
    server = CS.ShuffleServer(cat, transport)
    env.device_store.add_batch(cat.next_shuffle_buffer_id(9, 0, 0),
                               kv_batch(pkg, 0, 50))
    recv = CAT.ShuffleReceivedBufferCatalog(env.catalog)
    delays = []
    orig = CS._backoff_sleep
    CS._backoff_sleep = delays.append  # captured: no real sleeping
    try:
        client = CS.ShuffleClient(_flaky_connection(pkg, server, fail_times),
                                  transport, recv, env.host_store, conf=c)
        rec = _recorder(pkg)
        client.fetch_blocks([mod(pkg, "shuffle.transport").BlockIdMsg(
            9, 0, 0)], 1, rec)
        assert len(rec.received) == 1
    finally:
        CS._backoff_sleep = orig
        transport.shutdown()
    return delays


def test_fetch_backoff_exponential_capped_deterministic():
    def scenario(pkg):
        delays = _flaky_fetch_delays(pkg, seed=13)
        mod(pkg, "memory.env").ResourceEnv.shutdown()
        return [delays, _flaky_fetch_delays(pkg, seed=13)]
    delays, again = twin(scenario)
    assert len(delays) == 3 and again == delays
    # attempt k sleeps min(cap, base * 2^(k-1)) * U[0.5, 1.0)
    assert 0.05 <= delays[0] <= 0.1
    assert 0.10 <= delays[1] <= 0.2
    assert 0.15 <= delays[2] <= 0.3  # capped at 300 ms


def test_fetch_max_retries_is_a_conf():
    def scenario(pkg):
        c = conf(pkg, **{"spark.rapids.shuffle.fetch.maxRetries": 7})
        env = env_init(pkg, c)
        t = mod(pkg, "shuffle.ici_transport").IciShuffleTransport(c)
        client = mod(pkg, "shuffle.client_server").ShuffleClient(
            None, t, mod(pkg, "shuffle.catalog").ShuffleReceivedBufferCatalog(
                env.catalog), env.host_store, conf=c)
        t.shutdown()
        return client.max_retries
    assert twin(scenario) == 7


# -- AQE's stage-level retry -------------------------------------------------
def _flaky_exchange(pkg, fail_times):
    """A stage input whose first `fail_times` materializations die with a
    FetchFailedError (recovery exhausted at the AQE boundary)."""
    CS = mod(pkg, "shuffle.client_server")
    T = mod(pkg, "types")
    CB = mod(pkg, "columnar.batch").ColumnarBatch
    MS = mod(pkg, "utils.metrics").MetricSet

    class Flaky:
        def __init__(self):
            self.calls = 0
            self.metrics = MS()

        def output_schema(self):
            return T.Schema(())

        def output_partition_count(self):
            return 1

        def device(self):
            import torch
            return torch.device("cpu")

        def execute_partitions(self):
            self.calls += 1
            if self.calls <= fail_times:
                raise CS.FetchFailedError("tcp://dead:1", None, "injected")
            return [iter([CB(T.Schema(()), [], 5)])]
    return Flaky()


@pytest.mark.parametrize("fail_times,allowed", [(1, 3), (99, 2)],
                         ids=["rematerializes", "exhaustion_raises"])
def test_aqe_stage_retry(fail_times, allowed):
    """The reference's test_aqe_stage_rematerializes_on_fetch_failed (one
    failure, three attempts allowed: the second materialization lands)
    and test_aqe_stage_retry_exhaustion_raises (bounded at two)."""
    def scenario(pkg):
        conf(pkg, **{"spark.rapids.sql.pipeline.enabled": False,
                     "spark.rapids.shuffle.recovery.maxStageAttempts":
                         allowed})
        ex = _flaky_exchange(pkg, fail_times)
        stage = mod(pkg, "plan.aqe").ShuffleQueryStageExec(ex)
        if fail_times < allowed:
            sizes = stage.partition_sizes()  # a degenerate batch: 0 bytes
        else:
            CS = mod(pkg, "shuffle.client_server")
            with pytest.raises(CS.FetchFailedError):
                stage.partition_sizes()
            sizes = None
        return [sizes, ex.calls, ex.metrics.as_dict().get(
            "numStageRetries", 0)]
    got = twin(scenario)
    assert got == ([[0], 2, 1] if fail_times == 1 else [None, 2, 1])


# -- the manager-lane exchange under peer kill --------------------------------
def _mgr_conf(pkg, injected, **extra):
    kv = {
        "spark.rapids.shuffle.enabled": True,
        "spark.rapids.shuffle.localExecutors": 2,
        "spark.rapids.shuffle.bounceBuffers.size": 2048,
        "spark.rapids.shuffle.fetch.maxRetries": 1,
        "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
        "spark.rapids.shuffle.recovery.blacklist.failureThreshold": 1,
        "spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.sql.incompatibleOps.enabled": True,
    }
    if injected:
        kv["spark.rapids.shuffle.transport.faultInjection."
           "peerKillAfterFrames"] = 4
    kv.update(extra)
    return mod(pkg, "config").RapidsConf(kv)


def _exchange_metric_totals(pkg, plan) -> dict:
    SEE = mod(pkg, "shuffle.exchange").ShuffleExchangeExec
    names = ("numFetchFailures", "numMapRecomputes", "numStageRetries",
             "numPeersBlacklisted")
    tot = dict.fromkeys(names, 0.0)

    def walk(node):
        if isinstance(node, SEE):
            d = node.metrics.as_dict()
            for k in names:
                tot[k] += d.get(k, 0)
        for ch in getattr(node, "children", []):
            walk(ch)
        for attr in ("exchange", "stage", "tpu_child", "cpu_child"):
            if hasattr(node, attr):
                walk(getattr(node, attr))
    walk(plan)
    return tot


def test_exchange_recovers_bit_exact_under_peer_kill():
    """The exchange alone: the executor holding half the map outputs is
    killed; the read comes back bit-exact, in the same batch order, with
    recomputes and stage retries on the meter, in both packages."""
    rng = np.random.default_rng(7)
    df = pd.DataFrame({"k": rng.integers(0, 50, 4000).astype(np.int64),
                       "v": rng.integers(0, 10**6, 4000).astype(np.int64)})

    def run(pkg, injected):
        reset_world(pkg)
        C = mod(pkg, "config")
        c = _mgr_conf(pkg, injected)
        with C.session(c):
            env_init(pkg, c)
            E = mod(pkg, "exprs.base")
            HP = mod(pkg, "shuffle.partitioning").HashPartitioning
            SEE = mod(pkg, "shuffle.exchange").ShuffleExchangeExec
            ex = SEE(HP([E.col("k")], 3), local_source(pkg, df, 4))
            parts = [[(k, v) for b in it for k, v in zip(
                b.to_pandas()["k"], b.to_pandas()["v"])]
                for it in ex.execute_partitions()]
        return parts, ex.metrics.as_dict()

    out = {}
    for pkg in PKGS:
        base, m0 = run(pkg, False)
        got, m1 = run(pkg, True)
        assert m0.get("numFetchFailures", 0) == 0
        assert m1["numFetchFailures"] >= 1 and m1["numMapRecomputes"] >= 1
        assert m1["numStageRetries"] >= 1 and m1["numPeersBlacklisted"] >= 1
        assert got == base
        out[pkg] = got
    assert out[PORT] == out[REF]


_TPCH_TABLES = {}


def _tpch_tables():
    if not _TPCH_TABLES:
        TD = mod(PORT, "models.tpch_data")
        _TPCH_TABLES["t"] = TD.gen_tables(np.random.default_rng(11), 800)
    return _TPCH_TABLES["t"]


@pytest.mark.parametrize("query,kill_frames", [(1, 1), (5, 4)])
def test_tpch_manager_lane_bit_exact_under_peer_kill(query, kill_frames):
    """TPC-H through the manager lane under seeded peer kill comes back
    bit-exact against the uninjected run, with map recomputes and stage
    retries on the meter (Q1's shuffled partial aggregates are six groups,
    so its peer dies at the first frame; Q5's die mid-stream), and equal
    to the reference's manager lane and to its CPU engine."""
    tables = _tpch_tables()
    C = mod(PORT, "config")
    O = mod(PORT, "plan.overrides")
    TD = mod(PORT, "models.tpch_data")
    Q = mod(PORT, "models.tpch_queries").QUERIES

    def run(injected):
        reset_world(PORT)
        extra = ({"spark.rapids.shuffle.transport.faultInjection."
                  "peerKillAfterFrames": kill_frames} if injected else {})
        c = _mgr_conf(PORT, False, **extra)

        def runner(p):
            return O.collect(O.accelerate(p, c, device="cpu"), c)
        plan = O.accelerate(Q[query](TD.sources(tables, 2), runner), c,
                            device="cpu")
        out = O.collect(plan, c)
        return out, _exchange_metric_totals(PORT, plan)

    expected, m0 = run(False)
    got, m1 = run(True)
    assert m0["numFetchFailures"] == 0, m0
    assert m1["numFetchFailures"] > 0, m1
    assert m1["numMapRecomputes"] > 0, m1
    assert m1["numStageRetries"] > 0, m1
    assert list(expected.columns) == list(got.columns)
    e = expected.sort_values(list(expected.columns)).reset_index(drop=True)
    g = got.sort_values(list(got.columns)).reset_index(drop=True)
    for col in e.columns:
        np.testing.assert_array_equal(
            e[col].to_numpy(), g[col].to_numpy(),
            err_msg=f"q{query} column {col} not bit-exact under recovery")
    RB = mod(REF, "models.tpch_bench")
    ref = RB.run_query(query, tables, engine="tpu",
                       conf=_mgr_conf(REF, False))
    compare_frames(ref, got, f"q{query} against the reference's lane")
    cpu = RB.run_query(query, tables, engine="cpu")
    compare_frames(cpu, got, f"q{query}-recovered")
