"""spark_rapids_tpu_torch's shuffle manager lane against spark_rapids_tpu's:
twins of tests/test_shuffle_manager.py (transport primitives, the caching
writer and reader over the spillable catalog, the client/server protocol
over mocked, loopback and TCP connections, the three codecs, the exchange
through the manager) and tests/test_fault_injection.py (seeded drops and
corruption, total loss, the frame CRC), each running the same inputs
through both packages (the reference under JAX_PLATFORMS=cpu, the port
on device="cpu") and holding their observations equal: rows, keys,
order, bytes.  Plus the cross-package cases: frames encoded by either
package decode in the other's `decode_frame`, byte for byte the same,
the CRC catches the same flipped bit in both, serialized payloads cross
over both ways, and `FaultInjector` draws the same sequence for a seed.

The port's serialized payload header carries two keys of its own, which
the reference's reader ignores ("narrow", "nullable": columnar/serde.py), so a
batch with an int32 shadow serializes to other bytes than the
reference's; a batch without one serializes to the same bytes, and every
payload decodes in both packages.

Helpers here (`PKGS`, `mod`, `twin`, `conf`, `env_init`, `batch`,
`values`, `local_source`, `reset_world`) are shared by the other
test_torch_shuffle_*.py files.
"""
import importlib

import numpy as np
import pandas as pd
import pytest

from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

REF, PORT = "spark_rapids_tpu", "spark_rapids_tpu_torch"
PKGS = (REF, PORT)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def reset_world(pkg: str) -> None:
    M = mod(pkg, "shuffle.manager")
    M.MapOutputRegistry.clear()
    mod(pkg, "shuffle.recovery").PeerHealth.get().clear()
    for eid in list(M.TpuShuffleManager._managers):
        M.TpuShuffleManager._managers[eid].close()
    mod(pkg, "memory.env").ResourceEnv.shutdown()


@pytest.fixture(autouse=True)
def clean_world(one_torch_thread):  # noqa: F811
    for p in PKGS:
        reset_world(p)
    yield
    for p in PKGS:
        reset_world(p)


def conf(pkg: str, **kv):
    C = mod(pkg, "config")
    c = C.RapidsConf({k.replace("__", "."): v for k, v in kv.items()})
    C.set_active_conf(c)
    return c


def env_init(pkg: str, c):
    RE = mod(pkg, "memory.env").ResourceEnv
    return RE.init(c) if pkg == REF else RE.init(c, device="cpu")


def batch(pkg: str, data: dict):
    CB = mod(pkg, "columnar.batch").ColumnarBatch
    return (CB.from_numpy(data) if pkg == REF
            else CB.from_numpy(data, device="cpu"))


def kv_batch(pkg: str, lo: int, n: int):
    return batch(pkg, {
        "k": np.arange(lo, lo + n, dtype=np.int64),
        "s": np.array([f"v{i}" for i in range(lo, lo + n)], object)})


def values(batches, name: str) -> list:
    return [v for b in batches for v in b.to_pandas()[name].tolist()]


def local_source(pkg: str, df: pd.DataFrame, num_partitions: int = 1):
    """The reference's LocalBatchSource.from_pandas cut (row ranges at
    linspace bounds), in either package."""
    LBS = mod(pkg, "exec.basic").LocalBatchSource
    n = len(df)
    bounds = np.linspace(0, n, max(1, num_partitions) + 1).astype(int)
    parts = []
    for i in range(max(1, num_partitions)):
        chunk = df.iloc[bounds[i]:bounds[i + 1]]
        parts.append([batch(pkg, {c: chunk[c].to_numpy() for c in df})]
                     if len(chunk) else [])
    return LBS(parts) if pkg == REF else LBS(parts, device="cpu")


def manager(pkg: str, eid: str, env, c):
    return mod(pkg, "shuffle.manager").TpuShuffleManager(eid, env, c)


def twin(scenario):
    """Run `scenario(pkg)` on both packages; the observations must be
    equal.  Returns the port's."""
    ref = scenario(REF)
    reset_world(REF)
    got = scenario(PORT)
    assert got == ref, (got, ref)
    return got


# -- transport primitives ----------------------------------------------------
def test_bounce_buffer_manager_blocking():
    def scenario(pkg):
        bb = mod(pkg, "shuffle.transport").BounceBufferManager(64, 2)
        a, b = bb.acquire(), bb.acquire()
        obs = [bb.acquire(blocking=False) is None]
        bb.release(a)
        c = bb.acquire()
        obs += [c is not None, bb.free_count]
        bb.release(b)
        bb.release(c)
        return obs + [bb.free_count]
    assert twin(scenario) == [True, True, 0, 2]


def test_inflight_limiter_throttles():
    def scenario(pkg):
        lim = mod(pkg, "shuffle.transport").InflightLimiter(100)
        obs = [lim.acquire(60), lim.acquire(60, timeout=0.01)]
        lim.release(60)
        obs.append(lim.acquire(100))
        lim.release(100)
        # oversized requests clamp to the max instead of deadlocking
        obs.append(lim.acquire(10_000))
        lim.release(10_000)
        return obs + [lim._used]
    assert twin(scenario) == [True, False, True, True, 0]


# -- writer/catalog ----------------------------------------------------------
def test_caching_writer_stores_spillable_and_cleans_up():
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        mgr = manager(pkg, "exec-0", env, c)
        mgr.register_shuffle(1)
        w = mgr.get_writer(1, map_id=0)
        w.write_partition(0, kv_batch(pkg, 0, 10))
        w.write_partition(1, kv_batch(pkg, 10, 5))
        status = w.commit(2)
        obs = [status.partition_sizes[0] > 0, len(env.catalog)]
        # spill the output to the host, then read it back
        obs.append(env.device_store.synchronous_spill(0) > 0)
        got = list(mgr.get_reader(1, 0))
        obs += [values(got, "k"), values(got, "s")]
        mgr.unregister_shuffle(1)
        return obs + [len(env.catalog)]
    got = twin(scenario)
    assert got[:3] == [True, 2, True] and got[3] == list(range(10))
    assert got[-1] == 0


def test_caching_writer_abort_removes_task_output():
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        mgr = manager(pkg, "exec-0", env, c)
        mgr.register_shuffle(3)
        w = mgr.get_writer(3, 0)
        w.write_partition(0, kv_batch(pkg, 0, 4))
        w.abort()
        obs = [len(env.catalog)]
        w2 = mgr.get_writer(3, 1)
        w2.write_partition(0, kv_batch(pkg, 0, 6))
        w2.commit(1)
        return obs + [values(mgr.get_reader(3, 0), "k")]
    assert twin(scenario) == [0, list(range(6))]


def test_degenerate_batch_roundtrip():
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        mgr = manager(pkg, "exec-0", env, c)
        mgr.register_shuffle(4)
        w = mgr.get_writer(4, 0)
        T = mod(pkg, "types")
        CB = mod(pkg, "columnar.batch").ColumnarBatch
        w.write_partition(0, CB(T.Schema(()), [], 123))
        w.commit(1)
        return [b.num_rows for b in mgr.get_reader(4, 0)]
    assert twin(scenario) == [123]


# -- protocol state machines over mocked connections -------------------------
def _recorder(pkg):
    CS = mod(pkg, "shuffle.client_server")

    class Recorder(CS.ShuffleReceiveHandler):
        def __init__(self):
            self.received, self.errors, self.expected = [], [], None

        def start(self, n):
            self.expected = n

        def batch_received(self, bid):
            self.received.append(bid)

        def transfer_error(self, msg):
            self.errors.append(msg)
    return Recorder()


def _flaky_connection(pkg, server, fail_times=0):
    """Mock wire: the first `fail_times` fetches die mid-stream after one
    chunk (reference RapidsShuffleClientSuite error paths)."""
    TR = mod(pkg, "shuffle.transport")

    class Flaky(TR.Connection):
        def __init__(self):
            self.fetch_calls = 0

        def request(self, frame):
            kind, payload = TR.decode_frame(frame[4:])
            blocks = [TR.BlockIdMsg(*b) for b in payload["blocks"]]
            return TR.decode_frame(TR.meta_response(
                server.handle_metadata_request(blocks))[4:])

        def fetch(self, table_ids, on_chunk):
            self.fetch_calls += 1
            if self.fetch_calls <= fail_times:
                emitted = [0]

                def flaky_emit(tid, seq, chunk, is_last, codec_id=-1,
                               raw_len=0):
                    if emitted[0] >= 1:
                        raise OSError("simulated link failure")
                    emitted[0] += 1
                    on_chunk(tid, seq, chunk, is_last, codec_id, raw_len)
                try:
                    return server.send_state(table_ids, flaky_emit)
                except OSError:
                    return TR.Transaction(TR.TransactionStatus.ERROR,
                                          "link down")
            return server.send_state(table_ids, on_chunk)
    return Flaky()


def two_exec_setup(pkg, c):
    env = env_init(pkg, c)
    cat_mod = mod(pkg, "shuffle.catalog")
    server_cat = cat_mod.ShuffleBufferCatalog(env.catalog)
    server_cat.register_shuffle(9)
    transport = mod(pkg, "shuffle.ici_transport").IciShuffleTransport(c)
    server = mod(pkg, "shuffle.client_server").ShuffleServer(
        server_cat, transport)
    env.device_store.add_batch(server_cat.next_shuffle_buffer_id(9, 0, 0),
                               kv_batch(pkg, 0, 50))
    env.device_store.add_batch(server_cat.next_shuffle_buffer_id(9, 1, 0),
                               kv_batch(pkg, 50, 30))
    recv_cat = cat_mod.ShuffleReceivedBufferCatalog(env.catalog)
    return env, transport, server, recv_cat


def _received_keys(env, rec) -> list:
    out = []
    for bid in rec.received:
        with env.catalog.acquired(bid) as buf:
            out += values([buf.get_columnar_batch()], "k")
    return out


def test_client_fetch_with_mocked_transport():
    def scenario(pkg):
        c = conf(pkg)
        env, transport, server, recv_cat = two_exec_setup(pkg, c)
        CS = mod(pkg, "shuffle.client_server")
        B = mod(pkg, "shuffle.transport").BlockIdMsg
        client = CS.ShuffleClient(_flaky_connection(pkg, server), transport,
                                  recv_cat, env.host_store)
        rec = _recorder(pkg)
        metas = client.fetch_blocks([B(9, 0, 0), B(9, 1, 0)], 7, rec)
        obs = [len(metas), rec.expected, _received_keys(env, rec)]
        recv_cat.release_task(7)
        transport.shutdown()
        # received buffers freed with the task
        return obs + [any(env.catalog.is_registered(b)
                          for b in rec.received)]
    assert twin(scenario) == [2, 2, list(range(80)), False]


def test_client_retries_flaky_link_then_succeeds():
    # small bounce buffers: a multi-chunk transfer, so the mid-stream
    # failure leaves a PARTIAL buffer that must be dropped and refetched
    def scenario(pkg):
        c = conf(pkg, **{"spark.rapids.shuffle.bounceBuffers.size": 128})
        env, transport, server, recv_cat = two_exec_setup(pkg, c)
        CS = mod(pkg, "shuffle.client_server")
        B = mod(pkg, "shuffle.transport").BlockIdMsg
        conn = _flaky_connection(pkg, server, fail_times=2)
        client = CS.ShuffleClient(conn, transport, recv_cat, env.host_store)
        rec = _recorder(pkg)
        client.fetch_blocks([B(9, 0, 0), B(9, 1, 0)], 1, rec)
        obs = [_received_keys(env, rec), conn.fetch_calls >= 3,
               transport.receive_limiter._used]
        transport.shutdown()
        return obs
    assert twin(scenario) == [list(range(80)), True, 0]


def test_client_gives_up_after_max_retries():
    def scenario(pkg):
        c = conf(pkg, **{"spark.rapids.shuffle.bounceBuffers.size": 128})
        env, transport, server, recv_cat = two_exec_setup(pkg, c)
        CS = mod(pkg, "shuffle.client_server")
        B = mod(pkg, "shuffle.transport").BlockIdMsg
        client = CS.ShuffleClient(_flaky_connection(pkg, server, 99),
                                  transport, recv_cat, env.host_store)
        rec = _recorder(pkg)
        with pytest.raises(CS.FetchFailedError):
            client.fetch_blocks([B(9, 0, 0)], 1, rec)
        transport.shutdown()
        return [bool(rec.errors), transport.receive_limiter._used]
    assert twin(scenario) == [True, 0]


def test_chunked_transfer_respects_bounce_buffer_size():
    def scenario(pkg):
        c = conf(pkg, **{"spark.rapids.shuffle.bounceBuffers.size": 256})
        env, transport, server, _ = two_exec_setup(pkg, c)
        B = mod(pkg, "shuffle.transport").BlockIdMsg
        ok = mod(pkg, "shuffle.transport").TransactionStatus.SUCCESS
        chunks = []

        def spy(tid, seq, chunk, is_last, codec_id=-1, raw_len=0):
            chunks.append((seq, len(chunk), is_last))

        tid = server.handle_metadata_request([B(9, 0, 0)])[0].table_id
        blob = server.acquire_buffer_bytes(tid)
        txn = server.send_state([tid], spy)
        transport.shutdown()
        return [txn.status == ok, all(n <= 256 for _, n, _ in chunks),
                sum(n for _, n, _ in chunks) == len(blob), chunks[-1][2],
                [s for s, _, _ in chunks]]
    got = twin(scenario)
    assert got[:4] == [True, True, True, True]


# -- end to end across executors (loopback and TCP) --------------------------
def test_two_executor_shuffle_loopback():
    def scenario(pkg):
        c = conf(pkg)
        env = env_init(pkg, c)
        TC = mod(pkg, "memory.semaphore").TaskContext
        m0 = manager(pkg, "exec-0", env, c)
        m1 = manager(pkg, "exec-1", env, c)
        for m in (m0, m1):
            m.register_shuffle(11)
        w0 = m0.get_writer(11, 0)
        w0.write_partition(0, kv_batch(pkg, 0, 20))
        w0.write_partition(1, kv_batch(pkg, 20, 20))
        w0.commit(2)
        w1 = m1.get_writer(11, 1)
        w1.write_partition(0, kv_batch(pkg, 100, 10))
        w1.commit(2)
        with TC(1):
            got0 = values(m1.get_reader(11, 0, task_attempt_id=1), "k")
        with TC(2):
            got1 = values(m0.get_reader(11, 1, task_attempt_id=2), "k")
        return [got0, got1]
    got0, got1 = twin(scenario)
    # 10 local (exec-1) first, then 20 remote from exec-0
    assert sorted(got0) == list(range(20)) + list(range(100, 110))
    assert got1 == list(range(20, 40))


def _tcp_pair(pkg, c, shuffle_id, names=("exec-a", "exec-b")):
    env = env_init(pkg, c)
    m0 = manager(pkg, names[0], env, c)
    m1 = manager(pkg, names[1], env, c)
    for m in (m0, m1):
        m.register_shuffle(shuffle_id)
    return env, m0, m1


def _advertise_tcp(pkg, shuffle_id, map_id, status, m0):
    # force the wire lane: advertise the TCP address instead of loopback
    status.address = m0.tcp_address
    mod(pkg, "shuffle.manager").MapOutputRegistry.register(
        shuffle_id, map_id, status)


def test_two_executor_shuffle_tcp():
    def scenario(pkg):
        c = conf(pkg)
        _, m0, m1 = _tcp_pair(pkg, c, 12)
        w = m0.get_writer(12, 0)
        w.write_partition(0, kv_batch(pkg, 0, 64))
        _advertise_tcp(pkg, 12, 0, w.commit(1), m0)
        got = list(m1.get_reader(12, 0, timeout=5.0))
        return [values(got, "k"), values(got, "s")]
    assert twin(scenario)[0] == list(range(64))


def test_shuffle_reads_spilled_tiers_via_transport():
    def scenario(pkg):
        c = conf(pkg)
        env, m0, m1 = _tcp_pair(pkg, c, 13, ("exec-x", "exec-y"))
        w = m0.get_writer(13, 0)
        w.write_partition(0, kv_batch(pkg, 0, 40))
        _advertise_tcp(pkg, 13, 0, w.commit(1), m0)
        # the map output spills device -> host -> disk before the fetch
        env.device_store.synchronous_spill(0)
        env.host_store.synchronous_spill(0)
        return values(m1.get_reader(13, 0, timeout=5.0), "k")
    assert twin(scenario) == list(range(40))


# -- the exchange --------------------------------------------------------------
def _exchange_rows(pkg, df, n_out, num_partitions, **extra):
    C = mod(pkg, "config")
    c = C.RapidsConf({"spark.rapids.shuffle.enabled": True, **extra})
    with C.session(c):
        env_init(pkg, c)
        E = mod(pkg, "exprs.base")
        HP = mod(pkg, "shuffle.partitioning").HashPartitioning
        SEE = mod(pkg, "shuffle.exchange").ShuffleExchangeExec
        ex = SEE(HP([E.col("k")], n_out), local_source(pkg, df,
                                                       num_partitions))
        return [[(b.to_pandas()["k"].tolist(), b.to_pandas()["v"].tolist())
                 for b in it] for it in ex.execute_partitions()]


def test_exchange_via_shuffle_manager_parity():
    df = pd.DataFrame({"k": np.arange(57, dtype=np.int64) % 7,
                       "v": np.arange(57, dtype=np.int64)})
    ref = _exchange_rows(REF, df, 4, 3)
    got = _exchange_rows(PORT, df, 4, 3)
    assert len(got) == 4

    def rows(parts):
        return [sorted((k, v) for ks, vs in p for k, v in zip(ks, vs))
                for p in parts]
    # the same rows in the same partitions (the port's reduce side merges
    # a partition's batches; its rows keep their order)
    assert rows(got) == rows(ref)
    assert sorted(v for p in rows(got) for _, v in p) == list(range(57))
    key_home = {}
    for p, prow in enumerate(rows(got)):
        for k, _ in prow:
            assert key_home.setdefault(k, p) == p


def test_exchange_over_four_executors_equals_the_reference_lane():
    """localExecutors=4: map outputs spread over four executors of the
    process; the rows of each partition equal the reference's manager
    lane over four executors, in map order."""
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"k": rng.integers(0, 40, 3000).astype(np.int64),
                       "v": np.arange(3000, dtype=np.int64)})
    extra = {"spark.rapids.shuffle.localExecutors": 4}
    ref = _exchange_rows(REF, df, 5, 8, **extra)
    got = _exchange_rows(PORT, df, 5, 8, **extra)

    def flat(parts):
        return [[(k, v) for ks, vs in p for k, v in zip(ks, vs)]
                for p in parts]
    assert flat(got) == flat(ref)
    M = mod(PORT, "shuffle.manager")
    assert M.TpuShuffleManager.live_executors() == 4
    assert M.MapOutputRegistry.live_shuffles() == 0


def test_transport_loaded_reflectively():
    def scenario(pkg):
        t = mod(pkg, "shuffle.transport").make_transport(conf(pkg))
        ok = isinstance(t, mod(pkg, "shuffle.ici_transport")
                        .IciShuffleTransport)
        t.shutdown()
        return ok
    assert twin(scenario) is True


def test_degenerate_batch_remote_fetch():
    def scenario(pkg):
        c = conf(pkg)
        _, m0, m1 = _tcp_pair(pkg, c, 20, ("deg-a", "deg-b"))
        T = mod(pkg, "types")
        CB = mod(pkg, "columnar.batch").ColumnarBatch
        w = m0.get_writer(20, 0)
        w.write_partition(0, CB(T.Schema(()), [], 77))
        _advertise_tcp(pkg, 20, 0, w.commit(1), m0)
        return [b.num_rows for b in m1.get_reader(20, 0, timeout=5.0)]
    assert twin(scenario) == [77]


def test_received_buffers_freed_after_read():
    def scenario(pkg):
        c = conf(pkg)
        env, m0, m1 = _tcp_pair(pkg, c, 21, ("rel-a", "rel-b"))
        w = m0.get_writer(21, 0)
        w.write_partition(0, kv_batch(pkg, 0, 20))
        _advertise_tcp(pkg, 21, 0, w.commit(1), m0)
        before = len(env.catalog)
        got = values(m1.get_reader(21, 0, timeout=5.0), "k")
        # the fetched copy was freed with the reader
        obs = [got, len(env.catalog) - before]
        m0.unregister_shuffle(21)
        return obs + [len(env.catalog)]
    assert twin(scenario) == [list(range(20)), 0, 0]


def test_failed_map_stage_cleans_catalog():
    def scenario(pkg):
        C = mod(pkg, "config")
        c = conf(pkg, **{"spark.rapids.shuffle.enabled": True})
        env = env_init(pkg, c)
        LBS = mod(pkg, "exec.basic").LocalBatchSource
        E = mod(pkg, "exprs.base")
        HP = mod(pkg, "shuffle.partitioning").HashPartitioning
        SEE = mod(pkg, "shuffle.exchange").ShuffleExchangeExec
        first = kv_batch(pkg, 0, 8)

        class Exploding(LBS):
            def execute_partitions(self):
                def ok():
                    yield first

                def boom():
                    raise RuntimeError("map task failed")
                    yield  # pragma: no cover
                return [ok(), boom()]

        src = (Exploding([[first], []]) if pkg == REF
               else Exploding([[first], []], device="cpu"))
        with C.session(c):
            ex = SEE(HP([E.col("k")], 2), src)
            with pytest.raises(RuntimeError, match="map task failed"):
                ex.execute_partitions()
        return len(env.catalog)  # completed task 0's buffers freed too
    assert twin(scenario) == 0


# -- range partitioning above the small-input shortcut ----------------------
def _range_sort(pkg, df, c, parts, descending):
    N = mod(pkg, "plan.nodes")
    O = mod(pkg, "plan.overrides")
    S = mod(pkg, "exec.sort")
    E = mod(pkg, "exprs.base")
    order = [(S.desc if descending else S.asc)(E.col("k"))]
    plan = N.CpuSort(order, N.CpuSource.from_pandas(df, parts))
    expected = plan.collect()["k"].to_numpy()
    acc = (O.accelerate(plan, c) if pkg == REF
           else O.accelerate(plan, c, device="cpu"))
    return expected, O.collect(acc, c)["k"].to_numpy()


@pytest.mark.parametrize("manager_lane", [False, True],
                         ids=["local_lane", "manager_lane"])
def test_range_exchange_parity(manager_lane, monkeypatch):
    """The real range path (bounds sampled, then split): the small-input
    bailout is off, through the local lane (the reference's
    test_range_exchange_large_input_parity, descending over 4
    partitions) and the manager lane (its
    test_range_exchange_via_manager, ascending over 3)."""
    rng = np.random.default_rng(23 if manager_lane else 17)
    n = 2000 if manager_lane else 5000
    df = pd.DataFrame({"k": rng.integers(
        0 if manager_lane else -1000, 500 if manager_lane else 1000,
        n).astype(np.int64)})
    if not manager_lane:
        df["v"] = rng.normal(size=n)
    out = {}
    for pkg in PKGS:
        monkeypatch.setattr(mod(pkg, "shuffle.exchange").ShuffleExchangeExec,
                            "SMALL_RANGE_INPUT_ROWS", 0)
        C = mod(pkg, "config")
        c = C.RapidsConf({"spark.rapids.shuffle.enabled": manager_lane})
        if manager_lane:
            env_init(pkg, c)
        expected, got = _range_sort(pkg, df, c, 3 if manager_lane else 4,
                                    not manager_lane)
        np.testing.assert_array_equal(expected, got)
        out[pkg] = got
    np.testing.assert_array_equal(out[REF], out[PORT])


# -- compression codecs (reference TableCompressionCodec.scala) --------------
def test_codec_registry_and_roundtrip():
    blob = b"shuffle payload " * 1000

    def scenario(pkg):
        CC = mod(pkg, "shuffle.compression")
        obs = [CC.get_codec("none") is None, CC.get_codec(None) is None]
        with pytest.raises(ValueError, match="Unknown table codec"):
            CC.get_codec("bogus")
        with pytest.raises(ValueError, match="Unknown codec ID"):
            CC.get_codec(99)
        for name in ("copy", "lz4", "zstd"):
            codec = CC.get_codec(name)
            comp = codec.compress(blob)
            obs += [codec.codec_id, CC.get_codec(codec.codec_id) is codec,
                    codec.decompress(comp, len(blob)) == blob,
                    len(comp) < len(blob), comp]
        return obs
    got = twin(scenario)
    assert got[:2] == [True, True]
    assert [got[2 + 5 * i + 3] for i in range(3)] == [False, True, True]


def test_legacy_codec_conf_names_alias():
    def scenario(pkg):
        CC = mod(pkg, "shuffle.compression")
        return [isinstance(CC.get_codec("lz4-host"), CC.Lz4CompressionCodec),
                isinstance(CC.get_codec("zstd-host"),
                           CC.ZstdCompressionCodec)]
    assert twin(scenario) == [True, True]


def test_loopback_fetch_skips_codec():
    """An in-process fetch pays no compress/decompress: send_state with
    wire=False emits raw payloads (codec_id -1)."""
    def scenario(pkg):
        c = conf(pkg, **{"spark.rapids.shuffle.compression.codec": "zstd"})
        _, m0, _m1 = _tcp_pair(pkg, c, 15, ("exec-lb0", "exec-lb1"))
        w = m0.get_writer(15, 0)
        w.write_partition(0, kv_batch(pkg, 0, 8))
        w.commit(1)
        B = mod(pkg, "shuffle.transport").BlockIdMsg
        tid = m0.server.handle_metadata_request([B(15, 0, 0)])[0].table_id
        seen = []

        def spy(t, seq, chunk, is_last, codec_id=-1, raw_len=0):
            seen.append(codec_id)

        m0.server.send_state([tid], spy, wire=False)
        loop = list(seen)
        m0.server.send_state([tid], spy, wire=True)
        return [loop, seen[len(loop):]]
    loop, wire = twin(scenario)
    assert loop and all(cid == -1 for cid in loop)
    assert wire and all(cid == 2 for cid in wire)  # the wire compresses


@pytest.mark.parametrize("codec", ["copy", "lz4", "zstd"])
def test_two_executor_shuffle_tcp_compressed(codec):
    """A fetch over the TCP lane with wire compression: the server
    compresses each serialized batch, the DATA frames carry the codec id
    and the raw length, the receiver inflates before the host store."""
    def scenario(pkg):
        c = conf(pkg, **{"spark.rapids.shuffle.compression.codec": codec})
        _, m0, m1 = _tcp_pair(pkg, c, 14, ("exec-c0", "exec-c1"))
        w = m0.get_writer(14, 0)
        w.write_partition(0, kv_batch(pkg, 0, 64))
        _advertise_tcp(pkg, 14, 0, w.commit(1), m0)
        M = mod(pkg, "utils.metrics")
        metrics = M.MetricSet()
        got = list(m1.get_reader(14, 0, timeout=5.0, metrics=metrics))
        d = metrics.as_dict()
        return [values(got, "k"), values(got, "s"),
                d.get("shuffleCompressedBytes", 0) > 0]
    assert twin(scenario)[0] == list(range(64))


def test_exchange_reduce_side_consolidation():
    """Many small map-side batches leave the local lane as few merged,
    TIGHT batches (the reduce-side GpuCoalesceBatches role)."""
    rng = np.random.default_rng(42)
    dfs = [pd.DataFrame({"k": rng.integers(0, 1000, 500).astype(np.int64),
                         "v": rng.random(500)}) for _ in range(40)]

    def scenario(pkg):
        C = mod(pkg, "config")
        LBS = mod(pkg, "exec.basic").LocalBatchSource
        E = mod(pkg, "exprs.base")
        HP = mod(pkg, "shuffle.partitioning").HashPartitioning
        SEE = mod(pkg, "shuffle.exchange").ShuffleExchangeExec
        bs = [batch(pkg, {c: d[c].to_numpy() for c in d}) for d in dfs]
        src = LBS([bs]) if pkg == REF else LBS([bs], device="cpu")
        with C.session(C.RapidsConf({})):
            ex = SEE(HP([E.col("k")], 2), src)
            parts = [list(it) for it in ex.execute_partitions()]
        return [[len(p), max(b.capacity for b in p),
                 values(p, "k"), values(p, "v")] for p in parts]
    got = twin(scenario)
    assert sum(len(p[2]) for p in got) == 40 * 500
    for n_batches, cap, _, _ in got:
        assert n_batches <= 4 and cap <= (1 << 16) * 2


# -- wire fault injection (twins of tests/test_fault_injection.py) ----------
def _faulty_fetch(pkg, shuffle_id, drop=0.0, corrupt=0.0, seed=7,
                  rows=4000):
    c = conf(pkg, **{
        "spark.rapids.shuffle.transport.faultInjection.dropRate": drop,
        "spark.rapids.shuffle.transport.faultInjection.corruptRate":
            corrupt,
        "spark.rapids.shuffle.transport.faultInjection.seed": seed,
        # tiny bounce buffers: many wire chunks per transfer, so the
        # per-chunk injector has trials to fire on
        "spark.rapids.shuffle.bounceBuffers.size": 2048,
        "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0,
    })
    _, m0, m1 = _tcp_pair(pkg, c, shuffle_id, ("flt-a", "flt-b"))
    w = m0.get_writer(shuffle_id, 0)
    w.write_partition(0, kv_batch(pkg, 0, rows))
    _advertise_tcp(pkg, shuffle_id, 0, w.commit(1), m0)
    got = list(m1.get_reader(shuffle_id, 0, timeout=10.0))
    return got, m0.transport.faults


@pytest.mark.parametrize("kind,seed", [("drop", 3), ("corrupt", 1)])
def test_injected_faults_recover_bit_exact(kind, seed):
    """Seeded drops (the reference's test_injected_drops_recover_bit_exact)
    and corruptions caught by the frame CRC (its
    test_injected_corruption_detected_by_crc_and_recovered): the retries
    recover every row and string."""
    def scenario(pkg):
        got, faults = _faulty_fetch(pkg, 31, seed=seed,
                                    **{kind: 0.015})
        fired = (faults.injected_drops if kind == "drop"
                 else faults.injected_corruptions)
        return [fired > 0, sorted(values(got, "k")),
                sorted(values(got, "s"))]
    fired, ks, ss = twin(scenario)
    assert fired, "injector never fired"
    assert ks == list(range(4000))
    assert ss == sorted(f"v{i}" for i in range(4000))


def test_total_loss_exhausts_retries_with_fetch_failed():
    def scenario(pkg):
        CS = mod(pkg, "shuffle.client_server")
        with pytest.raises(CS.FetchFailedError):
            _faulty_fetch(pkg, 33, drop=1.0)
        return True
    assert twin(scenario)


def test_data_frame_crc_detects_bitflip():
    def scenario(pkg):
        TR = mod(pkg, "shuffle.transport")
        frame = TR.encode_data(5, 2, b"payload-bytes", -1, 0)
        kind, (tid, seq, chunk, codec, raw) = TR.decode_frame(frame[4:])
        flipped = bytearray(frame[4:])
        flipped[-3] ^= 0x10
        with pytest.raises(TR.WireCorruption):
            TR.decode_frame(bytes(flipped))
        return [frame, int(kind), tid, seq, chunk, codec, raw]
    assert twin(scenario)[1:] == [5, 5, 2, b"payload-bytes", -1, 0]


# -- across the two packages ---------------------------------------------------
def _frames(pkg) -> list:
    TR = mod(pkg, "shuffle.transport")
    T = mod(pkg, "types")
    meta = TR.TableMetaMsg(7, 3, 1, 2, 40, 1234, (
        ("k", T.TypeId.INT64.value, True), ("s", T.TypeId.STRING.value,
                                            False)))
    return [TR.meta_request([TR.BlockIdMsg(3, 1, 2), TR.BlockIdMsg(3, 0, 2)]),
            TR.meta_response([meta]),
            TR.transfer_request([7, 8, 9]),
            TR.encode_control(TR.MsgKind.TRANSFER_RESPONSE,
                              {"status": "success", "error": None,
                               "bytes": 99}),
            TR.encode_data(7, (3 << 1) | 1, b"\x00\x01chunk", 2, 4096),
            TR.encode_data(2 ** 40, 0, b"", -1, 0)]


def test_frames_are_byte_for_byte_the_references_and_cross_decode():
    ref, port = _frames(REF), _frames(PORT)
    assert ref == port
    RT, PT = mod(REF, "shuffle.transport"), mod(PORT, "shuffle.transport")
    for f in ref:
        rk, rp = RT.decode_frame(f[4:])
        pk, pp = PT.decode_frame(f[4:])
        assert int(rk) == int(pk) and rp == pp
    # the same flipped payload bit fails both packages' CRC
    bad = bytearray(ref[4][4:])
    bad[-2] ^= 0x04
    with pytest.raises(RT.WireCorruption):
        RT.decode_frame(bytes(bad))
    with pytest.raises(PT.WireCorruption):
        PT.decode_frame(bytes(bad))
    # and a metadata response parses to the same TableMetaMsg fields
    _, payload = PT.decode_frame(ref[1][4:])
    (pm,) = PT.parse_meta_response(payload)
    (rm,) = RT.parse_meta_response(payload)
    assert dataclass_tuple(pm) == dataclass_tuple(rm)


def dataclass_tuple(x) -> tuple:
    import dataclasses
    return dataclasses.astuple(x)


def test_payloads_cross_over_both_ways_inside_data_frames():
    """A batch serialized by one package, carried in a zstd-compressed
    DATA frame of the other, deserializes to the same rows; without an
    int32 shadow the two packages' payloads are the same bytes."""
    rs = mod(REF, "columnar.serde")
    ps = mod(PORT, "columnar.serde")
    PT, RT = mod(PORT, "shuffle.transport"), mod(REF, "shuffle.transport")
    big = np.array([2 ** 40 + i for i in range(300)], np.int64)
    data = {"k": big, "s": np.array([f"v{i}" if i % 7 else None
                                     for i in range(300)], object),
            "d": np.linspace(0, 1, 300)}
    ref_blob = rs.serialize_batch(batch(REF, data))
    port_batch = batch(PORT, {"k": big, "s": data["s"]})
    port_blob = ps.serialize_batch(port_batch)
    assert port_blob == rs.serialize_batch(batch(REF, {"k": big,
                                                       "s": data["s"]}))
    zstd = mod(PORT, "shuffle.compression").get_codec("zstd")
    for blob, enc, dec, ser in ((ref_blob, RT, PT, ps),
                                (ps.serialize_batch(batch(PORT, data)),
                                 PT, RT, rs)):
        comp = zstd.compress(blob)
        frame = enc.encode_data(1, 1, comp, zstd.codec_id, len(blob))
        _, (_, _, chunk, cid, raw) = dec.decode_frame(frame[4:])
        cc = mod(dec.__name__.split(".")[0], "shuffle.compression")
        out = cc.get_codec(cid).decompress(chunk, raw)
        back = (ser.deserialize_batch(out, "cpu") if ser is ps
                else ser.deserialize_batch(out))
        df = back.to_pandas()
        assert df["k"].tolist() == big.tolist()
        assert df["s"].tolist() == [None if v is None else v
                                    for v in data["s"]]
        np.testing.assert_array_equal(df["d"].to_numpy(), data["d"])


def test_fault_injector_draws_the_references_sequence():
    def draws(pkg):
        FI = mod(pkg, "shuffle.ici_transport").FaultInjector
        f = FI(0.3, 0.4, seed=11, kill_after_frames=5)
        frame = bytes(range(64))
        return ([f.maybe_drop() for _ in range(40)]
                + [f.maybe_corrupt_frame(frame, 30) for _ in range(40)]
                + [f.note_frame() for _ in range(7)]
                + [f.injected_drops, f.injected_corruptions,
                   f.frames_served, f.peer_killed])
    assert draws(REF) == draws(PORT)


def test_shuffle_threads_end_with_their_managers():
    """The accept loop and the handler threads of every TCP server end
    when their managers close; nothing of the shuffle outlives them."""
    c = conf(PORT)
    _, m0, m1 = _tcp_pair(PORT, c, 40, ("thr-a", "thr-b"))
    w = m0.get_writer(40, 0)
    w.write_partition(0, kv_batch(PORT, 0, 64))
    _advertise_tcp(PORT, 40, 0, w.commit(1), m0)
    assert values(m1.get_reader(40, 0, timeout=5.0), "k") == list(range(64))
    servers = [s for m in (m0, m1) for s in m.transport._servers]
    threads = [t for s in servers for t in [s._thread] + s._handlers]
    assert len(threads) >= 3  # two accept loops and a handler
    M = mod(PORT, "shuffle.manager")
    M.TpuShuffleManager.close_all()
    assert M.TpuShuffleManager.live_executors() == 0
    assert not [t.name for t in threads if t.is_alive()]


def _manager_exchange(df, n_out, num_partitions, batches=None):
    C = mod(PORT, "config")
    c = C.RapidsConf({"spark.rapids.shuffle.enabled": True,
                      "spark.rapids.shuffle.localExecutors": 2})
    env = env_init(PORT, c)
    E = mod(PORT, "exprs.base")
    HP = mod(PORT, "shuffle.partitioning").HashPartitioning
    SEE = mod(PORT, "shuffle.exchange").ShuffleExchangeExec
    LBS = mod(PORT, "exec.basic").LocalBatchSource
    src = (LBS(batches, device="cpu") if batches is not None
           else local_source(PORT, df, num_partitions))
    return c, env, SEE(HP([E.col("k")], n_out), src)


def test_unread_partitions_free_the_shuffle_when_dropped():
    """A consumer that stops early (a failure downstream, a limit) leaves
    readers unstarted: dropping them unregisters the shuffle and frees
    its map outputs, as the last finished reader would."""
    import gc
    df = pd.DataFrame({"k": np.arange(400, dtype=np.int64) % 13,
                       "v": np.arange(400, dtype=np.int64)})
    C = mod(PORT, "config")
    M = mod(PORT, "shuffle.manager")
    c, env, ex = _manager_exchange(df, 4, 3)
    with C.session(c):
        readers = ex.execute_partitions()
        assert len(env.catalog) > 0 and M.MapOutputRegistry.live_shuffles()
        next(readers[0])  # one started, three never
        del readers
        gc.collect()
    assert M.MapOutputRegistry.live_shuffles() == 0
    assert len(env.catalog) == 0


def test_a_failed_fast_path_reaches_the_collect_not_the_reader():
    """A map input whose optimistic fast path failed raises
    FastPathInvalid in its map task, on the query's thread, for the
    collect's deopt retry; it never reaches a reader as a failed fetch,
    and no map output stays registered."""
    import torch
    CK = mod(PORT, "utils.checks")
    M = mod(PORT, "shuffle.manager")
    C = mod(PORT, "config")
    good = kv_batch(PORT, 0, 64)
    bad = kv_batch(PORT, 64, 64)
    CB = mod(PORT, "columnar.batch").ColumnarBatch
    recovered = []
    bad = CB(bad.schema, bad.columns, bad.num_rows, (CK.BatchCheck(
        torch.tensor(True), "testFastPath",
        lambda: recovered.append(1)),))
    c, env, ex = _manager_exchange(None, 2, 2, [[good], [bad]])
    with C.session(c):
        with pytest.raises(CK.FastPathInvalid, match="testFastPath") as ei:
            ex.execute_partitions()
    ei.value.recover_all()
    assert recovered == [1]
    assert M.MapOutputRegistry.live_shuffles() == 0
    assert len(env.catalog) == 0
