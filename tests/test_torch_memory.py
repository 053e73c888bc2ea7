"""spark_rapids_tpu_torch's memory layer against spark_rapids_tpu's, one
twin per test of tests/test_memory.py: the native runtime and its Python
twins, serde (with interop in both directions), the catalog and the
device->host->disk spill chain, the semaphore, the DeviceManager's budget
arithmetic, and CRC-framed spill files.  Each twin drives the same
seeded inputs through both packages and holds the port to the
reference's answer: allocator offsets, queue orders, frames, spill tiers
and budgets exact; spill files byte for byte.
"""
import struct
import threading
import time
import zlib

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.columnar import serde as RS
from spark_rapids_tpu.memory import BufferId as RBufferId
from spark_rapids_tpu.memory import DeviceManager as RDeviceManager
from spark_rapids_tpu.memory import ResourceEnv as RResourceEnv
from spark_rapids_tpu.memory import native as RNT
from spark_rapids_tpu.memory.semaphore import TaskContext as RTaskContext
from spark_rapids_tpu.memory.semaphore import TpuSemaphore as RTpuSemaphore
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import serde as S
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory import (BufferId, DegenerateBuffer,
                                           DeviceManager, ResourceEnv,
                                           TaskContext, TpuSemaphore,
                                           degenerate_meta)
from spark_rapids_tpu_torch.memory import native as NT


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.random(n),
        "s": np.array([f"row{i}" if i % 3 else None for i in range(n)],
                      dtype=object),
    }


def port_batch(n=10, seed=0):
    return ColumnarBatch.from_numpy(_data(n, seed), device="cpu")


def ref_batch(n=10, seed=0):
    return RBatch.from_numpy(_data(n, seed))


def rows(df: pd.DataFrame) -> list:
    """Rows as tuples, every null flavor as None (exact compare)."""
    return [tuple(None if v is None or (isinstance(v, float) and v != v)
                  or v is pd.NA else v for v in r)
            for r in df.astype(object).itertuples(index=False)]


# ---------------------------------------------------------------------------
def _asa_ops(seed, size=1000, steps=60):
    rng = np.random.default_rng(seed)
    return [("alloc", int(rng.integers(1, 200))) if rng.random() < 0.6
            else ("free", int(rng.integers(0, 8))) for _ in range(steps)]


def _run_asa(mod, ops, size=1000):
    a = mod.AddressSpaceAllocator(size)
    live, out = [], []
    for op, v in ops:
        if op == "alloc":
            off = a.allocate(v)
            out.append(off)
            if off is not None:
                live.append(off)
        elif live:
            out.append(a.free(live.pop(v % len(live))))
    out.append(a.allocated)
    return out


def _run_hpq(mod, seed, steps=80):
    rng = np.random.default_rng(seed)
    q = mod.HashedPriorityQueue()
    out = []
    for _ in range(steps):
        r, i = rng.random(), int(rng.integers(0, 12))
        if r < 0.45:
            q.offer(i, float(rng.integers(0, 6)))
        elif r < 0.6:
            q.update_priority(i, float(rng.integers(0, 6)))
        elif r < 0.75:
            out.append(("remove", q.remove(i)))
        elif r < 0.85:
            out.append(("peek", q.peek()))
        else:
            out.append(("poll", q.poll()))
        out.append(("len", len(q), i in q))
    return out


class TestNative:
    def test_native_lib_loads(self):
        assert NT.load_native() is not None, NT.build_error
        assert NT.implementation() == "native"

    def test_asa_alloc_free_coalesce(self):
        a = NT.AddressSpaceAllocator(1000)
        offs = [a.allocate(100) for _ in range(10)]
        assert offs == [i * 100 for i in range(10)]
        assert a.allocate(1) is None
        a.free(offs[3])
        a.free(offs[4])
        assert a.allocate(200) == 300
        assert a.allocated == 1000
        for seed in range(3):
            ops = _asa_ops(seed)
            assert _run_asa(NT, ops) == _run_asa(RNT, ops), seed

    def test_asa_free_unknown(self):
        for mod in (NT, RNT):
            assert mod.AddressSpaceAllocator(100).free(7) is None

    def test_hpq_order_and_update(self):
        q = NT.HashedPriorityQueue()
        q.offer(1, 5.0)
        q.offer(2, 1.0)
        q.offer(3, 3.0)
        assert len(q) == 3 and 2 in q and 9 not in q
        q.update_priority(2, 10.0)
        assert q.poll() == 3
        assert q.remove(1)
        assert q.poll() == 2
        assert q.poll() is None
        for seed in range(3):
            assert _run_hpq(NT, seed) == _run_hpq(RNT, seed), seed

    def test_python_fallbacks_match(self, monkeypatch):
        """The Python twins give the native runtime's answers on the
        same seeded op sequences (and the reference's twins')."""
        native = [(_run_asa(NT, _asa_ops(s)), _run_hpq(NT, s))
                  for s in range(3)]
        monkeypatch.setattr(NT, "_lib", None)
        monkeypatch.setattr(NT, "load_native", lambda: None)
        monkeypatch.setattr(RNT, "_lib", None)
        monkeypatch.setattr(RNT, "load_native", lambda: None)
        assert NT.implementation() == "python"
        for s in range(3):
            py = (_run_asa(NT, _asa_ops(s)), _run_hpq(NT, s))
            ref_py = (_run_asa(RNT, _asa_ops(s)), _run_hpq(RNT, s))
            assert py == native[s] == ref_py, s


# ---------------------------------------------------------------------------
def _split_blob(blob: bytes):
    hlen = int.from_bytes(blob[4:8], "little")
    return S.peek_meta(blob), blob[8 + hlen:]


def _ref_meta(meta: dict) -> dict:
    """The header without the port's own keys."""
    return {"num_rows": meta["num_rows"],
            "fields": [{k: v for k, v in f.items()
                        if k not in ("narrow", "nullable")}
                       for f in meta["fields"]]}


class TestSerde:
    def test_roundtrip(self):
        b = port_batch(17)
        out = S.deserialize_batch(S.serialize_batch(b), "cpu")
        assert out.num_rows == 17
        want = RS.deserialize_batch(RS.serialize_batch(ref_batch(17)))
        assert rows(out.to_pandas()) == rows(b.to_pandas()) \
            == rows(want.to_pandas())
        # shadows rebuilt from the data: the same bits as before
        for c0, c1 in zip(b.columns, out.columns):
            assert (c0.narrow is None) == (c1.narrow is None)
            if c0.narrow is not None:
                assert np.array_equal(c0.narrow[:17].numpy(),
                                      c1.narrow[:17].numpy())

    def test_peek_meta(self):
        meta = S.peek_meta(S.serialize_batch(port_batch(5)))
        assert meta["num_rows"] == 5
        assert [f["name"] for f in meta["fields"]] == ["a", "b", "s"]
        want = RS.peek_meta(RS.serialize_batch(ref_batch(5)))
        assert _ref_meta(meta) == want

    def test_empty_batch(self):
        b = ColumnarBatch.from_numpy({"x": np.zeros(0, np.int64)},
                                     device="cpu")
        blob = S.serialize_batch(b)
        assert S.deserialize_batch(blob, "cpu").num_rows == 0
        rb = RBatch.from_numpy({"x": np.zeros(0, np.int64)})
        assert _split_blob(blob)[1] == _split_blob(
            RS.serialize_batch(rb))[1]

    def test_padding_not_serialized(self):
        small = port_batch(3)
        big = port_batch(3).with_capacity(1024)
        assert S.serialize_batch(small) == S.serialize_batch(big)
        assert _split_blob(S.serialize_batch(big))[1] == _split_blob(
            RS.serialize_batch(ref_batch(3).with_capacity(1024)))[1]


def _interop_data(seed=4, n=300):
    """Every fixed-width type, strings (empty, long, None) and nulls."""
    rng = np.random.default_rng(seed)
    words = ["", "a", "naïve", "x" * 40, "tpc-h", "été"]
    null = rng.random(n) < 0.2
    data = {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i16": rng.integers(-3000, 3000, n).astype(np.int16),
        "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n).astype(np.int64),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n) * 1e6,
        "bool": rng.random(n) < 0.5,
        "s": np.array([None if null[i] else words[i % len(words)]
                       for i in range(n)], dtype=object),
    }
    validity = {k: ~(rng.random(n) < 0.15) for k in data if k != "s"}
    return data, validity


def test_serde_interop_reference_to_port():
    """A batch serialized by the JAX package deserializes in the port to
    the same frame, nulls and strings included."""
    data, validity = _interop_data()
    rb = RBatch.from_numpy(data, validity=validity)
    blob = RS.serialize_batch(rb)
    out = S.deserialize_batch(blob, "cpu")
    assert rows(out.to_pandas()) == rows(rb.to_pandas())
    assert [f.name for f in out.schema.fields] == list(data)
    # no shadow flag in a reference blob: none is made, as the
    # reference's own reader makes none
    assert all(c.narrow is None for c in out.columns)


def test_serde_interop_port_to_reference():
    """A batch serialized by the port deserializes in the JAX package to
    the same frame, and its payload is the reference's byte for byte."""
    data, validity = _interop_data(seed=5)
    pb = ColumnarBatch.from_numpy(data, validity=validity, device="cpu")
    blob = S.serialize_batch(pb)
    out = RS.deserialize_batch(blob)
    assert rows(out.to_pandas()) == rows(pb.to_pandas())
    rblob = RS.serialize_batch(RBatch.from_numpy(data, validity=validity))
    meta, payload = _split_blob(blob)
    rmeta, rpayload = _split_blob(rblob)
    assert payload == rpayload
    assert _ref_meta(meta) == rmeta


# ---------------------------------------------------------------------------
@pytest.fixture
def envs(tmp_path):
    """The same environment in both packages: 1 MiB host store, two
    concurrent tasks, a 1 GiB device total."""
    keys = {"spark.rapids.memory.host.spillStorageSize": 1 << 20,
            "spark.rapids.sql.concurrentGpuTasks": 2}
    C.set_active_conf(C.RapidsConf(keys))
    RC.set_active_conf(RC.RapidsConf(keys))
    port = ResourceEnv.init(hbm_total=1 << 30,
                            spill_dir=str(tmp_path / "port"), device="cpu")
    ref = RResourceEnv.init(hbm_total=1 << 30,
                            spill_dir=str(tmp_path / "ref"))
    yield port, ref
    ResourceEnv.shutdown()
    RResourceEnv.shutdown()
    C.set_active_conf(C.RapidsConf())
    RC.set_active_conf(RC.RapidsConf())


def _add(env, bid_cls, batch, prio=0.0):
    bid = bid_cls(env.catalog.next_table_id())
    env.device_store.add_batch(bid, batch, spill_priority=prio)
    return bid


class TestStores:
    def test_catalog_acquire_release(self, envs):
        for env, bid_cls, mk in ((envs[0], BufferId, port_batch),
                                 (envs[1], RBufferId, ref_batch)):
            bid = _add(env, bid_cls, mk(8))
            with env.catalog.acquired(bid) as buf:
                assert buf.refcount == 1
                assert buf.get_columnar_batch().num_rows == 8
            assert env.catalog.acquire_buffer(bid).refcount == 1

    def test_spill_device_to_host(self, envs):
        got = {}
        for env, bid_cls, mk, name in (
                (envs[0], BufferId, port_batch, "port"),
                (envs[1], RBufferId, ref_batch, "ref")):
            bids = [_add(env, bid_cls, mk(8, seed=i), i) for i in range(4)]
            assert env.device_store.synchronous_spill(0) > 0
            assert env.device_store.current_size == 0
            out = []
            for bid in bids:
                with env.catalog.acquired(bid) as buf:
                    out.append((buf.tier.name,
                                rows(buf.get_columnar_batch().to_pandas())))
            got[name] = out
        assert got["port"] == got["ref"]
        assert {t for t, _ in got["port"]} == {"HOST"}

    def test_pinned_buffer_does_not_spill(self, envs):
        for env, bid_cls, mk in ((envs[0], BufferId, port_batch),
                                 (envs[1], RBufferId, ref_batch)):
            bid = _add(env, bid_cls, mk(8))
            buf = env.catalog.acquire_buffer(bid)
            assert env.device_store.synchronous_spill(0) == 0
            env.catalog.release_buffer(buf)
            assert env.device_store.synchronous_spill(0) > 0

    def test_spill_chain_to_disk(self, envs):
        got = {}
        for env, bid_cls, mk, name in (
                (envs[0], BufferId, port_batch, "port"),
                (envs[1], RBufferId, ref_batch, "ref")):
            # a host pool too small for the blob: it falls through to disk
            env.host_store.arena.allocator = type(
                env.host_store.arena.allocator)(64)
            env.host_store.arena.size = 64
            bid = _add(env, bid_cls, mk(32))
            env.device_store.synchronous_spill(0)
            with env.catalog.acquired(bid) as buf:
                got[name] = (buf.tier.name,
                             rows(buf.get_columnar_batch().to_pandas()))
        assert got["port"] == got["ref"]
        assert got["port"][0] == "DISK"

    def test_spill_priority_order(self, envs):
        got = {}
        for env, bid_cls, mk, name in (
                (envs[0], BufferId, port_batch, "port"),
                (envs[1], RBufferId, ref_batch, "ref")):
            spilled = []
            orig = env.host_store.copy_buffer

            def spy(buf, orig=orig, spilled=spilled):
                spilled.append(buf.id.table_id)
                return orig(buf)
            env.host_store.copy_buffer = spy
            for i, prio in enumerate([5.0, 1.0, 3.0, 1.0, 0.5]):
                _add(env, bid_cls, mk(8, seed=i), prio)
            env.device_store.synchronous_spill(0)
            got[name] = spilled
        assert got["port"] == got["ref"] == [4, 1, 3, 2, 0]

    def test_alloc_pressure_spills(self, envs):
        for env, bid_cls, mk in ((envs[0], BufferId, port_batch),
                                 (envs[1], RBufferId, ref_batch)):
            _add(env, bid_cls, mk(8))
            dm = env.device_manager
            assert dm.reserve(dm.budget) is True
            assert env.spill_callback.spill_count >= 1
            assert env.device_store.current_size == 0
            dm.release_reservation(dm.budget)
            assert dm.reserved_bytes == 0
        assert envs[0].device_manager.budget == envs[1].device_manager.budget

    def test_degenerate_buffer(self, envs):
        schema = T.Schema.of(("x", T.INT64))
        bid = BufferId(envs[0].catalog.next_table_id())
        buf = DegenerateBuffer(bid, degenerate_meta(schema, 100), "cpu")
        envs[0].catalog.register(buf)
        got = envs[0].catalog.acquire_buffer(bid)
        assert got.get_columnar_batch().num_rows == 100
        assert not got.is_spillable
        assert got.get_host_bytes() == b""


# ---------------------------------------------------------------------------
class TestSemaphore:
    def test_refcounted_reacquire(self):
        for sem_cls, ctx_cls in ((TpuSemaphore, TaskContext),
                                 (RTpuSemaphore, RTaskContext)):
            sem = sem_cls(1)
            with ctx_cls(1) as ctx:
                sem.acquire_if_necessary(ctx)
                sem.acquire_if_necessary(ctx)  # nested: no deadlock
                assert sem.holders() == 1
                sem.release_if_necessary(ctx)
                assert sem.holders() == 1
                sem.release_if_necessary(ctx)
                assert sem.holders() == 0

    def test_limits_concurrency(self):
        got = []
        for sem_cls, ctx_cls in ((TpuSemaphore, TaskContext),
                                 (RTpuSemaphore, RTaskContext)):
            sem = sem_cls(1)
            order = []

            def task(tid, hold, sem=sem, order=order, ctx_cls=ctx_cls):
                with ctx_cls(tid) as ctx:
                    sem.acquire_if_necessary(ctx)
                    order.append(("in", tid))
                    time.sleep(hold)
                    order.append(("out", tid))
                    sem.release_if_necessary(ctx)

            t1 = threading.Thread(target=task, args=(1, 0.15))
            t2 = threading.Thread(target=task, args=(2, 0.0))
            t1.start()
            time.sleep(0.05)
            t2.start()
            t1.join(10)
            t2.join(10)
            assert not t1.is_alive() and not t2.is_alive()
            got.append(order)
        assert got[0] == got[1] == [("in", 1), ("out", 1), ("in", 2),
                                    ("out", 2)]

    def test_task_completion_releases(self):
        sem = TpuSemaphore(1)
        ctx = TaskContext(7)
        TaskContext.set_current(ctx)
        sem.acquire_if_necessary(ctx)
        ctx.complete()  # task ends without explicit release
        assert sem.holders() == 0
        assert TaskContext.get() is None
        with TaskContext(8) as c2:
            sem.acquire_if_necessary(c2)
            assert sem.holders() == 1
            sem.release_if_necessary(c2)
        assert sem.available_permits() == 1


class TestDeviceManager:
    @pytest.mark.parametrize("frac,reserve,total,cap", [
        (0.5, 100, 1000, 0), (0.9, 1 << 30, 80 << 30, 0),
        (1.0, 0, 1 << 16, 0), (0.9, 1 << 30, 80 << 30, 5 << 30),
        (0.3, 500, 1000, 0)])
    def test_budget_arithmetic(self, frac, reserve, total, cap):
        """The same conf and total give the reference's budget."""
        keys = {"spark.rapids.memory.gpu.allocFraction": frac,
                "spark.rapids.memory.gpu.reserve": reserve,
                "spark.rapids.memory.hbmBudgetBytes": cap}
        DeviceManager.shutdown()
        RDeviceManager.shutdown()
        dm = DeviceManager(C.RapidsConf(keys), hbm_total=total,
                           device="cpu")
        rdm = RDeviceManager(RC.RapidsConf(keys), hbm_total=total)
        assert dm.budget == rdm.budget
        if (frac, reserve, total) == (0.5, 100, 1000):
            assert dm.budget == 400
        assert dm.telemetry_gauges() == rdm.telemetry_gauges()
        # the store-byte underflow clamps at zero and is counted
        dm.track_store_bytes(10)
        dm.track_store_bytes(-25, site="t")
        assert dm.store_bytes == 0 and dm.store_bytes_underflows() == 1
        DeviceManager.shutdown()
        RDeviceManager.shutdown()


# -- native spill framing ----------------------------------------------------
def test_native_spill_roundtrip_and_corruption(tmp_path):
    blob = bytes(range(256)) * 100
    p = str(tmp_path / "buf.bin")
    NT.spill_write(p, blob)
    assert NT.spill_read(p) == blob
    # the reference reads the port's file
    assert RNT.spill_read(p) == blob
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(NT.SpillCorruptionError, match="checksum"):
        NT.spill_read(p)
    open(p, "wb").write(bytes(raw[:30]))
    with pytest.raises(NT.SpillCorruptionError):
        NT.spill_read(p)
    open(p, "wb").write(b"NOPE" + bytes(raw[4:]))
    with pytest.raises(NT.SpillCorruptionError, match="magic"):
        NT.spill_read(p)
    bad = bytearray(raw)
    bad[0:4] = b"TPUS"
    bad[8:16] = struct.pack("<Q", 2 ** 60)
    open(p, "wb").write(bytes(bad))
    with pytest.raises(NT.SpillCorruptionError, match="size"):
        NT.spill_read(p)


def test_native_python_spill_formats_interoperate(tmp_path):
    """The port's native writer, the Python twin's format and the
    reference's writer give the same file, byte for byte."""
    assert NT.load_native() is not None, NT.build_error
    blob = b"interop" * 1000
    p1, p2, p3 = (str(tmp_path / f) for f in ("n.bin", "py.bin", "r.bin"))
    NT.spill_write(p1, blob)
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    with open(p2, "wb") as f:
        f.write(b"TPUS" + struct.pack("<IQI", 1, len(blob), crc) + blob)
    RNT.spill_write(p3, blob)
    assert open(p1, "rb").read() == open(p2, "rb").read() \
        == open(p3, "rb").read()
    assert NT.spill_read(p2) == blob


def test_disk_store_detects_corruption(tmp_path):
    """A corrupted spill file raises on read-back in the port as in the
    reference, instead of deserializing garbage."""
    from spark_rapids_tpu.memory.buffer import BufferId as RB
    from spark_rapids_tpu.memory.buffer import TableMeta as RTableMeta
    from spark_rapids_tpu.memory.stores import DiskBlockManager as RDBM
    from spark_rapids_tpu.memory.stores import DiskStore as RDiskStore
    from spark_rapids_tpu_torch.memory.buffer import TableMeta
    from spark_rapids_tpu_torch.memory.stores import (DiskBlockManager,
                                                      DiskStore)
    blob = b"payload" * 500
    for store, bid, meta in (
            (DiskStore(DiskBlockManager(str(tmp_path / "p")),
                       device="cpu"), BufferId(1, 0, 0, 0),
             TableMeta(T.Schema.of(("x", T.INT64)), 10, len(blob))),
            (RDiskStore(RDBM(str(tmp_path / "r"))), RB(1, 0, 0, 0),
             RTableMeta(RT.Schema.of(("x", RT.INT64)), 10, len(blob)))):
        buf = store.add_blob(bid, blob, meta)
        assert buf.get_host_bytes() == blob
        path = store.block_manager.path_for(bid)
        raw = bytearray(open(path, "rb").read())
        raw[25] ^= 0x55
        open(path, "wb").write(bytes(raw))
        with pytest.raises(IOError, match="checksum"):
            buf.get_host_bytes()
        store.close()
