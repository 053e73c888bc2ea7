"""A second OS process fetches map outputs over the TCP lane, its
addresses given by MapStatus, no memory shared: twins of
tests/test_shuffle_two_process.py.  Each child imports
spark_rapids_tpu_torch and torch only (never JAX) and reads on the CPU.

The first case runs once with the JAX package's executor serving (the
child, the port, reads the reference's frames and payloads from another
process) and once with the port's; the others serve from the port: a
compressed fetch (lz4), a fetch of outputs spilled to the host and disk
tiers, two reducer processes at once, the serving process killed mid
fetch, and a server gone before the fetch (a FetchFailedError in the
child, no hang).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_shuffle_manager import PORT, REF, batch, mod, reset_world
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

pytestmark = pytest.mark.slowish

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.memory.env import ResourceEnv
from spark_rapids_tpu_torch.shuffle.client_server import FetchFailedError
from spark_rapids_tpu_torch.shuffle.manager import (MapOutputRegistry,
                                                    MapStatus,
                                                    TpuShuffleManager)

# one reduce request per line of stdin, one RESULT line each, so the
# process pays its imports once for the whole module
for line in sys.stdin:
    spec = json.loads(line)
    conf_map = {"spark.rapids.shuffle.enabled": True,
                "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0}
    if spec.get("codec"):
        conf_map["spark.rapids.shuffle.compression.codec"] = spec["codec"]
    conf = C.RapidsConf(conf_map)
    with C.session(conf):
        env = ResourceEnv.init(conf, device="cpu")
        mgr = TpuShuffleManager("executor-B", env, conf)
        # MapStatus entries arrive over the wire (the MapOutputTracker
        # role); loop:// is unreachable from this process, so the reader
        # falls back to the TCP address
        for m in spec["outputs"]:
            MapOutputRegistry.register(
                spec["shuffle_id"], m["map_id"],
                MapStatus(m["executor_id"], m["address"],
                          m["partition_sizes"],
                          tcp_address=m["tcp_address"]))
        result = {}
        lo, hi = spec.get("partition_range", [0, spec["num_partitions"]])
        try:
            for p in range(lo, hi):
                rows = ksum = 0
                for b in mgr.get_reader(spec["shuffle_id"], p,
                                        timeout=spec.get("timeout", 20.0)):
                    df = b.to_pandas()
                    rows += len(df)
                    ksum += int(df["k"].sum())
                result[str(p)] = {"rows": rows, "ksum": ksum}
        except FetchFailedError:
            if not spec.get("expect_fetch_failed"):
                raise
            result = {"error": "FETCH_FAILED"}
        mgr.close()
        MapOutputRegistry.clear()
    print("RESULT:" + json.dumps(result), flush=True)
"""


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    return env


class _Reader:
    """A reducer process that serves one request per line."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CHILD], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(),
            cwd=ROOT)

    def send(self, spec: dict) -> None:
        self.proc.stdin.write((json.dumps(spec) + "\n").encode())
        self.proc.stdin.flush()

    def result(self) -> dict:
        line = self.proc.stdout.readline().decode()
        if not line.startswith("RESULT:"):
            self.proc.kill()
            raise AssertionError(f"reader failed: {line}\n"
                                 f"{self.proc.stderr.read().decode()[-2000:]}")
        return json.loads(line[len("RESULT:"):])

    def read(self, spec: dict) -> dict:
        self.send(spec)
        return self.result()

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=30)
        finally:
            self.proc.kill()


@pytest.fixture(scope="module")
def readers():
    """Two reducer processes, started at once (each pays torch's import
    once for the module)."""
    rs = [_Reader(), _Reader()]
    yield rs
    for r in rs:
        r.close()


def _serving(pkg: str, conf_map: dict):
    """The serving executor in this process: a conf session, an
    environment and a manager of `pkg`."""
    C = mod(pkg, "config")
    c = C.RapidsConf({"spark.rapids.shuffle.enabled": True, **conf_map})
    C.set_active_conf(c)
    RE = mod(pkg, "memory.env").ResourceEnv
    env = RE.init(c) if pkg == REF else RE.init(c, device="cpu")
    mgr = mod(pkg, "shuffle.manager").TpuShuffleManager("executor-A", env, c)
    return env, mgr


def _write_maps(pkg, mgr, shuffle_id, n_parts, n_maps=2, rng_seed=17):
    """Map outputs of `n_maps` tasks: (MapStatus specs, expected totals)."""
    rng = np.random.default_rng(rng_seed)
    mgr.register_shuffle(shuffle_id)
    expected = {p: {"rows": 0, "ksum": 0} for p in range(n_parts)}
    outputs = []
    for map_id in range(n_maps):
        writer = mgr.get_writer(shuffle_id, map_id)
        for p in range(n_parts):
            k = rng.integers(0, 1000, 40 + 10 * p).astype(np.int64)
            writer.write_partition(p, batch(pkg, {"k": k}))
            expected[p]["rows"] += len(k)
            expected[p]["ksum"] += int(k.sum())
        status = writer.commit(n_parts)
        outputs.append({"map_id": map_id, "executor_id": status.executor_id,
                        "address": status.address,
                        "tcp_address": status.tcp_address,
                        "partition_sizes": status.partition_sizes})
    return outputs, expected


@pytest.fixture(autouse=True)
def clean_world(one_torch_thread):  # noqa: F811
    for p in (REF, PORT):
        reset_world(p)
    yield
    for p in (REF, PORT):
        reset_world(p)


@pytest.mark.parametrize("server", [REF, PORT], ids=["jax_server",
                                                     "torch_server"])
def test_cross_process_fetch_via_tcp(server, readers):
    env, mgr = _serving(server, {})
    outputs, expected = _write_maps(server, mgr, 4242, 3)
    assert all(o["address"].startswith("loop://") for o in outputs)
    assert all(o["tcp_address"].startswith("tcp://") for o in outputs)
    got = readers[0].read({"shuffle_id": 4242, "num_partitions": 3,
                           "outputs": outputs})
    for p in range(3):
        assert got[str(p)] == expected[p], f"partition {p}"
    mgr.unregister_shuffle(4242)
    mgr.close()


def test_cross_process_fetch_compressed(readers):
    """lz4-compressed, CRC-checked payloads over a real wire (the
    reference's TableCompressionCodec path)."""
    env, mgr = _serving(PORT, {
        "spark.rapids.shuffle.compression.codec": "lz4"})
    outputs, expected = _write_maps(PORT, mgr, 4243, 3, rng_seed=19)
    got = readers[0].read({"shuffle_id": 4243, "num_partitions": 3,
                           "outputs": outputs, "codec": "lz4"})
    assert {int(p): v for p, v in got.items()} == expected
    mgr.unregister_shuffle(4243)
    mgr.close()


def test_cross_process_fetch_spilled_tier(readers):
    """The map outputs spilled device -> host (and part -> disk) before
    the fetch: the server reads whatever tier holds them (reference
    RapidsShuffleServer.scala:380)."""
    env, mgr = _serving(PORT, {})
    outputs, expected = _write_maps(PORT, mgr, 4244, 3, rng_seed=23)
    assert env.device_store.synchronous_spill(0) > 0
    env.host_store.synchronous_spill(env.host_store.spillable_size // 2)
    got = readers[0].read({"shuffle_id": 4244, "num_partitions": 3,
                           "outputs": outputs})
    assert {int(p): v for p, v in got.items()} == expected
    mgr.unregister_shuffle(4244)
    mgr.close()


def test_cross_process_two_concurrent_reducers(readers):
    """Two reader PROCESSES fetch different partitions from one server at
    once."""
    env, mgr = _serving(PORT, {})
    outputs, expected = _write_maps(PORT, mgr, 4245, 4, rng_seed=29)
    ranges = ((0, 2), (2, 4))
    for r, rng in zip(readers, ranges):
        r.send({"shuffle_id": 4245, "num_partitions": 4,
                "partition_range": list(rng), "outputs": outputs})
    results = {}
    for r in readers:
        results.update(r.result())
    assert {int(p): v for p, v in results.items()} == expected
    mgr.unregister_shuffle(4245)
    mgr.close()


CHILD_SERVER = r"""
import json, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.env import ResourceEnv
from spark_rapids_tpu_torch.shuffle import ici_transport as ici
from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager

# throttle the data plane, so the parent's fetch is IN FLIGHT when it
# kills this process: every DATA-sized frame pays a short sleep
_send = ici._send_all
def _slow_send(conn, data):
    _send(conn, data)
    if len(data) > 512:
        time.sleep(0.01)
ici._send_all = _slow_send

spec = json.loads(sys.stdin.readline())
conf = C.RapidsConf({"spark.rapids.shuffle.enabled": True,
                     "spark.rapids.shuffle.bounceBuffers.size":
                         spec["bounce"]})
with C.session(conf):
    env = ResourceEnv.init(conf, device="cpu")
    mgr = TpuShuffleManager("executor-S", env, conf)
    mgr.register_shuffle(spec["shuffle_id"])
    rng = np.random.default_rng(5)
    outputs = []
    for map_id, rows in enumerate(spec["map_rows"]):
        w = mgr.get_writer(spec["shuffle_id"], map_id)
        k = rng.integers(0, 1000, rows).astype(np.int64)
        w.write_partition(0, ColumnarBatch.from_numpy({"k": k},
                                                      device="cpu"))
        st = w.commit(1)
        outputs.append({"map_id": map_id, "executor_id": st.executor_id,
                        "tcp_address": st.tcp_address,
                        "partition_sizes": st.partition_sizes})
    print("OUTPUTS:" + json.dumps(outputs), flush=True)
    while True:  # serve until killed
        time.sleep(0.2)
"""


def test_kill_server_process_mid_fetch_fetch_failed():
    """The serving PROCESS is killed while a transfer is in flight: the
    reader drops the partial buffer, spends its bounded retries on the
    dead address and raises FetchFailedError naming it, promptly."""
    proc = subprocess.Popen([sys.executable, "-c", CHILD_SERVER],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=_env(), cwd=ROOT)
    try:
        # map 0 is tiny (once it lands the stream is live); map 1 is ~200
        # throttled chunks (~2 s), so the kill lands mid-transfer
        spec = {"shuffle_id": 4247, "bounce": 4096, "map_rows": [64,
                                                                 100_000]}
        proc.stdin.write((json.dumps(spec) + "\n").encode())
        proc.stdin.flush()
        line = b""
        deadline = time.monotonic() + 120
        while not line.startswith(b"OUTPUTS:"):
            assert time.monotonic() < deadline, "server never came up"
            line = proc.stdout.readline()
            assert line, proc.stderr.read().decode()[-2000:]
        outputs = json.loads(line.decode()[len("OUTPUTS:"):])
        C = mod(PORT, "config")
        M = mod(PORT, "shuffle.manager")
        CS = mod(PORT, "shuffle.client_server")
        c = C.RapidsConf({"spark.rapids.shuffle.enabled": True,
                          "spark.rapids.shuffle.fetch.maxRetries": 1,
                          "spark.rapids.shuffle.fetch.backoff.baseMs": 1.0})
        with C.session(c):
            env = mod(PORT, "memory.env").ResourceEnv.init(c, device="cpu")
            mgr = M.TpuShuffleManager("executor-R", env, c)
            mgr.register_shuffle(4247)
            for o in outputs:
                M.MapOutputRegistry.register(4247, o["map_id"], M.MapStatus(
                    o["executor_id"], o["tcp_address"],
                    o["partition_sizes"]))
            t0 = time.monotonic()
            got_rows = 0
            with pytest.raises(CS.FetchFailedError) as ei:
                for b in mgr.get_reader(4247, 0, timeout=10.0):
                    got_rows += b.num_rows
                    if got_rows <= 64:  # the first (tiny) batch landed
                        proc.kill()     # SIGKILL mid-stream of map 1
            elapsed = time.monotonic() - t0
            assert elapsed < 20.0, f"FetchFailed took {elapsed:.1f}s"
            assert "tcp://" in str(ei.value)
            assert got_rows < 64 + 100_000, "full data despite the kill?"
            mgr.unregister_shuffle(4247)
            mgr.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_cross_process_dead_server_fetch_failed(readers):
    """Fetching from a server that has gone away is a FetchFailed (the
    stage-retry signal), not a hang."""
    env, mgr = _serving(PORT, {})
    outputs, _ = _write_maps(PORT, mgr, 4246, 2, rng_seed=31)
    mgr.close()  # the serving executor goes BEFORE the fetch
    got = readers[1].read({"shuffle_id": 4246, "num_partitions": 2,
                           "outputs": outputs, "expect_fetch_failed": True,
                           "timeout": 6.0})
    assert got == {"error": "FETCH_FAILED"}
