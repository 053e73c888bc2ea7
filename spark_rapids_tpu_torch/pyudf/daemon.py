"""Python worker daemon pool (port of spark_rapids_tpu/pyudf/daemon.py;
reference `python/rapids/daemon.py`, the forked pyspark daemon that
spawns memory-initialized workers): a pool of long-lived subprocesses
speaking the Arrow IPC pipe protocol of `pyudf/worker.py`.

Turned on by spark.rapids.python.daemon.enabled: the in-process path
stays the fast local mode, and the pool gives UDFs process isolation (a
UDF that crashes or leaks cannot take the executor down) at one Arrow
round trip of cost, the trade the reference makes by running UDFs in
pyspark workers.  The worker count is capped by
spark.rapids.python.concurrentPythonWorkers.  A worker starts with
CUDA_VISIBLE_DEVICES empty unless spark.rapids.python.onTpu.enabled, so
it holds no CUDA context.  A worker that cannot be spawned fails the
query; a UDF never runs in-process instead.
"""
from __future__ import annotations

import os
import struct
import subprocess
import sys
import threading
from queue import Empty, Queue
from typing import Callable, Optional

import pandas as pd


class WorkerCrash(RuntimeError):
    """A UDF worker process died in the middle of a request."""


class PythonUdfError(RuntimeError):
    """The UDF raised inside a healthy worker; carries the worker's
    traceback (pyspark's PythonException: the original exception type
    does not survive the process boundary there either)."""


class _Worker:
    def __init__(self, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_tpu_torch.pyudf.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def run(self, fn_blob: bytes, df: pd.DataFrame) -> pd.DataFrame:
        from spark_rapids_tpu_torch.pyudf.worker import (_df_to_ipc,
                                                         _ipc_to_df,
                                                         _read_exact)
        ipc = _df_to_ipc(df)
        try:
            stdin = self.proc.stdin
            stdin.write(struct.pack("<I", len(fn_blob)))
            stdin.write(fn_blob)
            stdin.write(struct.pack("<I", len(ipc)))
            stdin.write(ipc)
            stdin.flush()
            status, n = struct.unpack("<BI", _read_exact(self.proc.stdout, 5))
            payload = _read_exact(self.proc.stdout, n)
        except (EOFError, OSError) as e:
            raise WorkerCrash(
                f"python worker died (exit {self.proc.poll()})") from e
        if status != 0:
            raise PythonUdfError("python UDF worker error:\n" +
                                 payload.decode("utf-8", "replace"))
        return _ipc_to_df(payload)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def close(self) -> None:
        try:
            if self.alive():
                self.proc.stdin.write(struct.pack("<I", 0))
                self.proc.stdin.flush()
                self.proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()
        finally:
            for pipe in (self.proc.stdin, self.proc.stdout):
                try:
                    pipe.close()
                except OSError:
                    pass  # a pipe whose reader died is closed already


class PythonWorkerPool:
    """Checkout/checkin pool of `_Worker`s, grown on demand to the cap."""

    _instance: Optional["PythonWorkerPool"] = None
    _lock = threading.Lock()

    def __init__(self, max_workers: int, env_extra: Optional[dict] = None):
        self.max_workers = max(1, max_workers)
        self._idle: "Queue[_Worker]" = Queue()
        self._slots = threading.Semaphore(self.max_workers)
        self._closed = False
        # guards _closed against the idle queue: a checkin racing close()
        # must not park a live worker in an already drained queue
        self._state_lock = threading.Lock()
        self._settings = (max_workers, tuple(sorted(
            (env_extra or {}).items())))
        self._env = dict(os.environ)
        self._env.update(env_extra or {})
        # the worker imports this package whatever its working directory
        import spark_rapids_tpu_torch
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(spark_rapids_tpu_torch.__file__)))
        prev = self._env.get("PYTHONPATH", "")
        self._env["PYTHONPATH"] = (root + os.pathsep + prev) if prev \
            else root
        if self._env.get("RAPIDS_PYTHON_ON_TPU", "false") != "true":
            # the card belongs to the executor: a worker sees none
            self._env["CUDA_VISIBLE_DEVICES"] = ""

    @classmethod
    def get(cls) -> "PythonWorkerPool":
        from spark_rapids_tpu_torch import config as C
        conf = C.get_active_conf()
        n = int(conf[C.PYTHON_CONCURRENT_WORKERS]) or (os.cpu_count() or 4)
        env_extra = _worker_env_from_conf(conf)
        settings = (n, tuple(sorted(env_extra.items())))
        with cls._lock:
            if cls._instance is None or cls._instance._settings != settings:
                # the conf changed since the pool was built (worker cap,
                # memory limit, onTpu): rebuild it with the new settings
                if cls._instance is not None:
                    cls._instance.close()
                cls._instance = cls(n, env_extra)
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
                cls._instance = None

    def _checkout(self) -> _Worker:
        # the slot semaphore bounds live workers; every checkout is
        # paired with a _checkin, which releases the slot
        if self._closed:
            raise RuntimeError("PythonWorkerPool is closed")
        # poll: a checkout parked behind a full pool dies with its
        # cancelled query, and a pool closed meanwhile frees the waiter
        from spark_rapids_tpu_torch.utils import watchdog as W
        while not self._slots.acquire(timeout=0.1):
            W.check_cancelled()
            if self._closed:
                raise RuntimeError("PythonWorkerPool is closed")
        try:
            while True:
                try:
                    w = self._idle.get_nowait()
                except Empty:
                    return _Worker(self._env)
                if w.alive():
                    return w
                w.close()  # reap a dead idle worker, spawn a fresh one
        except BaseException:
            self._slots.release()
            raise

    def _checkin(self, w: _Worker, reusable: bool) -> None:
        try:
            with self._state_lock:
                keep = reusable and w.alive() and not self._closed
                if keep:
                    self._idle.put(w)
            if not keep:
                w.close()
        finally:
            self._slots.release()

    def run_udf(self, fn: Callable, df: pd.DataFrame) -> pd.DataFrame:
        import cloudpickle

        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        # pickle before the checkout: a pickling failure must not touch
        # the pool's state
        fn_blob = cloudpickle.dumps(fn)
        w = self._checkout()
        reusable = False
        try:
            # a worker that never answers is the pyudf hang: the
            # heartbeat names it, the injector fakes it, and a cancelled
            # run closes the worker (not reusable) so the slot comes
            # back clean
            with W.heartbeat(f"pyudf:worker-pid{w.proc.pid}", kind="task"), \
                    P.span(f"pyudf:pid{w.proc.pid}", cat=P.CAT_UDF):
                W.maybe_hang("pyudf")
                out = w.run(fn_blob, df)
            reusable = True
            return out
        except PythonUdfError:
            # the UDF raised inside a healthy worker: keep the process
            reusable = True
            raise
        except WorkerCrash as e:
            P.event(P.EV_UDF_WORKER_CRASH, pid=w.proc.pid,
                    error=str(e)[:200])
            raise
        finally:
            self._checkin(w, reusable)

    def close(self) -> None:
        # checked-out workers are closed by their _checkin (which sees
        # _closed under the same lock); only the idle ones drain here
        with self._state_lock:
            self._closed = True
            drained = []
            while True:
                try:
                    drained.append(self._idle.get_nowait())
                except Empty:
                    break
        for w in drained:
            try:
                w.close()
            except Exception:  # noqa: BLE001
                pass


def _worker_env_from_conf(conf) -> dict:
    """Conf -> worker environment (reference GpuPythonHelper passing the
    memory settings to the daemon)."""
    from spark_rapids_tpu_torch import config as C
    env = {"RAPIDS_PYTHON_ON_TPU": str(bool(conf[C.PYTHON_ON_TPU])).lower()}
    limit = int(conf[C.PYTHON_MEM_LIMIT] or 0)
    if limit:
        env["RAPIDS_PYTHON_MEM_LIMIT_BYTES"] = str(limit)
    return env
