"""PythonWorkerSemaphore (port of spark_rapids_tpu/pyudf/semaphore.py;
reference `python/PythonWorkerSemaphore.scala:17-40`): caps concurrent
Python UDF evaluations per executor under
spark.rapids.python.concurrentPythonWorkers (0 = unlimited)."""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional


class PythonWorkerSemaphore:
    _instance: Optional["PythonWorkerSemaphore"] = None
    _lock = threading.Lock()

    def __init__(self, max_workers: int):
        self.max_workers = max_workers
        self._sem = (threading.Semaphore(max_workers)
                     if max_workers > 0 else None)
        self.active = 0
        self._alock = threading.Lock()
        # per-thread hold depth: stacked Python UDF operators on one task
        # thread share one worker slot instead of deadlocking on it
        self._tls = threading.local()

    @classmethod
    def initialize(cls, max_workers: int) -> "PythonWorkerSemaphore":
        with cls._lock:
            cls._instance = cls(max_workers)
            return cls._instance

    @classmethod
    def get(cls) -> "PythonWorkerSemaphore":
        with cls._lock:
            if cls._instance is None:
                from spark_rapids_tpu_torch import config as C
                cls._instance = cls(
                    C.get_active_conf()[C.PYTHON_CONCURRENT_WORKERS])
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            cls._instance = None

    @contextmanager
    def held(self):
        depth = getattr(self._tls, "depth", 0)
        outermost = depth == 0
        if outermost and self._sem is not None:
            # acquire before raising the depth, so a failed acquire does
            # not leave this thread marked as holding; poll, so a task
            # parked behind the cap dies with its cancelled query
            from spark_rapids_tpu_torch.utils import watchdog as W
            while not self._sem.acquire(timeout=0.1):
                W.check_cancelled()
        self._tls.depth = depth + 1
        if outermost:
            with self._alock:
                self.active += 1
        try:
            yield
        finally:
            self._tls.depth -= 1
            if outermost:
                with self._alock:
                    self.active -= 1
                if self._sem is not None:
                    self._sem.release()
