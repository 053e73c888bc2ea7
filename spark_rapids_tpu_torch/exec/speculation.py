"""Speculative map-task execution: duplicate attempts for stragglers
(port of spark_rapids_tpu/exec/speculation.py; Spark's task speculation,
spark.speculation.*).

The engine survives OOM (memory/retry.py), dead peers
(shuffle/recovery.py) and hangs (utils/watchdog.py), but none of those
fire on *slow*: one degraded executor stalls a whole collect.  This is the
tail-latency answer:

* Each manager-lane map task registers a watchdog heartbeat with a
  **slow_check**, the scanner's *slow* classification (distinct from
  *hung*): a task whose runtime exceeds `speculation.multiplier` x the
  stage's completed-task median (once `minCompletedTasks` finished, never
  before `minTaskRuntimeMs`).
* A slow task gets a **duplicate attempt** from the exchange's retained
  lineage on another executor; both run to a **first-wins, epoch-guarded
  commit** (`MapOutputRegistry.register(first_wins=True)`: the loser's
  commit raises `StaleMapStatusError` and its buffers are freed).  Both
  attempts compute the same map output from the same lineage, so results
  stay bit-exact.
* The **loser is cancelled** through its `AttemptToken`: every
  cancellation point under the attempt (batch boundaries, injected slow
  sleeps, backoff waits) wakes at once and the attempt aborts its writer.

A duplicate runs on its own thread, on the query's CUDA device and stream
(captured where the stage starts), with the pipeline off.  Off
(`spark.rapids.sql.speculation.enabled`, the default) the exchange makes
no SpeculationManager at all.
"""
from __future__ import annotations

import logging
import statistics
import threading
import time
from contextlib import nullcontext
from typing import Callable, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.utils import metrics as M

log = logging.getLogger("spark_rapids_tpu_torch.speculation")

# process-lifetime counters
_STATS_LOCK = threading.Lock()
_STATS = {"launched": 0, "wins": 0, "losers_cancelled": 0}


def speculation_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_speculation_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _note(key: str) -> None:
    with _STATS_LOCK:
        _STATS[key] += 1


def _close(it) -> None:
    close = getattr(it, "close", None)
    if close is not None:
        try:
            close()
        except Exception:  # noqa: BLE001 — best effort on a dropped input
            pass


class _Task:
    """Race state of one map task: the inline original attempt and at
    most one speculative duplicate."""

    def __init__(self, map_id: int, t0: float, epoch0: int, mgr):
        self.map_id = map_id
        self.t0 = t0
        self.epoch0 = epoch0
        self.mgr = mgr
        self.lock = threading.Lock()
        self.speculated = False
        self.settled = False
        self.orig_token = None       # AttemptToken of the inline run
        self.spec_token = None       # AttemptToken of the duplicate
        self.spec_thread: Optional[threading.Thread] = None
        self.spec_done = threading.Event()
        self.spec_won = False
        self.spec_error: Optional[BaseException] = None
        self.commit_time: Optional[float] = None

    def try_mark_speculated(self) -> bool:
        with self.lock:
            if self.speculated or self.settled:
                return False
            self.speculated = True
            return True


class SpeculationManager:
    """The speculation driver of one stage (one exchange's map side).

    The exchange supplies three closures:
      * ``write_fn(map_id, batch_iter, mgr, epoch, first_wins)`` splits,
        writes and COMMITS one map task onto `mgr`;
      * ``lineage_fn(map_id)`` is a FRESH batch iterator over the map
        task's input, from the exchange's retained child lineage;
      * ``backup_fn(exclude_mgr)`` is a healthy executor to run the
        duplicate on, or None.
    """

    def __init__(self, shuffle_id: int, conf: C.RapidsConf, metrics,
                 write_fn: Callable, lineage_fn: Callable,
                 backup_fn: Callable):
        from spark_rapids_tpu_torch.exec import pipeline as PL
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.utils import watchdog as W
        self.shuffle_id = shuffle_id
        self.conf = conf
        self.metrics = metrics
        self.write_fn = write_fn
        self.lineage_fn = lineage_fn
        self.backup_fn = backup_fn
        self.multiplier = max(1.0, float(conf[C.SPECULATION_MULTIPLIER]))
        self.min_runtime_s = float(conf[C.SPECULATION_MIN_RUNTIME_MS]) / 1e3
        self.min_completed = max(1, int(conf[C.SPECULATION_MIN_COMPLETED]))
        # a duplicate runs with the pipeline off: a cancelled loser must
        # leave no producer parked on a queue
        self.spec_conf = conf.set(C.PIPELINE_ENABLED.key, False)
        self._lock = threading.Lock()
        self._durations: list[float] = []
        # taken on the driver thread: a duplicate carries the query's
        # context, cancellation and CUDA stream
        self._qc = S.current()
        self._span_ref = P.current_ref()
        self._query_token = W.current_token()
        self._stream = PL._cuda_stream_of_caller()
        self._threads: list[threading.Thread] = []

    # -- the stage's median -------------------------------------------------
    def _note_completion(self, seconds: float) -> None:
        with self._lock:
            self._durations.append(seconds)

    def _median(self) -> Optional[float]:
        with self._lock:
            if len(self._durations) < self.min_completed:
                return None
            return statistics.median(self._durations)

    # -- slow classification (on the watchdog's scanner thread) -------------
    def _slow_check(self, state: _Task) -> Callable:
        def check(hb, now: float) -> None:
            if state.settled or state.speculated:
                return
            med = self._median()
            if med is None:
                return
            elapsed = now - state.t0
            if elapsed < max(self.min_runtime_s, self.multiplier * med):
                return
            if not state.try_mark_speculated():
                return
            backup = self.backup_fn(state.mgr)
            if backup is None:
                return
            t = threading.Thread(
                target=self._run_speculative,
                args=(state, backup, elapsed, med), daemon=True,
                name=f"tpu-speculate-s{self.shuffle_id}m{state.map_id}")
            state.spec_thread = t
            self._threads.append(t)
            t.start()
        return check

    def _stream_scope(self):
        if self._stream is None:
            return nullcontext()
        import torch
        idx, stream = self._stream
        torch.cuda.set_device(idx)
        return torch.cuda.stream(stream)

    # -- the duplicate attempt ----------------------------------------------
    def _run_speculative(self, state: _Task, backup, elapsed: float,
                         median: float) -> None:
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.shuffle.manager import (
            StaleMapStatusError)
        from spark_rapids_tpu_torch.utils import watchdog as W
        stok = W.AttemptToken(parent=self._query_token)
        state.spec_token = stok
        self.metrics.add(M.NUM_SPECULATIVE_TASKS, 1)
        _note("launched")
        with S.scoped(self._qc):
            P.event(P.EV_SPECULATION_LAUNCHED, shuffle_id=self.shuffle_id,
                    map_id=state.map_id, backup=backup.executor_id,
                    elapsed_ms=round(elapsed * 1e3, 1),
                    stage_median_ms=round(median * 1e3, 1))
        try:
            with S.scoped(self._qc), C.session(self.spec_conf), \
                    P.attach(self._span_ref), W.attempt_scope(stok), \
                    self._stream_scope():
                it = self.lineage_fn(state.map_id)
                try:
                    self.write_fn(state.map_id, it, backup, state.epoch0,
                                  True)
                finally:
                    _close(it)
            state.spec_won = True
            state.commit_time = time.monotonic()
            self.metrics.add(M.NUM_SPECULATIVE_WINS, 1)
            _note("wins")
            with S.scoped(self._qc):
                P.event(P.EV_SPECULATION_WIN, shuffle_id=self.shuffle_id,
                        map_id=state.map_id, backup=backup.executor_id)
            if state.orig_token is not None:
                state.orig_token.cancel_race_lost(
                    f"speculation: duplicate attempt on "
                    f"{backup.executor_id} committed first")
        except StaleMapStatusError:
            # the original committed first: this attempt lost at the
            # registry, and its writer freed its buffers
            pass
        except W.TpuQueryTimeout:
            if not stok.race_lost:
                log.debug("speculative attempt for map %d cancelled with "
                          "the query", state.map_id)
        except BaseException as e:  # noqa: BLE001 — the original is the
            state.spec_error = e    # safety net; never fail the stage here
            log.warning("speculative attempt for shuffle %d map %d "
                        "failed (original continues): %s",
                        self.shuffle_id, state.map_id, e)
        finally:
            state.spec_done.set()

    # -- the inline original attempt ----------------------------------------
    def run_task(self, map_id: int, batch_iter, mgr) -> None:
        """One map task with speculation armed: the original attempt runs
        on this thread, and the watchdog may race a duplicate against it.
        Returns once the map output is committed (by either attempt) and
        both attempts are settled."""
        from spark_rapids_tpu_torch.shuffle.manager import (
            MapOutputRegistry, StaleMapStatusError)
        from spark_rapids_tpu_torch.utils import watchdog as W
        t0 = time.monotonic()
        state = _Task(map_id, t0, MapOutputRegistry.epoch(self.shuffle_id),
                      mgr)
        otok = W.AttemptToken(parent=self._query_token)
        state.orig_token = otok
        hb = W.heartbeat(f"map-task:s{self.shuffle_id}m{map_id}",
                         kind="task", conf=self.conf,
                         slow_check=self._slow_check(state))
        orig_error: Optional[BaseException] = None
        won = False
        try:
            try:
                with W.attempt_scope(otok):
                    self.write_fn(map_id, batch_iter, mgr, state.epoch0,
                                  True)
                won = True
                state.commit_time = state.commit_time or time.monotonic()
            except StaleMapStatusError:
                pass  # the duplicate committed first: a clean loss
            except W.TpuQueryTimeout:
                if not otok.race_lost:
                    raise
                # the cancelled loser drops its half-read input
                _note("losers_cancelled")
                _close(batch_iter)
            except BaseException as e:  # noqa: BLE001 — settled below
                orig_error = e
        finally:
            with state.lock:
                state.settled = True
            hb.close()
        if won and state.spec_token is not None:
            state.spec_token.cancel_race_lost(
                "speculation: original attempt committed first")
        if state.spec_thread is not None:
            # prompt: every wait under the attempt is cancellable
            state.spec_done.wait(timeout=60.0)
            state.spec_thread.join(timeout=10.0)
        if not won and not state.spec_won:
            err = orig_error or state.spec_error
            if err is not None:
                raise err
            raise RuntimeError(
                f"map task {self.shuffle_id}/{map_id}: no attempt "
                f"committed and no error was recorded")
        if orig_error is not None:
            log.warning("original attempt for shuffle %d map %d failed "
                        "but its speculative duplicate won: %s",
                        self.shuffle_id, map_id, orig_error)
        self._note_completion((state.commit_time or time.monotonic()) - t0)

    def finish(self) -> None:
        """Join any stray duplicate (run_task settles each; this covers
        error paths)."""
        for t in self._threads:
            t.join(timeout=10.0)


def maybe_create(shuffle_id: int, conf: C.RapidsConf, metrics,
                 write_fn: Callable, lineage_fn: Callable,
                 backup_fn: Callable,
                 num_executors: int) -> Optional[SpeculationManager]:
    """A SpeculationManager when speculation is on, the watchdog's
    scanner runs (it classifies the slow) and there is more than one
    executor to speculate onto; else None (the exchange's plain loop)."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    if not conf[C.SPECULATION_ENABLED] or num_executors < 2:
        return None
    if not W.enabled(conf):
        return None
    return SpeculationManager(shuffle_id, conf, metrics, write_fn,
                              lineage_fn, backup_fn)
