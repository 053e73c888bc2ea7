"""Query watchdog: hang detection, deadlines, cooperative cancellation
(port of spark_rapids_tpu/utils/watchdog.py).

A standalone engine has none of Spark's task-level liveness machinery,
so a wedged producer thread, a stalled merge pass or a pathological
kernel build would hang a query forever: the one failure the OOM retry
harness (memory/retry.py) cannot reach, since it only acts on *raised*
errors.

Three pieces:

* **Heartbeat**: every long-lived activity (prefetch producer loops,
  AQE stage fills, out-of-core merge passes, admission-queue waits, the
  nvcc builds of ops/cuda_build.py) registers a handle with a progress
  counter and a deadline class (`spark.rapids.sql.watchdog.taskTimeout`
  / `.collectiveTimeout` / `.compileTimeout`).  `beat()` on every unit
  of progress; `pause()` around waits attributable to another watched
  party (a producer parked on a full queue is the consumer's problem,
  not a hang).
* **Scanner**: a daemon thread polls the registered heartbeats every
  `watchdog.pollInterval` seconds.  No progress past the deadline emits
  ONE diagnostic dump (all thread stacks, semaphore holders, scheduler
  and prefetch state, device memory, hang-injection state) and fires the
  query's CancelToken.
* **CancelToken**: per-query cooperative cancellation, owned by the
  query's QueryContext (exec/scheduler.py) and threaded through
  TaskContext to producer threads.  Every indefinite wait in the engine
  is a bounded poll plus a token check (`check_cancelled`), so a
  cancelled query ends in a descriptive `TpuQueryTimeout` carrying the
  dump, releases its resources and leaves the process healthy.

A seeded hang injector (`spark.rapids.memory.faultInjection.hangSite`
/ `.hangAfterBatches`) blocks the named site until the token fires, so
the whole detect -> dump -> cancel -> release lattice runs on the CPU.
The reference's "compile" site is its XLA compile; here it is the first
nvcc build of a kernel source.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from contextlib import contextmanager, nullcontext
from typing import Callable, Optional

from spark_rapids_tpu_torch import config as C

log = logging.getLogger("spark_rapids_tpu_torch.watchdog")

#: deadline class -> conf entry
_DEADLINE_ENTRIES = {
    "task": C.WATCHDOG_TASK_TIMEOUT,
    "collective": C.WATCHDOG_COLLECTIVE_TIMEOUT,
    "compile": C.WATCHDOG_COMPILE_TIMEOUT,
}

#: harness-level defaults (configure_global); an EXPLICIT session-conf
#: setting wins
_GLOBAL_DEFAULTS: dict = {}

#: granularity of cancellable waits; latency only paid on cancel edges
_POLL_S = 0.05

#: hard cap on an injected hang with no watchdog to cancel it: a
#: misconfigured test must fail loudly, never eat the wall clock
_HANG_HARD_CAP_S = 120.0


class TpuQueryTimeout(RuntimeError):
    """The watchdog declared the query hung and cancelled it.  Carries
    the diagnostic dump taken at detection time (`.dump`)."""

    def __init__(self, message: str, dump: Optional[str] = None):
        self.dump = dump
        super().__init__(message if not dump else f"{message}\n{dump}")


class CancelToken:
    """Per-query cooperative cancellation.  `cancel()` is one-shot;
    every bounded poll in the engine calls `check()`, which raises
    `TpuQueryTimeout` once the token has fired."""

    def __init__(self):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self.reason: Optional[str] = None
        self.dump: Optional[str] = None

    @property
    def cancelled(self) -> bool:
        return self._ev.is_set()

    def cancel(self, reason: str, dump: Optional[str] = None) -> None:
        with self._lock:
            if self._ev.is_set():
                return
            self.reason = reason
            self.dump = dump
            self._ev.set()
        from spark_rapids_tpu_torch.utils import profile as P
        P.event(P.EV_CANCEL, reason=reason)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def check(self) -> None:
        if self._ev.is_set():
            raise TpuQueryTimeout(
                f"query cancelled by watchdog: {self.reason}",
                dump=self.dump)


class AttemptToken(CancelToken):
    """Per-attempt cancellation for racing duplicate work: linked to a
    parent (the query's token), so a check honors both.  `race_lost`
    marks a cancellation that means "a faster attempt won"."""

    def __init__(self, parent: Optional[CancelToken] = None):
        super().__init__()
        self.parent = parent
        self.race_lost = False

    @property
    def cancelled(self) -> bool:
        return self._ev.is_set() or (
            self.parent is not None and self.parent.cancelled)

    def cancel_race_lost(self, reason: str) -> None:
        """Cancel because the sibling attempt finished first; the flag
        is set before the event so a woken waiter always sees it."""
        self.race_lost = True
        self.cancel(reason)

    def check(self) -> None:
        if self.parent is not None:
            self.parent.check()
        if self._ev.is_set():
            raise TpuQueryTimeout(f"attempt cancelled: {self.reason}",
                                  dump=self.dump)

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self.parent is None:
            return self._ev.wait(timeout)
        # poll both events in bounded slices so a parent cancellation
        # wakes an attempt parked on its own (unfired) token
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._ev.is_set() or self.parent.cancelled:
                return True
            if deadline is None:
                slice_s = _POLL_S
            else:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                slice_s = min(left, _POLL_S)
            self._ev.wait(slice_s)


#: thread-local attempt-token stack: an attempt runner installs its
#: AttemptToken here so every cancellation point under it honors it
_ATTEMPT_TLS = threading.local()


@contextmanager
def attempt_scope(token: CancelToken):
    """Install `token` as this thread's innermost cancellation token for
    the duration."""
    prev = getattr(_ATTEMPT_TLS, "tok", None)
    _ATTEMPT_TLS.tok = token
    try:
        yield token
    finally:
        _ATTEMPT_TLS.tok = prev


# ---------------------------------------------------------------------------
# token management: every query owns its token on its QueryContext; the
# process-global token is the fallback for threads with no query at all
_TOKEN_LOCK = threading.Lock()
_TOKEN = CancelToken()


def _current_query_ctx():
    from spark_rapids_tpu_torch.exec import scheduler as S
    return S.current()


def current_token() -> CancelToken:
    tok = getattr(_ATTEMPT_TLS, "tok", None)
    if tok is not None:
        return tok
    from spark_rapids_tpu_torch.memory.semaphore import TaskContext
    ctx = TaskContext.get()
    tok = getattr(ctx, "cancel_token", None) if ctx is not None else None
    if tok is not None:
        return tok
    qc = _current_query_ctx()
    if qc is not None:
        return qc.token
    with _TOKEN_LOCK:
        return _TOKEN


def begin_query() -> CancelToken:
    """Reset the process-global FALLBACK token and stats (query-less
    paths and tests; queries proper each carry their own token).
    Returns the fresh token."""
    global _TOKEN
    with _TOKEN_LOCK:
        _TOKEN = CancelToken()
        tok = _TOKEN
    with _STATS_LOCK:
        for k in _QUERY_STATS:
            _QUERY_STATS[k] = 0
    return tok


def check_cancelled() -> None:
    """Raise TpuQueryTimeout if the current query has been cancelled."""
    current_token().check()


def cancellable_sleep(seconds: float) -> None:
    """Bounded-poll sleep that raises TpuQueryTimeout the moment the
    query's token fires."""
    tok = current_token()
    deadline = time.monotonic() + seconds
    while True:
        tok.check()
        left = deadline - time.monotonic()
        if left <= 0:
            return
        if tok.wait(min(left, _POLL_S)):
            tok.check()


def cancellable_wait(ev: threading.Event, timeout: float) -> bool:
    """Wait on `ev` up to `timeout` seconds in bounded slices, raising
    TpuQueryTimeout if the query is cancelled meanwhile.  Returns
    whether the event was set."""
    deadline = time.monotonic() + timeout
    while True:
        check_cancelled()
        left = deadline - time.monotonic()
        if left <= 0:
            return ev.is_set()
        if ev.wait(min(left, max(_POLL_S, timeout / 100.0))):
            return True


# ---------------------------------------------------------------------------
# per-query stats
_STATS_LOCK = threading.Lock()
_QUERY_STATS = {"timeouts": 0, "cancels": 0, "dumps": 0,
                "slowest_heartbeat_ms": 0}
#: process-lifetime counters (the telemetry gauges)
_TOTAL_STATS = {"timeouts": 0, "cancels": 0, "dumps": 0}


def watchdog_stats() -> dict:
    """Process-lifetime counters: timeouts declared, tokens cancelled,
    dumps taken."""
    with _STATS_LOCK:
        return dict(_TOTAL_STATS)


def query_stats() -> dict:
    """Watchdog counters of the CURRENT query (its QueryContext's), or
    the process-global fallback's when no query is installed."""
    qc = _current_query_ctx()
    with _STATS_LOCK:
        return dict(qc.stats if qc is not None else _QUERY_STATS)


def _note_gap(ms: float, qc=None) -> None:
    stats = qc.stats if qc is not None else _QUERY_STATS
    with _STATS_LOCK:
        if ms > stats["slowest_heartbeat_ms"]:
            stats["slowest_heartbeat_ms"] = int(ms)


def _note_fire(dumped: bool, qc=None) -> None:
    per_query = qc.stats if qc is not None else _QUERY_STATS
    with _STATS_LOCK:
        for stats in (per_query, _TOTAL_STATS):
            stats["timeouts"] += 1
            stats["cancels"] += 1
            if dumped:
                stats["dumps"] += 1


# ---------------------------------------------------------------------------
def deadline_for(kind: str, conf: Optional[C.RapidsConf] = None) -> float:
    """A deadline class in seconds: an explicit session-conf setting
    wins, then the harness default (configure_global), then the
    registry default."""
    entry = _DEADLINE_ENTRIES[kind]
    conf = conf if conf is not None else C.get_active_conf()
    if conf.is_set(entry.key):
        return float(conf[entry])
    if kind in _GLOBAL_DEFAULTS:
        return float(_GLOBAL_DEFAULTS[kind])
    return float(conf[entry])


def configure_global(task_timeout: Optional[float] = None,
                     collective_timeout: Optional[float] = None,
                     compile_timeout: Optional[float] = None,
                     poll_interval: Optional[float] = None) -> None:
    """Install harness-level default deadlines (None clears one).
    Explicit per-session conf settings still win."""
    for k, v in (("task", task_timeout),
                 ("collective", collective_timeout),
                 ("compile", compile_timeout),
                 ("poll", poll_interval)):
        if v is None:
            _GLOBAL_DEFAULTS.pop(k, None)
        else:
            _GLOBAL_DEFAULTS[k] = float(v)


def _poll_for(conf: Optional[C.RapidsConf] = None) -> float:
    conf = conf if conf is not None else C.get_active_conf()
    if conf.is_set(C.WATCHDOG_POLL_INTERVAL.key):
        return float(conf[C.WATCHDOG_POLL_INTERVAL])
    if "poll" in _GLOBAL_DEFAULTS:
        return float(_GLOBAL_DEFAULTS["poll"])
    return float(conf[C.WATCHDOG_POLL_INTERVAL])


# ---------------------------------------------------------------------------
_HB_LOCK = threading.Lock()
_HEARTBEATS: dict[int, "Heartbeat"] = {}
_HB_IDS = iter(range(1, 1 << 62))


class Heartbeat:
    """One watched activity.  `beat()` on every unit of progress;
    `pause()` around waits attributable to another watched party.
    Context manager: registered on creation, removed on exit."""

    def __init__(self, name: str, kind: str, deadline: float,
                 poll: float, token: CancelToken, dump: bool,
                 details: Optional[Callable[[], str]] = None,
                 slow_check: Optional[Callable[["Heartbeat", float],
                                               None]] = None):
        self.name = name
        self.kind = kind
        self.deadline = deadline
        self.poll = poll
        self.token = token
        self.dump_on_timeout = dump
        self.details = details
        #: optional *slow* classifier (distinct from hung), called every
        #: scan with (heartbeat, now) while the activity is live
        self.slow_check = slow_check
        self.thread_name = threading.current_thread().name
        self.thread_id = threading.get_ident()
        self.created = time.monotonic()
        self.last_beat = self.created
        self.beats = 0
        self.fired = False
        self._paused = 0
        self._id = next(_HB_IDS)
        #: the owning query (None outside a query): gap stats charge
        #: here and a timeout fires this query's token
        self.qc = _current_query_ctx()

    def beat(self, n: int = 1) -> None:
        now = time.monotonic()
        _note_gap((now - self.last_beat) * 1000.0, self.qc)
        self.last_beat = now
        self.beats += n

    @contextmanager
    def pause(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1
            # the wait sat out is not this activity's staleness
            self.last_beat = time.monotonic()

    def close(self) -> None:
        with _HB_LOCK:
            _HEARTBEATS.pop(self._id, None)

    def __enter__(self) -> "Heartbeat":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def describe(self) -> str:
        age = time.monotonic() - self.last_beat
        q = f" query={self.qc.query_id}" if self.qc is not None else ""
        return (f"{self.name} [{self.kind}]{q} beats={self.beats} "
                f"last_progress={age:.1f}s ago deadline="
                f"{self.deadline:.1f}s thread={self.thread_name}")


#: the watched activity running on each thread (`watching`)
_WATCH_TLS = threading.local()


@contextmanager
def watching(hb: Heartbeat):
    """Make `hb` this thread's watched activity for the duration, so a
    wait of this thread on another watched activity pauses it
    (`waiting_on_other`)."""
    prev = getattr(_WATCH_TLS, "hb", None)
    _WATCH_TLS.hb = hb
    try:
        yield hb
    finally:
        _WATCH_TLS.hb = prev


def waiting_on_other():
    """Context for a wait on another watched activity (a consumer on its
    producer's queue): it pauses this thread's own heartbeat, since the
    wait is the other activity's to answer for, and a long upstream
    stage that keeps beating is no hang of its consumers."""
    hb = getattr(_WATCH_TLS, "hb", None)
    return hb.pause() if hb is not None else nullcontext()


class _NullHeartbeat(Heartbeat):
    """Watchdog disabled: same surface, no registration, no scanning."""

    def __init__(self):
        pass

    def beat(self, n: int = 1) -> None:
        pass

    @contextmanager
    def pause(self):
        yield

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NULL_HB = _NullHeartbeat()


def enabled(conf: Optional[C.RapidsConf] = None) -> bool:
    conf = conf if conf is not None else C.get_active_conf()
    return bool(conf[C.WATCHDOG_ENABLED])


def heartbeat(name: str, kind: str = "task",
              details: Optional[Callable[[], str]] = None,
              conf: Optional[C.RapidsConf] = None,
              slow_check: Optional[Callable] = None) -> Heartbeat:
    """Register a watched activity under the current query's token.
    Returns a no-op handle when the watchdog is disabled."""
    conf = conf if conf is not None else C.get_active_conf()
    if not enabled(conf):
        return _NULL_HB
    hb = Heartbeat(name, kind, deadline_for(kind, conf), _poll_for(conf),
                   current_token(), bool(conf[C.WATCHDOG_DUMP_ON_TIMEOUT]),
                   details, slow_check=slow_check)
    with _HB_LOCK:
        _HEARTBEATS[hb._id] = hb
    _ensure_scanner()
    if hb.poll < _SCAN_SLEEP:
        # wake a mid-sleep scanner so a heartbeat with a shorter poll is
        # scanned at its own cadence
        _SCAN_WAKE.set()
    return hb


def active_heartbeats() -> list[Heartbeat]:
    with _HB_LOCK:
        return list(_HEARTBEATS.values())


# ---------------------------------------------------------------------------
_SCANNER_LOCK = threading.Lock()
_SCANNER: Optional[threading.Thread] = None
_SCAN_WAKE = threading.Event()
#: the scanner's current sleep between scans
_SCAN_SLEEP = 1.0


def _ensure_scanner() -> None:
    global _SCANNER
    with _SCANNER_LOCK:
        if _SCANNER is not None and _SCANNER.is_alive():
            return
        _SCANNER = threading.Thread(target=_scan_loop, daemon=True,
                                    name="tpu-watchdog")
        _SCANNER.start()


def _scan_loop() -> None:
    global _SCAN_SLEEP
    while True:
        _SCAN_SLEEP = max(0.01, min(_next_poll(), 5.0))
        if _SCAN_WAKE.wait(_SCAN_SLEEP):
            _SCAN_WAKE.clear()
        _scan(time.monotonic())


def _next_poll() -> float:
    """The shortest poll interval of the live heartbeats (a function, so
    no reference to a heartbeat, and through it to its query, outlives
    the scan)."""
    return min([hb.poll for hb in active_heartbeats()] or [1.0])


def _scan(now: float) -> None:
    for hb in active_heartbeats():
        if hb._paused > 0 or hb.fired or hb.token.cancelled:
            # one dump per cancellation: sibling activities all stall
            # once their query is cancelled
            continue
        if hb.slow_check is not None:
            try:
                hb.slow_check(hb, now)
            except Exception:  # noqa: BLE001 — a classifier bug
                log.exception("slow_check failed for %s", hb.name)
        gap = now - hb.last_beat
        _note_gap(gap * 1000.0, hb.qc)
        if gap > hb.deadline:
            hb.fired = True
            _fire(hb, gap)


def _fire(hb: Heartbeat, gap: float) -> None:
    reason = (f"no progress from {hb.name} for {gap:.1f}s (watchdog "
              f"{hb.kind} deadline {hb.deadline:.1f}s, "
              f"{_DEADLINE_ENTRIES[hb.kind].key})")
    dump = None
    if hb.dump_on_timeout:
        try:
            dump = build_dump(stuck=hb)
        except Exception as e:  # noqa: BLE001 — the dump must never
            dump = f"<diagnostic dump failed: {e}>"  # mask the timeout
    _note_fire(dump is not None, hb.qc)
    # one correlated record (query id, site, full dump) in the STUCK
    # query's own event log (the scanner thread belongs to no query);
    # the token's cancel event rides the same scope
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.utils import profile as P
    with S.scoped(hb.qc):
        P.event(P.EV_WATCHDOG_TIMEOUT, heartbeat=hb.name,
                deadline_class=hb.kind, gap_s=round(gap, 2),
                deadline_s=hb.deadline, stuck_thread=hb.thread_name,
                reason=reason, dump=dump)
        log.error("watchdog timeout: %s%s", reason,
                  "\n" + dump if dump else "")
        hb.token.cancel(reason, dump)


# ---------------------------------------------------------------------------
def _device_memory_lines() -> list[str]:
    """The DeviceManager's accounting and, on a card, the caching
    allocator's own counters (the role of XLA's memory stats)."""
    lines = []
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    dm = DeviceManager.peek()
    if dm is not None:
        lines.append(f"  accounting: {dm.snapshot()}")
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        keep = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                "reserved_bytes.all.current", "num_alloc_retries",
                "num_ooms")
        lines.append("  cuda: " + ", ".join(
            f"{k}={stats.get(k)}" for k in keep))
    return lines or ["  (no device manager, no card)"]


def build_dump(stuck: Optional[Heartbeat] = None) -> str:
    """One diagnostic snapshot: the stuck activity, every registered
    heartbeat, semaphore holders, the scheduler, the prefetch pipeline,
    the shuffle fetches in flight, speculation, device memory, hang
    injection and all thread stacks.  Every section
    is guarded on its own: a dump must never fail."""
    lines = ["==== query watchdog dump ===="]
    if stuck is not None:
        lines.append(f"stuck: {stuck.describe()}")
        if stuck.details is not None:
            try:
                lines.append(f"stuck details: {stuck.details()}")
            except Exception as e:  # noqa: BLE001
                lines.append(f"stuck details: <failed: {e}>")
    lines.append("-- heartbeats --")
    for hb in active_heartbeats():
        mark = " (PAUSED)" if hb._paused > 0 else ""
        lines.append(f"  {hb.describe()}{mark}")

    def section(title: str, body: Callable[[], list]) -> None:
        lines.append(f"-- {title} --")
        try:
            lines.extend(body())
        except Exception as e:  # noqa: BLE001
            lines.append(f"  <unavailable: {e}>")

    def semaphore() -> list:
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        sem = TpuSemaphore.get()
        snap = sem.snapshot()
        return ([f"  holders={len(snap['refs'])} "
                 f"max_concurrent={sem.max_concurrent} "
                 f"refs={snap['refs']} query_holds={snap['queryHolds']} "
                 f"longest_wait_ms={snap['longestWaitMs']}"]
                + [f"  waiting: {w}" for w in snap["waiters"]])

    def scheduler() -> list:
        from spark_rapids_tpu_torch.exec.scheduler import QueryScheduler
        return [f"  {QueryScheduler.get().describe()}",
                f"  stats={QueryScheduler.get().stats()}"]

    def pipeline() -> list:
        from spark_rapids_tpu_torch.exec.pipeline import (pipeline_live,
                                                          pipeline_stats)
        return [f"  {pipeline_stats()} live={pipeline_live()}"]

    def fetches() -> list:
        from spark_rapids_tpu_torch.shuffle.client_server import (
            inflight_fetches)
        return [f"  {f}" for f in inflight_fetches()] or ["  (none)"]

    def speculation() -> list:
        from spark_rapids_tpu_torch.exec.speculation import (
            speculation_stats)
        return [f"  {speculation_stats()} "
                f"slow_injected={slow_injection_counts()}"]

    def injection() -> list:
        with _INJ_LOCK:
            return [f"  counters={dict(_INJ_COUNTS)} "
                    f"hanging={sorted(_INJ_HANGING)} "
                    f"slow_injected={slow_injection_counts()}"]

    def stacks() -> list:
        out = []
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            out.append(f"  thread {names.get(tid, '?')} ({tid}):")
            for fl in traceback.format_stack(frame):
                out.extend("    " + ln for ln in fl.rstrip().splitlines())
        return out

    section("semaphore", semaphore)
    section("query scheduler", scheduler)
    section("prefetch pipeline", pipeline)
    section("in-flight shuffle fetches", fetches)
    section("speculation / slow injection", speculation)
    def residency() -> list:
        # the holder table (utils/residency.py): a post-mortem near an
        # OOM shows WHO owned the memory, not just how much
        from spark_rapids_tpu_torch.utils import residency as RS
        return [RS.describe_for_dump()]

    def telemetry() -> list:
        # engine-wide state (gauges, recent utilization samples): what
        # the whole process was doing, not just the stuck query
        from spark_rapids_tpu_torch.utils import telemetry as T
        return [T.describe_for_dump()]

    section("device memory", _device_memory_lines)
    section("residency", residency)
    section("telemetry", telemetry)
    section("hang injection", injection)
    section("thread stacks", stacks)
    lines.append("==== end watchdog dump ====")
    return "\n".join(lines)


def thread_stack(thread_id: Optional[int]) -> str:
    """Formatted stack of one thread; empty when it is gone."""
    try:
        frame = sys._current_frames().get(thread_id)
        if frame is None:
            return ""
        return "".join(traceback.format_stack(frame))
    except Exception:  # noqa: BLE001
        return ""


# ---------------------------------------------------------------------------
# seeded hang injection
_INJ_LOCK = threading.Lock()
_INJ_COUNTS: dict[str, int] = {}
_INJ_HANGING: set[str] = set()

def reset_hang_injection() -> None:
    with _INJ_LOCK:
        _INJ_COUNTS.clear()
        _INJ_HANGING.clear()


def maybe_hang(site: str, conf: Optional[C.RapidsConf] = None) -> None:
    """Hang-injection hook, called once per unit of progress at each
    instrumented site.  When `faultInjection.hangSite` names this site
    and its progress budget (`hangAfterBatches`) is spent, block until
    the watchdog cancels the query, then raise TpuQueryTimeout."""
    conf = conf if conf is not None else C.get_active_conf()
    target = str(conf[C.HANG_INJECT_SITE])
    if not target or target != site:
        return
    after = int(conf[C.HANG_INJECT_AFTER])
    with _INJ_LOCK:
        n = _INJ_COUNTS.get(site, 0) + 1
        _INJ_COUNTS[site] = n
        if n <= after:
            return
        _INJ_HANGING.add(site)
    tok = current_token()
    log.warning("hang injection engaged at site '%s' (progress %d > "
                "hangAfterBatches=%d); blocking until the watchdog "
                "cancels the query", site, n, after)
    t0 = time.monotonic()
    try:
        while not tok.wait(_POLL_S):
            if time.monotonic() - t0 > _HANG_HARD_CAP_S:
                raise RuntimeError(
                    f"injected hang at '{site}' exceeded the "
                    f"{_HANG_HARD_CAP_S:.0f}s hard cap without a "
                    "watchdog cancel: is watchdog.enabled off while "
                    "hang injection is on?")
    finally:
        with _INJ_LOCK:
            _INJ_HANGING.discard(site)
    raise TpuQueryTimeout(
        f"hang-injected site '{site}' cancelled: {tok.reason}",
        dump=tok.dump)


# ---------------------------------------------------------------------------
# seeded slow (straggler) injection: the site keeps beating, slower
#: per-unit delay hard cap
_SLOW_HARD_CAP_S = 2.0

_SLOW_LOCK = threading.Lock()
_SLOW_COUNTS: dict[str, int] = {}
_SLOW_RNGS: dict = {}


def reset_slow_injection() -> None:
    with _SLOW_LOCK:
        _SLOW_COUNTS.clear()
        _SLOW_RNGS.clear()


def slow_injection_counts() -> dict:
    """{site: units delayed} since the last reset."""
    with _SLOW_LOCK:
        return dict(_SLOW_COUNTS)


def maybe_slow(site: str, conf: Optional[C.RapidsConf] = None,
               executor_id: Optional[str] = None) -> float:
    """Delay-injection hook: when `faultInjection.slowSite` names this
    site (and `slowVictim`, if set, names this executor), sleep
    (slowFactor - 1) x slowUnitMs with seeded +/-25% jitter, cancellably.
    Returns the injected delay (0 = none)."""
    conf = conf if conf is not None else C.get_active_conf()
    target = str(conf[C.SLOW_INJECT_SITE])
    if not target or target != site:
        return 0.0
    factor = float(conf[C.SLOW_INJECT_FACTOR])
    if factor <= 1.0:
        return 0.0
    victim = str(conf[C.SLOW_INJECT_VICTIM])
    if victim and executor_id is not None and victim != str(executor_id):
        return 0.0
    import random
    seed = int(conf[C.SLOW_INJECT_SEED])
    with _SLOW_LOCK:
        rng = _SLOW_RNGS.get((factor, seed))
        if rng is None:
            rng = _SLOW_RNGS[(factor, seed)] = random.Random(seed)
        jitter = 0.75 + 0.5 * rng.random()
        _SLOW_COUNTS[site] = _SLOW_COUNTS.get(site, 0) + 1
    unit_s = float(conf[C.SLOW_INJECT_UNIT_MS]) / 1e3
    delay = min((factor - 1.0) * unit_s * jitter, _SLOW_HARD_CAP_S)
    if delay > 0:
        cancellable_sleep(delay)
    return delay
