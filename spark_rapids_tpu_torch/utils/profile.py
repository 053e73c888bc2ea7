"""Per-query observability: span tracing, Chrome-trace export,
EXPLAIN-with-metrics, and a structured event log (port of
spark_rapids_tpu/utils/profile.py).

The reference plugin's operators are observable end to end: NVTX ranges
(`NvtxWithMetrics.scala`) land in Nsight timelines and every `GpuExec`
surfaces SQLMetrics in the Spark UI plan graph.  This module is the
engine's equivalent lens: per-operator timeline attribution plus
data-movement accounting.

Three pieces:

* **QueryTracer** — one per profiled query (installed by the outermost
  collect when `spark.rapids.sql.profile.enabled`).  Records a span
  tree — query -> stage/exchange -> operator -> batch-loop / compile /
  shuffle-fetch / retry — into a bounded ring buffer, emitting each
  span also through `utils/tracing.annotation` (an NVTX range on a
  CUDA query, a `torch.profiler.record_function` range on the CPU) so
  Nsight and torch.profiler captures line up with it.  Parenting is
  THREAD-PROPAGATED: the opening thread's innermost live span is the
  parent, and helper threads (pipeline producers, shuffle fetch/server
  threads, AQE stage fills, speculative attempts) attach to the span
  context their creator captured via `current_ref()` / `attach()`.
* **Event log** — structured records (span open/close, OOM retries,
  fetch failures/retries, peer blacklists, watchdog timeouts + dumps,
  cancellations), every one carrying the query id, exported as JSONL.
* **QueryProfile** — assembled when the query's collect finishes: the
  plan `tree_string` annotated per-node with resolved MetricSet values
  (EXPLAIN-with-metrics, the Spark UI plan-graph analog), a wall-clock
  breakdown (compute vs pipeline wait vs shuffle vs compile vs
  retry-block), the top-N slowest spans, the span list (Chrome
  trace-event JSON export, loadable in Perfetto), and the event
  records.  A bounded history of the last
  `spark.rapids.sql.profile.historySize` profiles is queryable from
  tests and bench harnesses.

Discipline: with profiling DISABLED (default) the batch hot loop must
allocate no tracer objects — every hook either returns its input
unchanged (`wrap_operator`), returns a shared null context (`span`), or
is a single module-global read (`tracer()`); call sites that would
build a label string guard on `tracer() is not None` first.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Iterator, Optional

from spark_rapids_tpu_torch import config as C

#: span categories with first-class roles in the wall-clock breakdown
CAT_QUERY = "query"
CAT_EXEC = "exec"
CAT_PIPELINE = "pipeline"
CAT_WAIT = "wait"          # consumer blocked on an empty prefetch queue
CAT_SHUFFLE = "shuffle"
CAT_COMPILE = "compile"
CAT_RETRY = "retry"        # OOM retry harness blocked (spill/reserve)
CAT_UDF = "udf"
CAT_QUEUE = "queue"        # parked in the scheduler's admission queue

#: ring-buffer bounds — big enough for a deep TPC-DS plan's batch spans,
#: small enough that a runaway loop cannot eat the heap
MAX_SPANS = 1 << 16
MAX_EVENTS = 1 << 14

# ---------------------------------------------------------------------------
# Event-name registry: every structured event kind the engine can emit,
# defined ONCE here and imported as a constant by its emitter — the
# event-log schema analog of config.py's typed conf registry (and
# enforced the same way tpulint's conf-discipline rule covers confs:
# `event()` rejects an unregistered kind, so a typo'd or undocumented
# event name is a test failure, not a silently unqueryable log record).
EV_SPAN_OPEN = "span_open"
EV_SPAN_CLOSE = "span_close"
EV_QUERY_ERROR = "query_error"
EV_QUERY_QUEUED = "query_queued"            # exec/scheduler.py
EV_QUERY_ADMITTED = "query_admitted"
EV_QUERY_REJECTED = "query_rejected"
EV_SEMAPHORE_WAIT = "semaphore_wait"        # memory/semaphore.py
EV_OOM_RETRY = "oom_retry"                  # memory/retry.py
EV_OOM_SPLIT_RETRY = "oom_split_retry"
EV_OOM_FALLBACK = "oom_fallback"
EV_DEOPT_RETRY = "deopt_retry"              # exec/base.py
EV_STAGE_FUSED = "stage_fused"              # plan/fusion.py, exec/aggregate.py
EV_FUSION_DEOPT = "fusion_deopt"
EV_STAGE_SPMD = "stage_spmd"                # reference exec/spmd.py
EV_SPMD_DEOPT = "spmd_deopt"
EV_SPECULATION_LAUNCHED = "speculation_launched"  # exec/speculation.py
EV_SPECULATION_WIN = "speculation_win"
EV_HEDGE_FIRED = "hedge_fired"              # shuffle/manager.py
EV_FETCH_FAILURE = "fetch_failure"          # shuffle/client_server.py
EV_FETCH_RETRY = "fetch_retry"
EV_WIRE_CORRUPTION = "wire_corruption"
EV_MAP_RECOMPUTE = "map_recompute"          # shuffle/recovery.py
EV_STAGE_RETRY = "stage_retry"
EV_RECOVERY_EXHAUSTED = "recovery_exhausted"
EV_PEER_BLACKLISTED = "peer_blacklisted"
EV_REPLICA_PROMOTED = "replica_promoted"
EV_UDF_WORKER_CRASH = "udf_worker_crash"    # reference pyudf/daemon.py
EV_CANCEL = "cancel"                        # utils/watchdog.py
EV_WATCHDOG_TIMEOUT = "watchdog_timeout"
EV_DATA_MOVEMENT = "data_movement"          # utils/movement.py
EV_RESIDENCY_LEAK = "residency_leak"        # utils/residency.py
EV_TELEMETRY_SNAPSHOT = "telemetry_snapshot"  # utils/telemetry.py (JSONL)
EV_OOCORE_DEGRADE = "oocore_degrade"        # memory/oocore.py: operator
EV_OOCORE_SPILL_RUN = "oocore_spill_run"    # left the in-core lane
EV_OOCORE_MERGE_PASS = "oocore_merge_pass"
EV_OOCORE_GRACE_PARTITION = "oocore_grace_partition"
EV_OOCORE_RECURSE = "oocore_recurse"
EV_OOCORE_CORRUPT_QUARANTINE = "oocore_corrupt_quarantine"
EV_OOCORE_CORRUPT_RECOVERED = "oocore_corrupt_recovered"

EVENT_KINDS = frozenset(
    v for k, v in list(globals().items()) if k.startswith("EV_"))


class Span:
    """One closed (or still-open) timeline range.  Times are
    `perf_counter_ns` anchored to the tracer's origin."""

    __slots__ = ("sid", "parent_id", "name", "cat", "t0", "dur_ns",
                 "thread_id", "thread_name", "args")

    def __init__(self, sid: int, parent_id: Optional[int], name: str,
                 cat: str, t0: int, args: Optional[dict] = None):
        self.sid = sid
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur_ns = 0
        t = threading.current_thread()
        # the OS thread id, not `ident`: Python reuses the ident of a
        # thread that ended for the next one started, which would merge
        # short-lived producer and fetch threads into one trace lane
        self.thread_id = threading.get_native_id()
        self.thread_name = t.name
        self.args = args or None

    def as_dict(self) -> dict:
        return {"sid": self.sid, "parent_id": self.parent_id,
                "name": self.name, "cat": self.cat, "t0_ns": self.t0,
                "dur_ns": self.dur_ns, "thread": self.thread_name,
                "tid": self.thread_id,
                **({"args": self.args} if self.args else {})}


# ---------------------------------------------------------------------------
# thread-local span context: (tracer, innermost live Span).  Stale
# entries from a finished query are ignored because every read checks
# the tracer identity against its live query.
_TLS = threading.local()

_TRACER_LOCK = threading.Lock()
#: FALLBACK tracer for threads with no query identity at all (shuffle
#: server handlers, bare tests): the most recently begun still-active
#: tracer.  Threads carrying a QueryContext always resolve their own
#: query's tracer instead — a profiled query A never records events
#: from query B's threads.
_TRACER: Optional["QueryTracer"] = None
#: count of live tracers across all concurrent queries — the hot-loop
#: disabled-path gate stays ONE module-global read
_ACTIVE = 0

_QUERY_IDS = iter(range(1, 1 << 62))


def tracer() -> Optional["QueryTracer"]:
    """The live tracer for the CALLING thread's query, or None when
    profiling is off / its query is unprofiled.  With no profiled query
    anywhere this is ONE module-global read — cheap enough for hot
    loops to gate on."""
    if _ACTIVE == 0:
        return None
    try:
        from spark_rapids_tpu_torch.exec import scheduler as S
        qc = S.current()
    except ImportError:
        qc = None
    if qc is not None:
        return qc.tracer   # None for an unprofiled query: isolation
    return _TRACER


def _tls_ctx(tr: "QueryTracer") -> Optional[Span]:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is not None and ctx[0] is tr:
        return ctx[1]
    return None


class QueryTracer:
    """Span + event recorder for one query."""

    def __init__(self, conf: C.RapidsConf,
                 query_id: Optional[str] = None):
        self.query_id = query_id or f"q{next(_QUERY_IDS):06d}"
        self.conf = conf
        self.ended = False
        self.t_origin = time.perf_counter_ns()
        self.wall_start = time.time()
        self._ids = iter(range(1, 1 << 62))
        self._spans: "collections.deque[Span]" = \
            collections.deque(maxlen=MAX_SPANS)
        self._events: "collections.deque[dict]" = \
            collections.deque(maxlen=MAX_EVENTS)
        self.root: Optional[Span] = None
        self.dropped_spans = 0
        #: spans annotate as NVTX ranges when the query runs on a card
        from spark_rapids_tpu_torch.utils.tracing import \
            query_device_is_cuda
        self.cuda = query_device_is_cuda()
        #: per-query data-movement ledger (utils/movement.py): bytes
        #: on every edge, resolved by movement.ledger() through this
        #: tracer so byte accounting inherits the profiler's per-query
        #: isolation and its allocation-free disabled path
        self.ledger = None
        if conf[C.MOVEMENT_ENABLED]:
            from spark_rapids_tpu_torch.utils import movement as MV
            self.ledger = MV.DataMovementLedger(
                self.query_id, self.t_origin,
                min_event_bytes=int(conf[C.MOVEMENT_MIN_EVENT_BYTES]))
            self.ledger.tracer = self
        #: per-query kernel attribution (utils/kernelprof.py): which
        #: compiled kernels this query dispatched and the device time
        #: its sampled dispatches measured — the '-- kernels --'
        #: section's source, isolated per query like the ledger
        self.kernels = None
        if conf[C.KERNELPROF_ENABLED]:
            from spark_rapids_tpu_torch.utils import kernelprof as KP
            KP.maybe_enable(conf)  # bare paths without a QueryScope
            self.kernels = KP.QueryKernelLedger(self.query_id,
                                                self.t_origin)
        #: per-query HBM residency ledger (utils/residency.py): live
        #: bytes by provenance site, the high-water mark + peak
        #: composition, and the end-of-query leak verdict — the
        #: '-- residency --' section's source.  Creating the first one
        #: sticky-enables process-wide provenance registration.
        self.residency = None
        if conf[C.RESIDENCY_ENABLED]:
            from spark_rapids_tpu_torch.utils import residency as RS
            RS.maybe_enable(conf)
            self.residency = RS.QueryResidencyLedger(
                self.query_id, self.t_origin,
                timeline=int(conf[C.RESIDENCY_TIMELINE_SIZE]),
                leak_dump=int(conf[C.RESIDENCY_LEAK_DUMP]))

    # -- spans ---------------------------------------------------------------
    def open_span(self, name: str, cat: str,
                  parent: Optional[Span], args: Optional[dict]) -> Span:
        s = Span(next(self._ids),
                 parent.sid if parent is not None
                 else (self.root.sid if self.root is not None else None),
                 name, cat, time.perf_counter_ns() - self.t_origin, args)
        self.event(EV_SPAN_OPEN, name=name, cat=cat, sid=s.sid,
                   parent_id=s.parent_id)
        return s

    def close_span(self, s: Span) -> None:
        s.dur_ns = (time.perf_counter_ns() - self.t_origin) - s.t0
        if len(self._spans) == self._spans.maxlen:
            self.dropped_spans += 1
        self._spans.append(s)
        self.event(EV_SPAN_CLOSE, name=s.name, cat=s.cat, sid=s.sid,
                   dur_ns=s.dur_ns)

    # -- events --------------------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unregistered profiler event kind {kind!r}: event "
                "names are a schema — define an EV_* constant in "
                "utils/profile.py and emit through it")
        rec = {"ts_ns": time.perf_counter_ns() - self.t_origin,
               "query_id": self.query_id, "kind": kind,
               "thread": threading.current_thread().name}
        rec.update(fields)
        self._events.append(rec)

    def spans(self) -> list[Span]:
        return list(self._spans)

    def events(self) -> list[dict]:
        return list(self._events)


# ---------------------------------------------------------------------------
class _SpanCtx:
    """Live span scope: installs itself as the thread's innermost span
    on entry, restores the previous one on exit, and dual-emits through
    `utils/tracing.annotation` (NVTX on a CUDA query) so Nsight and
    torch.profiler captures keep working."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_span", "_prev",
                 "_ann")

    def __init__(self, tr: QueryTracer, name: str, cat: str,
                 args: Optional[dict]):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args
        self._span = None
        self._prev = None
        self._ann = None

    def __enter__(self) -> Span:
        tr = self._tr
        self._prev = getattr(_TLS, "ctx", None)
        parent = _tls_ctx(tr)
        self._span = tr.open_span(self._name, self._cat, parent,
                                  self._args)
        _TLS.ctx = (tr, self._span)
        from spark_rapids_tpu_torch.utils.tracing import annotation
        self._ann = annotation(f"{self._cat}:{self._name}", tr.cuda)
        self._ann.__enter__()
        return self._span

    def __exit__(self, *exc) -> None:
        try:
            self._ann.__exit__(*exc)
        finally:
            _TLS.ctx = self._prev
            self._tr.close_span(self._span)


class _NullSpanCtx:
    """Shared no-op scope: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpanCtx()


def span(name: str, cat: str = CAT_EXEC, **args):
    """Open a span under the current thread's innermost live span (the
    query root when none).  Returns a shared null context when this
    thread's query is not being profiled — call sites that would
    allocate building `name` should gate on `tracer() is not None`."""
    tr = tracer()
    if tr is None:
        return _NULL_SPAN
    return _SpanCtx(tr, name, cat, args or None)


def event(kind: str, **fields) -> None:
    """Append one structured record to the calling thread's query's
    event log (a no-op when that query is not being profiled)."""
    tr = tracer()
    if tr is not None:
        tr.event(kind, **fields)


# ---------------------------------------------------------------------------
# cross-thread span-context propagation
def current_ref():
    """Capture the calling thread's span context for a helper thread
    (pipeline producer, shuffle fetch thread, AQE fill, speculative
    attempt).
    None when this thread's query is not being profiled."""
    tr = tracer()
    if tr is None:
        return None
    return (tr, _tls_ctx(tr))


class _AttachCtx:
    __slots__ = ("_ref", "_prev")

    def __init__(self, ref):
        self._ref = ref
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = self._ref
        return self

    def __exit__(self, *exc):
        _TLS.ctx = self._prev
        return False


def attach(ref):
    """Install a captured span context as this thread's parent scope,
    so spans the thread opens land under the creator's span.  A stale
    ref (its query already ended) or None degrades to a no-op."""
    if ref is None or ref[0].ended:
        return _NULL_SPAN
    return _AttachCtx(ref)


# ---------------------------------------------------------------------------
def wrap_operator(exec_, idx: int, it: Iterator) -> Iterator:
    """Wrap one operator partition iterator so every batch pull records
    an `op:<Exec>` span on the pulling thread (child pulls nest inside,
    so the span tree mirrors the plan tree).  Returns `it` UNCHANGED
    when this thread's query is not being profiled — the disabled hot
    loop keeps its exact iterator object and allocates nothing."""
    if tracer() is None:
        return it
    return _op_spans(exec_.name(), idx, it)


def _op_spans(name: str, idx: int, it: Iterator) -> Iterator:
    it = iter(it)
    label = f"{name}[p{idx}]"
    while True:
        tr = tracer()
        if tr is None or tr.ended:
            # the profiled query ended (e.g. iterator outlived collect):
            # stop tracing, keep streaming
            yield from it
            return
        with _SpanCtx(tr, label, CAT_EXEC, None):
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


# ---------------------------------------------------------------------------
def begin_query(conf: Optional[C.RapidsConf] = None
                ) -> Optional[QueryTracer]:
    """Install a tracer for a new top-level query if profiling is
    enabled and ITS query has none yet.  With a QueryContext in scope
    (the concurrent-serving path) the tracer lives on the context —
    several profiled queries record side by side, each into its own
    tracer; without one (legacy/bare paths) a single process-global
    tracer preserves the old one-at-a-time behavior.  Returns the
    tracer iff THIS caller owns it (and must pass it to `end_query`);
    None otherwise, so nested collects inside a profiled query are
    free."""
    global _TRACER, _ACTIVE
    conf = conf if conf is not None else C.get_active_conf()
    if not conf[C.PROFILE_ENABLED]:
        return None
    try:
        from spark_rapids_tpu_torch.exec import scheduler as S
        qc = S.current()
    except ImportError:
        qc = None
    with _TRACER_LOCK:
        if qc is not None:
            if qc.tracer is not None:
                return None
            tr = QueryTracer(conf, query_id=qc.query_id)
            qc.tracer = tr
        else:
            if _TRACER is not None:
                return None
            tr = QueryTracer(conf)
        _TRACER = tr        # fallback for query-less threads
        _ACTIVE += 1
    tr.root = tr.open_span("query", CAT_QUERY, None, None)
    _TLS.ctx = (tr, tr.root)
    return tr


def end_query(owner: Optional[QueryTracer], plan=None,
              error: Optional[BaseException] = None
              ) -> Optional["QueryProfile"]:
    """Close the owned tracer, assemble the QueryProfile, push it into
    the bounded history, and flush the conf'd file sinks.  No-op when
    `owner` is None (this caller did not begin the query)."""
    global _TRACER, _ACTIVE
    if owner is None:
        return None
    if error is not None:
        owner.event(EV_QUERY_ERROR, error=f"{type(error).__name__}: "
                    f"{error}"[:500])
    owner.close_span(owner.root)
    try:
        from spark_rapids_tpu_torch.exec import scheduler as S
        qc = S.current()
    except ImportError:
        qc = None
    with _TRACER_LOCK:
        owner.ended = True
        if qc is not None and qc.tracer is owner:
            qc.tracer = None
        if _TRACER is owner:
            _TRACER = None
        _ACTIVE = max(0, _ACTIVE - 1)
    if getattr(_TLS, "ctx", None) is not None and _TLS.ctx[0] is owner:
        _TLS.ctx = None
    if owner.kernels is not None:
        # the sampled CUDA event pairs are read here, once per query
        # (outside the assembly's guards: a CUDA event that fails raises)
        owner.kernels.resolve()
    if owner.residency is not None:
        # leak check: tracked allocations still attributed to this
        # finished query are flagged, counted, and dumped with full
        # provenance — before the profile assembles so the report
        # carries the verdict
        try:
            leaked = owner.residency.finalize()
            for rec in leaked[:owner.residency.leak_dump]:
                fields = dict(rec)
                # the record's allocation kind must not shadow the
                # event-log schema's own `kind` field
                fields["alloc_kind"] = fields.pop("kind", None)
                owner.event(EV_RESIDENCY_LEAK, **fields)
            if leaked and plan is not None \
                    and getattr(plan, "metrics", None) is not None:
                from spark_rapids_tpu_torch.utils import metrics as M
                plan.metrics.add(M.NUM_RESIDENCY_LEAKS, len(leaked))
        except Exception:  # noqa: BLE001 — diagnostics must never
            pass           # fail the query
    profile = QueryProfile.build(owner, plan)
    hist_size = max(0, int(owner.conf[C.PROFILE_HISTORY_SIZE]))
    with _HISTORY_LOCK:
        _HISTORY.append(profile)
        del _HISTORY[:max(0, len(_HISTORY) - hist_size)]
    # engine-wide telemetry: aggregate this profile into the
    # slow-query log (one global read when telemetry is off)
    from spark_rapids_tpu_torch.utils import telemetry as T
    T.note_query_profile(profile, plan)
    try:
        profile.flush_sinks(owner.conf)
    except OSError:
        import logging
        logging.getLogger("spark_rapids_tpu_torch.profile").warning(
            "could not write profile sinks for %s", profile.query_id,
            exc_info=True)
    return profile


_HISTORY_LOCK = threading.Lock()
_HISTORY: list["QueryProfile"] = []

# ---------------------------------------------------------------------------
# size-bounded JSONL appends: the profile event-log sink (and the
# telemetry snapshots riding it) used to grow one file without limit
# under long-running serving
_ROTATE_LOCK = threading.Lock()


def rotating_append(path: str, text: str, max_bytes: int = 0,
                    keep: int = 1) -> None:
    """Append `text` to `path`, rotating first when the append would
    push the file past `max_bytes` (0 = never rotate): the current
    file becomes `<path>.1`, existing rotations shift to `.2` ...
    `.keep`, and the oldest is dropped.  One process-wide lock
    serializes concurrent queries' appends so a rotation never races a
    write."""
    with _ROTATE_LOCK:
        if max_bytes > 0:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size > 0 and size + len(text) > max_bytes:
                keep = max(0, int(keep))
                for i in range(keep - 1, 0, -1):
                    src = f"{path}.{i}"
                    if os.path.exists(src):
                        os.replace(src, f"{path}.{i + 1}")
                if keep >= 1:
                    os.replace(path, f"{path}.1")
                else:
                    os.remove(path)
        with open(path, "a") as f:
            f.write(text)


def profile_history() -> list["QueryProfile"]:
    """Last `spark.rapids.sql.profile.historySize` profiles, oldest
    first."""
    with _HISTORY_LOCK:
        return list(_HISTORY)


def last_profile() -> Optional["QueryProfile"]:
    with _HISTORY_LOCK:
        return _HISTORY[-1] if _HISTORY else None


def clear_history() -> None:
    with _HISTORY_LOCK:
        _HISTORY.clear()


# ---------------------------------------------------------------------------
def explain_with_metrics(plan, indent: int = 0,
                         kernel_index: Optional[dict] = None) -> str:
    """The plan `tree_string` with every node annotated by its resolved
    MetricSet values — the Spark UI plan-graph analog.  Resolving reads
    back lazy device counters; acceptable, profiling is on.

    `kernel_index` ({exec_id: [kernelprof report rows]}, built from the
    query's QueryKernelLedger) additionally annotates owning nodes —
    and every fused `* member` line — with their hottest kernel's
    device time and roofline %, so EXPLAIN alone points at the slow
    kernel without opening a trace."""
    lines: list[str] = []
    _explain_node(plan, indent, lines, kernel_index)
    return "\n".join(lines)


def _fmt_kernel_annot(rows: list) -> str:
    """Bracketed per-node kernel summary (the whole annotation stays
    inside one [..] so every report line still ends with a bracket)."""
    top = rows[0]
    roof = (f" {top['roofline_pct']}%-roofline {top['bound']}-bound"
            if "roofline_pct" in top else "")
    more = f" +{len(rows) - 1} more" if len(rows) > 1 else ""
    return (f"  [kernel {top['fingerprint']} {top['device_ms']}ms "
            f"x{top['dispatches']}{roof}{more}]")


def _explain_node(node, indent: int, lines: list[str],
                  kernel_index: Optional[dict] = None) -> None:
    desc = node.describe() if hasattr(node, "describe") else \
        type(node).__name__
    ms = {}
    metrics = getattr(node, "metrics", None)
    if metrics is not None:
        try:
            ms = {k: v for k, v in sorted(metrics.as_dict().items())
                  if v}
        except Exception:  # noqa: BLE001 — a broken metric must not
            ms = {"<metrics unavailable>": 1}  # hide the plan report
    annot = ", ".join(_fmt_metric(k, v) for k, v in ms.items())
    krows = (kernel_index or {}).get(getattr(node, "exec_id", None))
    kannot = _fmt_kernel_annot(krows) if krows else ""
    lines.append("  " * indent + desc
                 + (f"  [{annot}]" if annot else "  [no metrics]")
                 + kannot)
    # whole-stage fusion groups (plan/fusion.py): render each fused
    # member operator with ITS metric breakdown under the fused node —
    # per-node metrics still resolve even though the operators share
    # one compiled kernel, whose roofline annotation rides each member
    # line (the members ARE that kernel)
    for mdesc, mmetrics in getattr(node, "fused_members", []) or []:
        try:
            mms = {k: v for k, v in sorted(mmetrics.as_dict().items())
                   if v}
        except Exception:  # noqa: BLE001 — same guard as node metrics
            mms = {"<metrics unavailable>": 1}
        mannot = ", ".join(_fmt_metric(k, v) for k, v in mms.items())
        lines.append("  " * (indent + 1) + "* " + mdesc
                     + (f"  [{mannot}]" if mannot else "  [no metrics]")
                     + kannot)
    for c in getattr(node, "children", []) or []:
        _explain_node(c, indent + 1, lines, kernel_index)
    # AQE wrappers hold their plan below non-children attributes
    for attr in ("exchange", "stage"):
        inner = getattr(node, attr, None)
        if inner is not None and inner not in (
                getattr(node, "children", []) or []):
            _explain_node(inner, indent + 1, lines, kernel_index)


#: metric names holding nanosecond durations (MetricSet.timed and the
#: retry/pipeline instrumentation all record perf_counter_ns deltas)
_NS_METRICS = {"totalTime", "retryBlockTime", "pipelineWaitTime",
               "recoveryTime", "broadcastTime", "bufferTime",
               "tpuDecodeTime", "compileTime"}


def _fmt_metric(k: str, v) -> str:
    if k in _NS_METRICS:
        return f"{k}={v / 1e6:.1f}ms"
    if isinstance(v, float) and v == int(v):
        return f"{k}={int(v)}"
    return f"{k}={v}"


# ---------------------------------------------------------------------------
class QueryProfile:
    """The per-query artifact collect() assembles when profiling is on."""

    def __init__(self, query_id: str, wall_start: float, wall_s: float,
                 spans: list[Span], events: list[dict],
                 plan_report: str, breakdown: dict,
                 dropped_spans: int = 0, movement: Optional[dict] = None,
                 movement_samples: Optional[list] = None,
                 kernels: Optional[list] = None,
                 kernel_samples: Optional[list] = None,
                 kernel_top_n: int = 12,
                 residency: Optional[dict] = None,
                 residency_samples: Optional[list] = None,
                 oocore: Optional[dict] = None):
        self.query_id = query_id
        self.wall_start = wall_start
        self.wall_s = wall_s
        self.spans = spans
        self.events = events
        self.plan_report = plan_report
        self.breakdown = breakdown
        self.dropped_spans = dropped_spans
        #: data-movement report (utils/movement.py): per-edge byte
        #: totals + effective GB/s vs roofline; None when movement
        #: accounting was off for this query
        self.movement = movement
        #: (ts_ns, edge, cumulative_bytes) samples backing the Chrome
        #: counter tracks
        self.movement_samples = movement_samples or []
        #: per-kernel attribution rows (utils/kernelprof.py
        #: QueryKernelLedger.report — device time, roofline %, compile
        #: ms per kernel this query dispatched); None when kernel
        #: attribution was off for this query
        self.kernels = kernels
        #: (t0_ns, dur_ns, fingerprint, label, tid) sampled-dispatch
        #: records backing the Perfetto kernel tracks
        self.kernel_samples = kernel_samples or []
        self.kernel_top_n = kernel_top_n
        #: HBM residency report (utils/residency.py): high-water mark,
        #: peak-instant composition by site/tier, leak verdict; None
        #: when residency tracking was off for this query
        self.residency = residency
        #: (ts_ns, site, site_bytes, total_bytes) samples backing the
        #: Perfetto residency:<site> counter tracks
        self.residency_samples = residency_samples or []
        #: out-of-core execution summary (memory/oocore.py EV_OOCORE_*
        #: events rolled up): runs/bytes spilled, merge passes, grace
        #: partitions, recursion depth, corruption recoveries per
        #: operator; None when no operator degraded out of core
        self.oocore = oocore

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, tr: QueryTracer, plan) -> "QueryProfile":
        spans = tr.spans()
        kernels = None
        kernel_samples = None
        kernel_index: Optional[dict] = None
        if tr.kernels is not None:
            try:
                kernels = tr.kernels.report(tr.conf)
                kernel_samples = tr.kernels.samples()
                kernel_index = {}
                for row in kernels:
                    oid = row.get("owner_id")
                    if oid is not None:
                        kernel_index.setdefault(oid, []).append(row)
            except Exception:  # noqa: BLE001 — assembly must not fail
                kernels = None
        report = ""
        if plan is not None:
            try:
                report = explain_with_metrics(
                    plan, kernel_index=kernel_index)
            except Exception as e:  # noqa: BLE001 — profile assembly
                report = f"<plan report failed: {e}>"  # must never fail
        wall_s = (tr.root.dur_ns if tr.root is not None else 0) / 1e9
        movement = None
        samples = None
        if tr.ledger is not None:
            try:
                movement = tr.ledger.report(
                    wall_s, float(tr.conf[C.MOVEMENT_ROOFLINE_GBPS]),
                    conf=tr.conf)
                samples = tr.ledger.samples()
            except Exception:  # noqa: BLE001 — same guard as the plan
                movement = None  # report: assembly must never fail
        residency = None
        res_samples = None
        if tr.residency is not None:
            try:
                residency = tr.residency.report()
                res_samples = tr.residency.samples()
            except Exception:  # noqa: BLE001 — same guard again
                residency = None
        oocore = None
        try:
            oocore = cls._oocore_summary(tr.events())
        except Exception:  # noqa: BLE001 — same guard again
            oocore = None
        return cls(tr.query_id, tr.wall_start, wall_s,
                   spans, tr.events(), report,
                   cls._breakdown(spans, tr.root),
                   dropped_spans=tr.dropped_spans,
                   movement=movement, movement_samples=samples,
                   kernels=kernels, kernel_samples=kernel_samples,
                   kernel_top_n=max(1, int(tr.conf[C.KERNELPROF_TOP_N])),
                   residency=residency, residency_samples=res_samples,
                   oocore=oocore)

    @staticmethod
    def _oocore_summary(events: list[dict]) -> Optional[dict]:
        """Roll the EV_OOCORE_* stream up into the '-- out-of-core --'
        section: per-operator spilled runs/bytes, merge passes, grace
        fan-outs, max recursion depth, corruption quarantines and
        recoveries.  None when nothing degraded (the common case — the
        section only prints when out-of-core execution actually ran)."""
        per_op: dict[str, dict] = {}
        totals = {"spill_runs": 0, "spill_run_bytes": 0,
                  "merge_passes": 0, "grace_partitions": 0,
                  "max_recursion_depth": 0,
                  "corrupt_quarantined": 0, "corrupt_recovered": 0}

        def op(rec):
            name = rec.get("op", "?")
            return per_op.setdefault(name, {
                "spill_runs": 0, "spill_run_bytes": 0, "merge_passes": 0,
                "grace_partitions": 0, "max_recursion_depth": 0,
                "corrupt_quarantined": 0, "corrupt_recovered": 0})

        for rec in events:
            kind = rec.get("kind")
            if kind == EV_OOCORE_SPILL_RUN:
                row = op(rec)
                row["spill_runs"] += 1
                row["spill_run_bytes"] += int(rec.get("nbytes", 0))
                totals["spill_runs"] += 1
                totals["spill_run_bytes"] += int(rec.get("nbytes", 0))
            elif kind == EV_OOCORE_MERGE_PASS:
                op(rec)["merge_passes"] += 1
                totals["merge_passes"] += 1
            elif kind == EV_OOCORE_GRACE_PARTITION:
                n = int(rec.get("num_partitions", 0))
                op(rec)["grace_partitions"] += n
                totals["grace_partitions"] += n
            elif kind == EV_OOCORE_RECURSE:
                d = int(rec.get("depth", 0))
                row = op(rec)
                row["max_recursion_depth"] = max(
                    row["max_recursion_depth"], d)
                totals["max_recursion_depth"] = max(
                    totals["max_recursion_depth"], d)
            elif kind == EV_OOCORE_CORRUPT_QUARANTINE:
                op(rec)["corrupt_quarantined"] += 1
                totals["corrupt_quarantined"] += 1
            elif kind == EV_OOCORE_CORRUPT_RECOVERED:
                op(rec)["corrupt_recovered"] += 1
                totals["corrupt_recovered"] += 1
        if not per_op:
            return None
        return {"operators": per_op, "totals": totals}

    @staticmethod
    def _breakdown(spans: list[Span], root: Optional[Span]) -> dict:
        """Wall-clock attribution: per-category span time, counting only
        spans whose parent is in a DIFFERENT category (so nested
        same-category spans — a shuffle fetch inside a shuffle reader —
        are not double-counted), with the unattributed remainder of the
        root span reported as compute.  Category times are CUMULATIVE
        across threads: several consumers stalling concurrently can
        push pipeline_wait_s past wall_s (that is real — it measures
        total starvation, not elapsed time), in which case compute_s
        clamps at 0."""
        by_id = {s.sid: s for s in spans}
        wall_ns = root.dur_ns if root is not None else 0
        cats = {CAT_WAIT: 0, CAT_SHUFFLE: 0, CAT_COMPILE: 0,
                CAT_RETRY: 0, CAT_UDF: 0, CAT_QUEUE: 0}
        for s in spans:
            if s.cat not in cats:
                continue
            parent = by_id.get(s.parent_id)
            if parent is not None and parent.cat == s.cat:
                continue
            cats[s.cat] += s.dur_ns
        attributed = sum(cats.values())
        return {
            "wall_s": round(wall_ns / 1e9, 6),
            "pipeline_wait_s": round(cats[CAT_WAIT] / 1e9, 6),
            "shuffle_s": round(cats[CAT_SHUFFLE] / 1e9, 6),
            "compile_s": round(cats[CAT_COMPILE] / 1e9, 6),
            "retry_block_s": round(cats[CAT_RETRY] / 1e9, 6),
            "udf_s": round(cats[CAT_UDF] / 1e9, 6),
            "queue_wait_s": round(cats[CAT_QUEUE] / 1e9, 6),
            "compute_s": round(max(0, wall_ns - attributed) / 1e9, 6),
        }

    # -- views ---------------------------------------------------------------
    def top_spans(self, n: int = 10) -> list[Span]:
        """Slowest spans, excluding the query root."""
        return sorted((s for s in self.spans if s.cat != CAT_QUERY),
                      key=lambda s: s.dur_ns, reverse=True)[:n]

    def span_depth(self) -> int:
        """Deepest parent-chain length in the recorded span tree (the
        query root is depth 1)."""
        by_id = {s.sid: s for s in self.spans}
        best = 0
        for s in self.spans:
            d, cur = 1, s
            while cur.parent_id is not None:
                cur = by_id.get(cur.parent_id)
                if cur is None:
                    break
                d += 1
            best = max(best, d)
        return best

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing): one
        complete ('X') event per span plus thread-name metadata."""
        events: list[dict] = []
        threads: dict[int, str] = {}
        for s in self.spans:
            threads.setdefault(s.thread_id, s.thread_name)
            ev = {"name": s.name, "cat": s.cat, "ph": "X",
                  "ts": s.t0 / 1e3, "dur": s.dur_ns / 1e3,
                  "pid": 0, "tid": s.thread_id,
                  "args": {"span_id": s.sid,
                           "parent_id": s.parent_id,
                           "query_id": self.query_id}}
            if s.args:
                ev["args"].update(s.args)
            events.append(ev)
        for tid, tname in threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": tname}})
        # data-movement counter tracks: one cumulative-bytes counter
        # per edge, renderable alongside the span lanes in Perfetto
        for ts, edge, cum in self.movement_samples:
            events.append({"name": f"movement:{edge}", "ph": "C",
                           "ts": ts / 1e3, "pid": 0,
                           "args": {"bytes": cum}})
        # sampled kernel dispatches: complete events on the dispatching
        # thread's lane, so per-kernel device time lines up with the
        # operator spans in Perfetto
        for t0, dur, fp, label, tid in self.kernel_samples:
            events.append({"name": f"kernel:{label}", "cat": "kernel",
                           "ph": "X", "ts": t0 / 1e3, "dur": dur / 1e3,
                           "pid": 0, "tid": tid,
                           "args": {"fingerprint": fp,
                                    "query_id": self.query_id}})
        # HBM residency counter tracks: live bytes per provenance site
        # plus the query's total device-resident line, renderable
        # alongside the movement counters in Perfetto
        for ts, site, site_bytes, total in self.residency_samples:
            events.append({"name": f"residency:{site}", "ph": "C",
                           "ts": ts / 1e3, "pid": 0,
                           "args": {"bytes": site_bytes}})
            events.append({"name": "residency:total", "ph": "C",
                           "ts": ts / 1e3, "pid": 0,
                           "args": {"bytes": total}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"query_id": self.query_id,
                              "wall_s": self.wall_s,
                              "dropped_spans": self.dropped_spans}}

    def explain(self) -> str:
        """The human-facing report: EXPLAIN-with-metrics + wall-clock
        breakdown + top-N slowest spans."""
        lines = [f"== Query profile {self.query_id} "
                 f"({self.wall_s * 1e3:.1f} ms) ==",
                 "-- plan with metrics --",
                 self.plan_report or "<no plan captured>",
                 "-- wall-clock breakdown --"]
        for k, v in self.breakdown.items():
            if k == "wall_s":
                continue
            lines.append(f"  {k:18s} {v * 1e3:10.1f} ms")
        lines.append("-- slowest spans --")
        for s in self.top_spans():
            lines.append(f"  {s.dur_ns / 1e6:10.1f} ms  [{s.cat}] "
                         f"{s.name}  ({s.thread_name})")
        if self.kernels is not None:
            from spark_rapids_tpu_torch.utils import kernelprof as KP
            lines.append("-- kernels --")
            lines.append(KP.format_report(self.kernels,
                                          top_n=self.kernel_top_n))
        if self.movement is not None:
            from spark_rapids_tpu_torch.utils import movement as MV
            lines.append("-- data movement --")
            lines.append(MV.format_report(self.movement))
        if self.residency is not None:
            from spark_rapids_tpu_torch.utils import residency as RS
            lines.append("-- residency --")
            lines.append(RS.format_report(self.residency))
        if self.oocore is not None:
            lines.append("-- out-of-core --")
            t = self.oocore["totals"]
            lines.append(
                f"  total: {t['spill_runs']} runs "
                f"({t['spill_run_bytes'] / 1e6:.1f} MB spilled), "
                f"{t['merge_passes']} merge passes, "
                f"{t['grace_partitions']} grace partitions "
                f"(max depth {t['max_recursion_depth']}), "
                f"{t['corrupt_recovered']}/{t['corrupt_quarantined']} "
                f"corrupt reads recovered")
            for name, row in sorted(self.oocore["operators"].items()):
                lines.append(
                    f"  {name}: runs={row['spill_runs']} "
                    f"bytes={row['spill_run_bytes']} "
                    f"merges={row['merge_passes']} "
                    f"grace={row['grace_partitions']} "
                    f"depth={row['max_recursion_depth']} "
                    f"recovered={row['corrupt_recovered']}")
        return "\n".join(lines)

    # -- sinks ---------------------------------------------------------------
    def write_chrome_trace(self, path: str) -> str:
        path = path.replace("{query_id}", self.query_id)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def write_event_log(self, path: str, append: bool = True,
                        max_bytes: int = 0, keep: int = 1) -> str:
        path = path.replace("{query_id}", self.query_id)
        text = "".join(json.dumps(rec) + "\n" for rec in self.events)
        if not append:
            with open(path, "w") as f:
                f.write(text)
            return path
        rotating_append(path, text, max_bytes, keep)
        return path

    def flush_sinks(self, conf: C.RapidsConf) -> None:
        trace_path = str(conf[C.PROFILE_CHROME_TRACE_PATH])
        if trace_path:
            self.write_chrome_trace(trace_path)
        log_path = str(conf[C.PROFILE_EVENT_LOG_PATH])
        if log_path:
            self.write_event_log(
                log_path,
                max_bytes=int(conf[C.PROFILE_EVENT_LOG_MAX_BYTES]),
                keep=int(conf[C.PROFILE_EVENT_LOG_KEEP_FILES]))

    def __repr__(self):
        return (f"QueryProfile({self.query_id}, wall={self.wall_s:.3f}s,"
                f" spans={len(self.spans)}, events={len(self.events)})")
