"""Device manager: the device's memory budget accounting and the
spill-on-pressure handler (port of spark_rapids_tpu/memory/
device_manager.py).

Reference parallels: `GpuDeviceManager.scala` (device binding, RMM pool
arithmetic alloc-fraction/max/reserve) and `DeviceMemoryEventHandler.scala`
(alloc-failure callback -> synchronous spill device->host->disk -> retry).

The arena is *accounted* over PyTorch's CUDA caching allocator, not
intercepted, as in the reference: stores report resident bytes, operators
call `reserve(nbytes)` before materializing large outputs, and crossing
the budget triggers a preemptive synchronous spill of the device store.
The device is passed in.  Its total is `torch.cuda.mem_get_info(dev)[1]`
and its resident bytes `torch.cuda.memory_allocated(dev)`; a CPU device
takes the reference's off-accelerator default total.  A spill lowers
`memory_allocated` but not `memory_reserved`: the caching allocator keeps
the freed blocks for its next allocations, and nothing here empties it.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.vector import resolve_device

log = logging.getLogger("spark_rapids_tpu_torch.device_manager")

#: the reference's total where the device reports none (its off-TPU
#: default), used for a CPU device
_DEFAULT_HBM = 16 * 1024**3


class SpillCallback:
    """Alloc-pressure callback (DeviceMemoryEventHandler analog): spill the
    device store until `needed` bytes fit, retrying a bounded number of
    times; gives up when nothing is left to spill.

    Accounting: `bytes_spilled` is the process-wide total; the bytes a
    SINGLE pressure call freed accumulate thread-locally so the OOM
    retry harness charges each exec's `spillBytes` metric with the
    spills ITS thread triggered (a before/after delta of
    `bytes_spilled` would charge concurrent queries' spills to whichever
    exec read the counter)."""

    MAX_RETRIES = 3

    def __init__(self, device_store):
        self.device_store = device_store
        self.spill_count = 0
        self.bytes_spilled = 0
        self._lock = threading.Lock()
        self._tls = threading.local()

    def take_thread_freed(self) -> int:
        """Bytes freed by pressure calls on THIS thread since the last
        take (the per-exec spillBytes attribution source)."""
        freed = getattr(self._tls, "freed", 0)
        self._tls.freed = 0
        return freed

    def on_alloc_pressure(self, needed: int, budget: int,
                          reserved: int) -> bool:
        """Returns True if the allocation should be retried.  `reserved` is
        outstanding reservations by in-flight operators — the spill target
        must leave room for those commitments too, not just `needed`."""
        for _ in range(self.MAX_RETRIES):
            target = max(0, budget - needed - reserved)
            freed = self.device_store.synchronous_spill(target)
            with self._lock:
                self.spill_count += 1
                self.bytes_spilled += freed
            self._tls.freed = getattr(self._tls, "freed", 0) + freed
            if (self.device_store.current_size + reserved + needed
                    <= budget):
                return True
            if freed == 0:
                return False  # store empty / everything pinned
        return (self.device_store.current_size + reserved + needed
                <= budget)


class DeviceManager:
    """Process singleton (one accelerator per executor, like the
    reference's 1-GPU-per-executor model), on the device it was made
    with."""

    _instance: Optional["DeviceManager"] = None
    _lock = threading.Lock()

    def __init__(self, conf: Optional[C.RapidsConf] = None,
                 hbm_total: Optional[int] = None, device="cuda"):
        conf = conf or C.get_active_conf()
        self.conf = conf
        self.device = resolve_device(device)
        total = hbm_total or self._query_hbm_total()
        frac = conf[C.HBM_ALLOC_FRACTION]
        reserve = conf[C.HBM_RESERVE]
        # pool arithmetic mirrors GpuDeviceManager.scala:159-196
        self.budget = max(0, int(total * frac) - reserve)
        # conf-capped arena (out-of-core lever): hbmBudgetBytes caps
        # the derived budget so try_reserve headroom — the signal the
        # external sort/join/agg degradation reads — reflects the cap
        cap = int(conf[C.HBM_BUDGET_BYTES])
        if cap > 0:
            self.budget = min(self.budget, cap)
        self.hbm_total = total
        self._store_bytes = 0
        self._reserved = 0
        #: admission ledger (exec/scheduler.py): query_id -> declared
        #: HBM budget.  Coarse, query-lifetime commitments that gate
        #: ADMISSION of further queries; operator-level reserve() keeps
        #: doing the fine-grained real-time accounting within them.
        self._admitted: dict[str, int] = {}
        self._acct = threading.Lock()
        #: store-byte accounting clamped at zero (double-free
        #: indicator): count + the sites already logged once
        self._underflows = 0
        self._underflow_sites: set[str] = set()
        self.spill_callback: Optional[SpillCallback] = None

    # -- singleton lifecycle -------------------------------------------------
    @classmethod
    def initialize(cls, conf: Optional[C.RapidsConf] = None,
                   hbm_total: Optional[int] = None,
                   device=None) -> "DeviceManager":
        """The process's manager, made on `device` if there is none yet
        (a device must then be given)."""
        with cls._lock:
            if cls._instance is None:
                if device is None:
                    raise ValueError(
                        "DeviceManager: no manager yet, and no device "
                        "to make one on")
                cls._instance = cls(conf, hbm_total, device)
            return cls._instance

    @classmethod
    def get(cls, device=None) -> "DeviceManager":
        return cls.initialize(device=device)

    @classmethod
    def peek(cls) -> Optional["DeviceManager"]:
        """The live instance WITHOUT constructing one."""
        return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            cls._instance = None

    # -- device ---------------------------------------------------------------
    def _query_hbm_total(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.mem_get_info(self.device)[1])
        return _DEFAULT_HBM

    def resident_bytes(self) -> int:
        """Bytes the caching allocator has handed out on a card; the
        accounted store and reserved bytes on the CPU."""
        if self.device.type == "cuda":
            return int(torch.cuda.memory_allocated(self.device))
        with self._acct:
            return self._store_bytes + self._reserved

    # -- accounting ----------------------------------------------------------
    def track_store_bytes(self, delta: int, site: str = "?") -> None:
        """Adjust accounted store-resident bytes.  Negative drift —
        the total going below zero, i.e. more bytes removed than were
        ever added, a double-free — is clamped at zero and counted
        (`store_bytes_underflow` gauge) instead of silently corrupting
        the admission ledger's headroom math; the offending site is
        logged once."""
        log_site = None
        with self._acct:
            nxt = self._store_bytes + delta
            if nxt < 0:
                self._underflows += 1
                if site not in self._underflow_sites:
                    self._underflow_sites.add(site)
                    log_site = site
                nxt = 0
            self._store_bytes = nxt
        if log_site is not None:
            log.warning(
                "store-byte accounting underflow at site %r (delta %d "
                "past zero): clamped — a double-free is corrupting the "
                "device store's byte tracking", log_site, delta)

    def store_bytes_underflows(self) -> int:
        with self._acct:
            return self._underflows

    @property
    def store_bytes(self) -> int:
        with self._acct:
            return self._store_bytes

    @property
    def reserved_bytes(self) -> int:
        with self._acct:
            return self._reserved

    def install_spill_handler(self, device_store) -> SpillCallback:
        self.spill_callback = SpillCallback(device_store)
        return self.spill_callback

    def try_reserve(self, nbytes: int) -> bool:
        """Fast-path reservation: succeeds only when the projection fits
        the budget WITHOUT spilling (the retry harness brackets the
        spilling `reserve()` path with a semaphore yield, so the
        no-pressure case must not pay that release/reacquire)."""
        with self._acct:
            if self._store_bytes + self._reserved + nbytes <= self.budget:
                self._reserved += nbytes
                return True
        return False

    def reserve(self, nbytes: int) -> bool:
        """Pre-admission check before materializing `nbytes` on device.
        Spills preemptively under pressure.  Returns False only when even
        spilling everything cannot make room (caller may still proceed and
        let the allocator raise — accounting is advisory, like RMM
        retries)."""
        with self._acct:
            projected = self._store_bytes + self._reserved + nbytes
            if projected <= self.budget:
                self._reserved += nbytes
                return True
            reserved = self._reserved
        if self.spill_callback is not None:
            ok = self.spill_callback.on_alloc_pressure(
                nbytes, self.budget, reserved)
            with self._acct:
                self._reserved += nbytes
            return ok
        with self._acct:
            self._reserved += nbytes
        return False

    def release_reservation(self, nbytes: int) -> None:
        with self._acct:
            self._reserved = max(0, self._reserved - nbytes)

    # -- admission ledger (query-lifetime budget commitments) -----------------
    def try_admit(self, query_id: str, nbytes: int) -> bool:
        """Commit `nbytes` of the budget to `query_id` for its
        lifetime, iff the sum of admitted budgets still fits.  Unlike
        reserve(), admission never spills: a query that does not fit
        WAITS at the front door (or is shed) instead of evicting the
        working sets of queries already running."""
        with self._acct:
            if query_id in self._admitted:
                return True
            if sum(self._admitted.values()) + nbytes <= self.budget:
                self._admitted[query_id] = int(nbytes)
                return True
        return False

    def release_admission(self, query_id: str) -> None:
        with self._acct:
            self._admitted.pop(query_id, None)

    def admissions(self) -> dict[str, int]:
        """Copy of the admission ledger (query_id -> budget bytes)."""
        with self._acct:
            return dict(self._admitted)

    def admitted_bytes(self) -> int:
        with self._acct:
            return sum(self._admitted.values())

    def telemetry_gauges(self) -> dict:
        """One consistent HBM accounting snapshot for the telemetry
        registry: capacity, budget, the store-resident vs reserved
        split, the live total, the admission ledger, and — first-class
        instead of operator-derived — the live admission headroom
        (budget - store - reserved - sum of admitted budgets: what
        `try_admit` actually has left to give, negative when the
        running queries' real footprints outgrow their declarations)
        plus the store-byte underflow counter (utils/telemetry.py)."""
        with self._acct:
            admitted = sum(self._admitted.values())
            return {
                "hbm_total": self.hbm_total,
                "budget": self.budget,
                "store_bytes": self._store_bytes,
                "reserved_bytes": self._reserved,
                "in_use_bytes": self._store_bytes + self._reserved,
                "admitted_bytes": admitted,
                "admitted_queries": len(self._admitted),
                "admission_headroom_bytes": (
                    self.budget - self._store_bytes - self._reserved
                    - admitted),
                "store_bytes_underflow": self._underflows,
            }

    def snapshot(self) -> dict:
        """The gauge set plus the per-query admission detail — the
        one-call accounting view diagnostics (watchdog dumps, the
        profile_query --memory report) print."""
        gauges = self.telemetry_gauges()
        with self._acct:
            gauges["admissions"] = dict(self._admitted)
        return gauges
