"""Shuffle fault recovery: map recomputation driven by FetchFailed, peer
health and bounded stage retries (port of
spark_rapids_tpu/shuffle/recovery.py).

The reference's `RapidsShuffleIterator` turns transport failures into
Spark's `FetchFailedException`, so that the DAG scheduler invalidates the
lost map outputs and re-runs the producing stage.  This engine is its own
scheduler, so the loop lives here:

  * **ShuffleRecoveryDriver** wraps the reduce side of a manager-lane
    exchange.  A `FetchFailedError` invalidates the failed peer's entries
    in `MapOutputRegistry` (bumping the shuffle's epoch so stale
    registrations are refused), recomputes ONLY the lost map tasks from
    the exchange's retained lineage, and retries the read, at most
    spark.rapids.shuffle.recovery.maxStageAttempts times, then raises a
    descriptive `FetchFailedError`: never a hang, never a partial result.
  * **PeerHealth** blacklists a peer address after consecutive failures,
    with decay: a flapping peer is routed around (reads take the
    MapStatus's other address, map placement skips it) and rejoins once
    its entry decays.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.shuffle.client_server import FetchFailedError
from spark_rapids_tpu_torch.shuffle.manager import (MapOutputRegistry,
                                                    MapStatus,
                                                    StaleMapStatusError)
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import profile as P

log = logging.getLogger("spark_rapids_tpu_torch.shuffle.recovery")

#: injectable clock (tests advance it to exercise the blacklist's decay)
_now = time.monotonic


class PeerHealth:
    """Consecutive-failure blacklisting with decay (the role of Spark's
    excludeOnFailure for shuffle fetches), keyed by peer ADDRESS: one
    executor's loopback and TCP lanes are tracked apart, and recovery
    records a failure on both."""

    _GLOBAL: Optional["PeerHealth"] = None
    _global_lock = threading.Lock()

    @classmethod
    def get(cls) -> "PeerHealth":
        with cls._global_lock:
            if cls._GLOBAL is None:
                cls._GLOBAL = PeerHealth()
            return cls._GLOBAL

    def __init__(self):
        self._lock = threading.Lock()
        # addr -> [consecutive_failures, blacklisted_since or None]
        self._state: dict[str, list] = {}
        #: count of not-blacklisted -> blacklisted transitions
        self.blacklist_events = 0

    def _conf(self):
        c = C.get_active_conf()
        return (max(1, int(c[C.SHUFFLE_BLACKLIST_THRESHOLD])),
                float(c[C.SHUFFLE_BLACKLIST_DECAY_S]))

    def record_failure(self, address: str) -> bool:
        """Count a failure recovery attributes to `address`; True when it
        newly blacklisted the address."""
        threshold, _ = self._conf()
        with self._lock:
            st = self._state.setdefault(address, [0, None])
            st[0] += 1
            if st[1] is None and st[0] >= threshold:
                st[1] = _now()
                self.blacklist_events += 1
                log.warning("shuffle peer %s blacklisted after %d "
                            "consecutive failures", address, st[0])
                P.event(P.EV_PEER_BLACKLISTED, address=address,
                        consecutive_failures=st[0])
                return True
            return False

    def record_success(self, address: str) -> None:
        with self._lock:
            self._state.pop(address, None)

    def is_blacklisted(self, address: str) -> bool:
        _, decay = self._conf()
        with self._lock:
            st = self._state.get(address)
            if st is None or st[1] is None:
                return False
            if _now() - st[1] > decay:
                # decayed: the peer gets a fresh failure budget
                self._state.pop(address, None)
                return False
            return True

    def clear(self) -> None:
        with self._lock:
            self._state.clear()
            self.blacklist_events = 0


class ShuffleRecoveryDriver:
    """The reduce-side retry loop of one shuffle of one exchange.

    `recompute(lost_map_ids, epoch)` is the exchange's retained map-side
    lineage: it re-runs exactly those child partitions, splits them, and
    commits their outputs at `epoch` (a commit that races a further
    invalidation is refused as stale, and the next round re-derives what
    is missing)."""

    def __init__(self, manager, shuffle_id: int,
                 recompute: Callable[[list[int], int], None],
                 conf: Optional[C.RapidsConf] = None,
                 metrics: Optional[M.MetricSet] = None,
                 read_timeout: float = 30.0):
        self.manager = manager
        self.shuffle_id = shuffle_id
        self.recompute = recompute
        self.conf = conf or C.get_active_conf()
        self.metrics = metrics if metrics is not None else M.MetricSet()
        self.read_timeout = read_timeout
        self.max_attempts = max(
            1, int(self.conf[C.SHUFFLE_RECOVERY_MAX_STAGE_ATTEMPTS]))
        self.health = PeerHealth.get()
        # one recovery at a time per shuffle: concurrent readers funnel
        # their failures through here
        self._lock = threading.Lock()

    def read_partition(self, p: int) -> list:
        """One reduce partition, recovering from peer loss.  A LIST: a
        retried attempt restarts the partition, so nothing flows
        downstream before an attempt completes (no double counting)."""
        attempt = 1
        while True:
            epoch0 = MapOutputRegistry.epoch(self.shuffle_id)
            try:
                items = list(self.manager.get_reader(
                    self.shuffle_id, p, timeout=self.read_timeout,
                    with_map_ids=True, metrics=self.metrics))
                # map order: a recompute moves outputs between executors,
                # which would otherwise reorder the batches (local first)
                items.sort(key=lambda t: t[0])
                return [b for _, b in items]
            except FetchFailedError as e:
                self.metrics.add(M.NUM_FETCH_FAILURES, 1)
                P.event(P.EV_FETCH_FAILURE, shuffle_id=self.shuffle_id,
                        partition=p, address=e.address, attempt=attempt,
                        error=str(e)[:200])
                if attempt >= self.max_attempts:
                    P.event(P.EV_RECOVERY_EXHAUSTED,
                            shuffle_id=self.shuffle_id, partition=p,
                            attempts=attempt)
                    raise FetchFailedError(
                        e.address, e.block,
                        f"shuffle {self.shuffle_id} partition {p} still "
                        f"failing after {attempt} stage attempt(s) "
                        f"({C.SHUFFLE_RECOVERY_MAX_STAGE_ATTEMPTS.key}="
                        f"{self.max_attempts}): {e}") from e
                attempt += 1
                self._recover(e, epoch0)

    def _recover(self, e: FetchFailedError, epoch_seen: int) -> None:
        with self._lock:
            t0 = time.perf_counter_ns()
            try:
                if MapOutputRegistry.epoch(self.shuffle_id) != epoch_seen \
                        and not MapOutputRegistry.missing_maps(
                            self.shuffle_id):
                    # another reader recovered this loss while we waited
                    # on the lock: just read again
                    return
                lost = MapOutputRegistry.invalidate_address(
                    self.shuffle_id, e.address)
                if not lost and not MapOutputRegistry.missing_maps(
                        self.shuffle_id):
                    # no MapStatus advertises that address: invalidate
                    # every remote peer's outputs
                    lost = MapOutputRegistry.invalidate_others(
                        self.shuffle_id, self.manager.executor_id)
                by_exec: dict[str, set] = {}
                for st in lost.values():
                    by_exec.setdefault(st.executor_id, set()).update(
                        st.addresses())
                for _eid, addrs in by_exec.items():
                    flags = [self.health.record_failure(a)
                             for a in sorted(addrs)]
                    if any(flags):
                        self.metrics.add(M.NUM_PEERS_BLACKLISTED, 1)
                # a lost output with a replica on a surviving executor is
                # re-registered there: no recompute, no device work.
                # Lineage recompute is the fallback.
                promoted = self._promote_replicas(lost, set(by_exec))
                todo = sorted((set(lost) - promoted) | set(
                    MapOutputRegistry.missing_maps(self.shuffle_id)))
                if todo:
                    epoch = MapOutputRegistry.epoch(self.shuffle_id)
                    log.warning(
                        "shuffle %d recovery: recomputing map tasks %s at "
                        "epoch %d after %s", self.shuffle_id, todo, epoch,
                        e)
                    P.event(P.EV_MAP_RECOMPUTE, shuffle_id=self.shuffle_id,
                            map_ids=list(todo), epoch=epoch,
                            address=e.address)
                    try:
                        with P.span(f"map-recompute:s{self.shuffle_id}",
                                    cat=P.CAT_SHUFFLE) \
                                if P.tracer() is not None \
                                else P._NULL_SPAN:
                            self.recompute(todo, epoch)
                    except StaleMapStatusError as stale:
                        # a racing invalidation superseded the recompute;
                        # the next attempt re-derives the missing set
                        log.warning("shuffle %d recompute superseded: %s",
                                    self.shuffle_id, stale)
                    self.metrics.add(M.NUM_MAP_RECOMPUTES, len(todo))
                self.metrics.add(M.NUM_STAGE_RETRIES, 1)
                P.event(P.EV_STAGE_RETRY, shuffle_id=self.shuffle_id,
                        recomputed=len(todo))
            finally:
                self.metrics.add(M.RECOVERY_TIME,
                                 time.perf_counter_ns() - t0)

    def _promote_replicas(self, lost: dict, dead_execs: set) -> set:
        """Re-register each lost map output whose replica survives on a
        live executor; returns the promoted map ids.  The promoted status
        keeps the primary's partition sizes and the other replicas."""
        promoted: set = set()
        transport = self.manager.transport
        for map_id, st in sorted(lost.items()):
            pick = None
            for eid, addr, tcp in st.replicas:
                if eid in dead_execs:
                    continue
                if any(a and transport.can_reach(a)
                       and not self.health.is_blacklisted(a)
                       for a in (addr, tcp)):
                    pick = (eid, addr, tcp)
                    break
            if pick is None:
                continue
            eid, addr, tcp = pick
            survivors = [r for r in st.replicas
                         if r[0] != eid and r[0] not in dead_execs]
            new_st = MapStatus(eid, addr, list(st.partition_sizes),
                               tcp_address=tcp, replicas=survivors)
            try:
                MapOutputRegistry.register(self.shuffle_id, map_id, new_st)
            except StaleMapStatusError:
                continue  # a racing invalidation superseded us
            promoted.add(map_id)
            self.metrics.add(M.NUM_REPLICA_PROMOTIONS, 1)
            log.warning("shuffle %d recovery: promoted replica on %s for "
                        "map %d (no recompute)", self.shuffle_id, eid,
                        map_id)
            P.event(P.EV_REPLICA_PROMOTED, shuffle_id=self.shuffle_id,
                    map_id=map_id, replica_executor=eid)
        return promoted
