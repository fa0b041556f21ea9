"""Multi-tenant admission control and per-tenant serving statistics.

A serving replica fronts many independent tenants, each driving many coded
volumes; without admission control one tenant's burst starves everyone and
an unbounded queue turns overload into silent latency collapse.  This
module is the policy layer `launch.service.CodedService` enforces:

  * `TenantQuota` — per-tenant ceilings on in-flight operations and
    in-flight payload bytes, plus a fair-share `weight`.
  * `AdmissionController` — a single gate every submission passes before
    it may enter the coding queue.  Admission is bounded both globally
    (`max_ops` / `max_bytes` across all tenants) and per tenant (the
    quota); a submission that does not fit either *blocks* until capacity
    frees (bounded backpressure, optional timeout) or — with
    ``block=False`` — fails immediately with `QueueFullError`.  Nothing is
    ever silently dropped: every acquire either succeeds or raises.
  * `ServiceStats` — one tenant's (or one tag's) rolling serving counters:
    submitted / completed / failed / rejected ops, in-flight gauges,
    coalescing group sizes, queue failovers, and a bounded latency
    reservoir answering p50/p99/p999.

Fair scheduling: when several tenants are *waiting* for admission, slots
are not granted in raw arrival order.  Waiters are granted per-tenant
FIFO, but across tenants the next grant goes to the eligible tenant with
the smallest weight-normalized in-flight load (``inflight_ops / weight``)
— a deficit-style weighted fair share, so a tenant that already holds
many slots cannot lock out a light tenant behind it, while arrival order
breaks ties deterministically.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass, field as dc_field


class QueueFullError(RuntimeError):
    """Admission refused: the request does not fit the tenant's quota or
    the service's global in-flight bounds (and the caller asked not to
    block, or its wait timed out).  Always loud — the service never
    silently drops a submission."""


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission ceilings.

    max_inflight_ops   — operations admitted but not yet resolved
    max_inflight_bytes — sum of admitted payload bytes in flight; one
                         oversized payload is still admitted when the
                         tenant has nothing in flight (it runs alone
                         rather than deadlocking)
    weight             — fair-share weight for contended admission: a
                         tenant with weight 2 is allowed twice the
                         in-flight load of a weight-1 tenant before it
                         loses grant priority
    """

    max_inflight_ops: int = 64
    max_inflight_bytes: int = 1 << 28
    weight: float = 1.0

    def __post_init__(self):
        if self.max_inflight_ops < 1:
            raise ValueError("max_inflight_ops must be >= 1")
        if self.max_inflight_bytes < 1:
            raise ValueError("max_inflight_bytes must be >= 1")
        if not self.weight > 0:
            raise ValueError("weight must be > 0")


@dataclass
class _Waiter:
    tenant: str
    nbytes: int
    seq: int
    granted: bool = False
    abandoned: bool = False


class AdmissionController:
    """Blocking/bounded admission gate over per-tenant + global budgets.

    `acquire(tenant, nbytes)` blocks until the op fits (or raises
    `QueueFullError` with ``block=False`` / on timeout); `release` frees
    the slot and wakes the fairest eligible waiter.  See the module
    docstring for the fairness rule.
    """

    def __init__(self, *, max_ops: int = 1024, max_bytes: int = 1 << 31,
                 default_quota: TenantQuota | None = None):
        if max_ops < 1 or max_bytes < 1:
            raise ValueError("global max_ops/max_bytes must be >= 1")
        self.max_ops = max_ops
        self.max_bytes = max_bytes
        self._default = default_quota or TenantQuota()
        self._quotas: dict[str, TenantQuota] = {}
        self._ops: dict[str, int] = {}
        self._bytes: dict[str, int] = {}
        self._total_ops = 0
        self._total_bytes = 0
        self._waiters: deque[_Waiter] = deque()
        self._seq = 0
        self._cv = threading.Condition()

    # -- quotas --------------------------------------------------------------
    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self._default)

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._cv:
            self._quotas[tenant] = quota
            self._grant_waiters()
            self._cv.notify_all()

    # -- introspection -------------------------------------------------------
    def inflight(self, tenant: str | None = None) -> tuple[int, int]:
        """(ops, bytes) currently admitted — for `tenant`, or globally."""
        with self._cv:
            if tenant is None:
                return self._total_ops, self._total_bytes
            return self._ops.get(tenant, 0), self._bytes.get(tenant, 0)

    @property
    def waiting(self) -> int:
        with self._cv:
            return sum(1 for w in self._waiters if not w.abandoned)

    # -- the gate ------------------------------------------------------------
    def _refusal(self, tenant: str, nbytes: int) -> str | None:
        """Why (tenant, nbytes) does not fit right now, or None if it
        does.  Byte budgets admit one oversized payload when the relevant
        byte ledger is empty — it runs alone instead of deadlocking."""
        q = self.quota(tenant)
        t_ops = self._ops.get(tenant, 0)
        t_bytes = self._bytes.get(tenant, 0)
        if self._total_ops >= self.max_ops:
            return (f"global in-flight ops at cap ({self.max_ops})")
        if t_ops >= q.max_inflight_ops:
            return (f"tenant {tenant!r} in-flight ops at quota "
                    f"({q.max_inflight_ops})")
        if self._total_bytes + nbytes > self.max_bytes and self._total_bytes:
            return (f"global in-flight bytes at cap ({self.max_bytes})")
        if t_bytes + nbytes > q.max_inflight_bytes and t_bytes:
            return (f"tenant {tenant!r} in-flight bytes at quota "
                    f"({q.max_inflight_bytes})")
        return None

    def _admit(self, tenant: str, nbytes: int) -> None:
        self._ops[tenant] = self._ops.get(tenant, 0) + 1
        self._bytes[tenant] = self._bytes.get(tenant, 0) + nbytes
        self._total_ops += 1
        self._total_bytes += nbytes

    def _grant_waiters(self) -> None:
        """Grant every waiter that now fits, fairest-first (must hold the
        lock).  Eligible set: the FIRST (FIFO) live waiter of each tenant
        that `_refusal` admits; among those, the grant goes to the tenant
        with the smallest weight-normalized in-flight ops, arrival order
        breaking ties."""
        while True:
            heads: dict[str, _Waiter] = {}
            for w in self._waiters:
                if not w.abandoned and not w.granted and w.tenant not in heads:
                    heads[w.tenant] = w
            eligible = [w for w in heads.values()
                        if self._refusal(w.tenant, w.nbytes) is None]
            if not eligible:
                return
            w = min(eligible, key=lambda w: (
                self._ops.get(w.tenant, 0) / self.quota(w.tenant).weight,
                w.seq))
            w.granted = True
            self._admit(w.tenant, w.nbytes)
            self._waiters.remove(w)

    def acquire(self, tenant: str, nbytes: int = 0, *, block: bool = True,
                timeout: float | None = None) -> None:
        """Admit one operation of `nbytes` payload for `tenant`.

        Blocks (bounded backpressure) until the op fits both the tenant's
        quota and the global caps; with ``block=False`` or an expired
        `timeout` raises `QueueFullError` instead.  Per-tenant FIFO: an op
        never jumps ahead of its own tenant's queued waiters.
        """
        with self._cv:
            has_waiters = any(w.tenant == tenant and not w.abandoned
                              for w in self._waiters)
            refusal = self._refusal(tenant, nbytes)
            if refusal is None and not has_waiters:
                self._admit(tenant, nbytes)
                return
            if not block:
                raise QueueFullError(
                    refusal or f"tenant {tenant!r} has queued waiters")
            waiter = _Waiter(tenant, nbytes, self._seq)
            self._seq += 1
            self._waiters.append(waiter)
            self._grant_waiters()
            if not self._cv.wait_for(lambda: waiter.granted, timeout):
                waiter.abandoned = True
                self._waiters.remove(waiter)
                raise QueueFullError(
                    f"admission wait for tenant {tenant!r} timed out after "
                    f"{timeout}s ({self._refusal(tenant, nbytes) or 'contended'})")

    def release(self, tenant: str, nbytes: int = 0) -> None:
        with self._cv:
            self._ops[tenant] = max(0, self._ops.get(tenant, 0) - 1)
            self._bytes[tenant] = max(0, self._bytes.get(tenant, 0) - nbytes)
            self._total_ops = max(0, self._total_ops - 1)
            self._total_bytes = max(0, self._total_bytes - nbytes)
            self._grant_waiters()
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# per-tenant / per-tag serving statistics
# ---------------------------------------------------------------------------

def percentile(xs, frac: float) -> float:
    """Nearest-rank percentile (frac in [0, 1]) of a sequence; NaN when
    empty.  p999 of a small sample is simply its max — honest, if noisy."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(frac * len(s)) - 1))]


@dataclass
class ServiceStats:
    """Rolling serving counters for one tenant (or one request tag).

    Mutated from submit threads, the queue worker, and future
    done-callbacks — every mutator takes the internal lock; `snapshot()`
    returns a plain immutable dict (percentiles computed on demand from a
    bounded latency reservoir of the most recent `reservoir` ops).
    """

    name: str
    reservoir: int = 65536
    submitted: int = 0
    completed: int = 0
    failed: int = 0       # futures that resolved with an exception
    rejected: int = 0     # admissions refused with QueueFullError
    failovers: int = 0    # ops replanned onto a superset erasure pattern
    inflight_ops: int = 0
    inflight_bytes: int = 0
    executed: int = 0      # ops with coalescing info (resolved by the queue)
    coalesced_ops: int = 0  # sum of batch group sizes over executed ops
    lat_recorded: int = 0  # latency samples ever recorded (incl. evicted)
    _lat_us: deque = dc_field(default_factory=deque, repr=False)
    _lock: threading.Lock = dc_field(default_factory=threading.Lock,
                                     repr=False)

    def __post_init__(self):
        # bounded reservoir: the deque trims itself (maxlen) instead of a
        # hand-rolled popleft loop on every record
        self._lat_us = deque(self._lat_us, maxlen=self.reservoir)

    def record_submitted(self, nbytes: int) -> None:
        with self._lock:
            self.submitted += 1
            self.inflight_ops += 1
            self.inflight_bytes += nbytes

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_executed(self, group_n: int, failover: bool) -> None:
        with self._lock:
            self.executed += 1
            self.coalesced_ops += max(1, int(group_n))
            if failover:
                self.failovers += 1

    def record_done(self, latency_us: float, nbytes: int, ok: bool) -> None:
        with self._lock:
            self.inflight_ops = max(0, self.inflight_ops - 1)
            self.inflight_bytes = max(0, self.inflight_bytes - nbytes)
            if ok:
                self.completed += 1
            else:
                self.failed += 1
            self._lat_us.append(latency_us)
            self.lat_recorded += 1

    @property
    def coalescing_ratio(self) -> float:
        """Mean batch group size over this name's executed ops — 1.0 means
        every op ran alone; >1 means cross-request (and, through the
        service's shared queue, cross-session) coalescing is working."""
        with self._lock:
            return (self.coalesced_ops / self.executed) if self.executed \
                else float("nan")

    def latencies_us(self) -> list[float]:
        with self._lock:
            return list(self._lat_us)

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._lat_us)
            out = {
                "name": self.name,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "failovers": self.failovers,
                "inflight_ops": self.inflight_ops,
                "inflight_bytes": self.inflight_bytes,
                "executed": self.executed,
                "coalescing_ratio": (self.coalesced_ops / self.executed
                                     if self.executed else float("nan")),
                # reservoir visibility: percentiles below cover only the
                # most recent `lat_samples`; `lat_dropped` older samples
                # were evicted (nonzero => truncated percentiles)
                "lat_samples": len(lat),
                "lat_dropped": self.lat_recorded - len(lat),
            }
        out["p50_us"] = percentile(lat, 0.50)
        out["p99_us"] = percentile(lat, 0.99)
        out["p999_us"] = percentile(lat, 0.999)
        return out
