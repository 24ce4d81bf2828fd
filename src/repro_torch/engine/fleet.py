"""Multi-tenant serving: several loaded artifacts behind one front door —
the port of the reference's ``repro/engine/fleet.py``.

A production host rarely serves one model.  :class:`FleetServer` hosts
N tenants — each a loaded :class:`~engine.session.InferenceSession`
behind its own :class:`~engine.serving.AsyncServer` (per-model
queue, its own supervision/retry/shed machinery, per-tenant stats) —
under three shared resources on one device (``device``, default "cuda"):

* **one schedule database** — every tenant's measured winners merge into
  a single :class:`~core.local_search.ScheduleDatabase` on
  ``add_model`` and all sessions are re-pointed at it, so a workload
  tuned for one tenant is free for every other (the fleet analog of the
  artifact's zero-search load path);
* **one memory budget** — bound parameters are the resident cost of a
  specialization (their bytes on the device); the fleet accounts
  ``session.memory_bytes()`` per
  (tenant, bucket) and evicts least-recently-*used* specializations
  (``session.release``) when the total passes ``memory_budget_bytes``.
  Eviction trades latency, never correctness or availability: the next
  request for an evicted bucket re-specializes on demand behind the
  session lock (zero schedule searches — the shared db still holds the
  workloads), so no request is ever dropped by memory pressure.  Frozen
  sessions cannot re-specialize, so their buckets are *pinned*: they
  count against the budget but are never evicted (load such tenants
  with source-packed artifacts if you want them evictable).
* **one front door** — ``submit(model, x, ...)`` routes by tenant name
  (typed :class:`UnknownModelError` for a name not hosted), and
  ``stats()`` / ``health()`` aggregate per-tenant telemetry for probes.

Tenants come and go without a restart: ``add_model`` starts serving a
new artifact (rolled back cleanly if its pinned footprint cannot fit the
budget), ``remove_model(drain=True)`` completes a tenant's queued work
before unhosting it.

Deterministic tests construct with ``autostart=False`` and a fake
clock, then pump :meth:`step` by hand — the same discipline as
``AsyncServer``.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.local_search import ScheduleDatabase
from repro_torch.engine.serving import (AsyncServer, BatchPolicy,
                                        DynamicBatchPolicy, ServingError,
                                        ServingStats, nearest_bucket)
from repro_torch.engine.supervision import RetryPolicy
from repro_torch.engine.traffic import DEFAULT_PRIORITY

__all__ = [
    "FleetServer",
    "UnknownModelError",
    "DuplicateModelError",
    "MemoryBudgetError",
]


class UnknownModelError(ServingError, KeyError):
    """submit()/remove_model() named a tenant this fleet does not host."""


class DuplicateModelError(ServingError, ValueError):
    """add_model() reused a tenant name already hosted."""


class MemoryBudgetError(ServingError):
    """The tenant's un-evictable footprint cannot fit the fleet's memory
    budget even after evicting everything evictable."""


class _Tenant:
    __slots__ = ("name", "session", "server")

    def __init__(self, name: str, session, server: AsyncServer) -> None:
        self.name = name
        self.session = session
        self.server = server


class FleetServer:
    """One front door over per-tenant :class:`AsyncServer` instances,
    sharing a schedule database and an LRU memory budget.  See the
    module docs for the resource-sharing contract.  ``device`` is where an
    artifact path given to :meth:`add_model` loads."""

    def __init__(self, *, memory_budget_bytes: Optional[int] = None,
                 max_queue: int = 128, workers: int = 1,
                 retry: Optional[RetryPolicy] = None,
                 shed: str = "newest",
                 watchdog_ms: Optional[float] = None,
                 priority_default: str = DEFAULT_PRIORITY,
                 clock: Callable[[], float] = time.monotonic,
                 autostart: bool = True, device="cuda") -> None:
        if memory_budget_bytes is not None and memory_budget_bytes <= 0:
            raise ValueError("memory_budget_bytes must be positive "
                             f"(or None for unbounded), got "
                             f"{memory_budget_bytes}")
        self.memory_budget_bytes = memory_budget_bytes
        self.db = ScheduleDatabase()
        self.device = device
        self._defaults = dict(max_queue=max_queue, workers=workers,
                              retry=retry, shed=shed,
                              watchdog_ms=watchdog_ms,
                              priority_default=priority_default)
        self._clock = clock
        self._autostart = autostart
        self._tenants: Dict[str, _Tenant] = {}
        # LRU over (tenant, bucket) -> resident bytes; most recently used
        # at the right end (OrderedDict.move_to_end)
        self._lru: "collections.OrderedDict[tuple, int]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self.n_evictions = 0
        self._closed = False

    # -- tenant lifecycle ----------------------------------------------------
    def add_model(self, name: str, model, *,
                  policy: Optional[BatchPolicy] = None,
                  **server_kw) -> AsyncServer:
        """Host an artifact (path) or an in-memory session under
        ``name`` and start serving it.  The session's schedule db merges
        into the fleet's shared db; the session's resident
        specializations are accounted against the memory budget (typed
        :class:`MemoryBudgetError` — and a clean rollback — if its
        pinned footprint cannot fit).  ``server_kw`` overrides the
        fleet-level AsyncServer defaults for this tenant."""
        from repro_torch.engine.session import InferenceSession

        if isinstance(model, (str, bytes)) or hasattr(model, "__fspath__"):
            session = InferenceSession.load(model, device=self.device)
        else:
            session = model
        with self._lock:
            if self._closed:
                raise ServingError("fleet is closed")
            if name in self._tenants:
                raise DuplicateModelError(
                    f"tenant {name!r} is already hosted; remove_model it "
                    "first or pick another name")
            self.db.merge(session.db)
            session.db = self.db          # tuned once, shared fleet-wide
            kw = dict(self._defaults)
            kw.update(server_kw)
            server = AsyncServer(session, policy or DynamicBatchPolicy(),
                                 clock=self._clock,
                                 autostart=self._autostart, **kw)
            tenant = _Tenant(name, session, server)
            self._tenants[name] = tenant
            self._account_locked(name)
            try:
                self._enforce_budget_locked()
            except MemoryBudgetError:
                # rollback: the fleet must stay exactly as it was
                del self._tenants[name]
                for key in [k for k in self._lru if k[0] == name]:
                    del self._lru[key]
                server.close(drain=False)
                raise
            return server

    def remove_model(self, name: str, drain: bool = True) -> None:
        """Unhost a tenant.  ``drain=True`` completes its queued work
        first; ``drain=False`` fails queued requests typed."""
        with self._lock:
            tenant = self._tenants.pop(name, None)
            if tenant is None:
                raise UnknownModelError(f"no tenant named {name!r} "
                                        f"(hosting {sorted(self._tenants)})")
            for key in [k for k in self._lru if k[0] == name]:
                del self._lru[key]
        tenant.server.close(drain=drain)

    @property
    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def _tenant(self, model: str) -> _Tenant:
        with self._lock:
            tenant = self._tenants.get(model)
            if tenant is None:
                raise UnknownModelError(
                    f"no tenant named {model!r} "
                    f"(hosting {sorted(self._tenants)})")
            return tenant

    # -- serving -------------------------------------------------------------
    def submit(self, model: str, x, deadline_ms: Optional[float] = None,
               priority: Optional[str] = None) -> Future:
        """Route one request to a tenant's queue.  Raises the tenant
        server's typed errors plus :class:`UnknownModelError`."""
        tenant = self._tenant(model)
        fut = tenant.server.submit(x, deadline_ms=deadline_ms,
                                   priority=priority)
        self._touch(tenant, rows=rows_of(x))
        return fut

    def predict(self, model: str, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None,
                priority: Optional[str] = None):
        return self.submit(model, x, deadline_ms=deadline_ms,
                           priority=priority).result(timeout)

    def step(self, model: Optional[str] = None) -> bool:
        """Manual pump (autostart=False fleets): execute at most one
        ready batch per tenant (or just ``model``'s).  Returns True iff
        any batch ran."""
        if model is not None:
            servers = [self._tenant(model).server]
        else:
            with self._lock:
                servers = [t.server for t in self._tenants.values()]
        ran = False
        for server in servers:
            ran = server.step() or ran
        if ran:
            self._sync_memory()
        return ran

    # -- memory budget -------------------------------------------------------
    def _touch(self, tenant: _Tenant, rows: int) -> None:
        """Mark the bucket this request will execute through as
        recently used, then re-enforce the budget (new specializations a
        worker bound since the last call get accounted here too)."""
        policy = tenant.server.policy
        bucket = getattr(policy, "fixed_bucket", None)
        if bucket is None:
            bucket = nearest_bucket(rows, tenant.session.batch_sizes)
        if bucket is None:
            bucket = rows               # will specialize on demand
        with self._lock:
            key = (tenant.name, bucket)
            if key in self._lru:
                self._lru.move_to_end(key)
        self._sync_memory()

    def _sync_memory(self) -> None:
        with self._lock:
            for name in list(self._tenants):
                self._account_locked(name)
            self._enforce_budget_locked(strict=False)

    def _account_locked(self, name: str) -> None:
        """Reconcile the LRU ledger with a tenant session's actual
        resident specializations: new buckets enter most-recently-used,
        released ones leave, sizes refresh in place."""
        tenant = self._tenants[name]
        resident = tenant.session.memory_bytes()
        for key in [k for k in self._lru
                    if k[0] == name and k[1] not in resident]:
            del self._lru[key]
        for bucket, nbytes in resident.items():
            key = (name, bucket)
            if key in self._lru:
                self._lru[key] = nbytes       # keep its recency slot
            else:
                self._lru[key] = nbytes
                self._lru.move_to_end(key)

    def _enforce_budget_locked(self, strict: bool = True) -> None:
        """Evict least-recently-used *evictable* specializations until
        the total fits the budget.  Frozen sessions' buckets are pinned
        (release would strand them).  ``strict=True`` (add_model) raises
        :class:`MemoryBudgetError` when the pinned remainder still
        exceeds the budget; the serving path uses ``strict=False`` —
        over-budget pinned tenants degrade to a warning-free best effort
        rather than failing live traffic."""
        if self.memory_budget_bytes is None:
            return
        total = sum(self._lru.values())
        if total <= self.memory_budget_bytes:
            return
        for key in list(self._lru):           # LRU order: oldest first
            if total <= self.memory_budget_bytes:
                break
            name, bucket = key
            tenant = self._tenants.get(name)
            if tenant is None or tenant.session.frozen:
                continue                      # pinned
            if len(tenant.session.batch_sizes) <= 1:
                continue        # keep a tenant's last bucket executable
            if tenant.session.release(bucket):
                total -= self._lru.pop(key)
                self.n_evictions += 1
        if strict and total > self.memory_budget_bytes:
            raise MemoryBudgetError(
                f"pinned specializations hold {total} bytes, over the "
                f"{self.memory_budget_bytes}-byte budget, and nothing "
                "more is evictable (frozen tenants' buckets are pinned)")

    def memory_bytes(self) -> Dict[str, Dict[int, int]]:
        """Resident bound-param bytes per tenant per bucket."""
        with self._lock:
            return {name: t.session.memory_bytes()
                    for name, t in sorted(self._tenants.items())}

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, ServingStats]:
        """Per-tenant ``ServingStats`` snapshots (detached copies)."""
        with self._lock:
            tenants = list(self._tenants.values())
        return {t.name: t.server.stats for t in tenants}

    def health(self) -> dict:
        """Fleet-level probe: shared-resource state plus each tenant's
        full ``AsyncServer.health()`` (which carries its telemetry)."""
        with self._lock:
            tenants = list(self._tenants.values())
            mem_total = sum(self._lru.values())
        return {
            "tenants": {t.name: t.server.health() for t in tenants},
            "memory": {
                "budget_bytes": self.memory_budget_bytes,
                "resident_bytes": mem_total,
                "n_evictions": self.n_evictions,
            },
            "shared_db_entries": len(self.db),
            "closed": self._closed,
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Close every tenant server (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            tenants = list(self._tenants.values())
        for t in tenants:
            t.server.close(drain=drain)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))


def rows_of(x) -> int:
    """Leading-dim rows of a numpy array, a tensor or any array-like,
    without a copy where it has a shape."""
    shape = getattr(x, "shape", None)
    if shape is None:
        shape = np.asarray(x).shape
    return int(shape[0])
