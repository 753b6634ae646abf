"""Replica lifecycle for the multi-replica serving tier.

A :class:`Replica` is one complete serving stack — its own
``PooledExecutor`` (schedule/encode caches + plan cache), its own optional
``MaterializedSubqueryCache`` (rows on the replica's device), and its own
``ServingEngine`` with a dedicated batcher thread — over SHARED read-only
params. Replication here is cache partitioning: schedules, plan entries,
materialized rows and encode closures are all topology-keyed, so a router
that sends each topology to one replica gives every replica a working set
that FITS its caches, where a single engine with the same per-replica budget
would thrash. Replicas on one card share it (and one interpreter's GIL):
their batcher threads launch on the default stream in turn.

The :class:`ReplicaPool` owns N replicas plus a ``membership_token`` the
router uses to invalidate its rendezvous memos on join/leave, and fans
``update_params`` out to every replica — each engine pins in-flight
requests to their admitted params version (``pin_params_on_admit``), so
the swap is bit-safe without draining the pool.

Replicas are dense-params only: the out-of-core ``sem_cache`` hot set is a
single shared device buffer that admitted-params replay cannot coexist
with (the engine rejects the combination), and live-graph attachment
(``kg=``) uses the same version axis — both stay on the single-engine
path.

Under a mesh ``ctx`` every rank builds the same replicas in the same order;
each replica's executor and engine run on the context (``params`` are the
rank's shards). Rank 0's replicas admit and batch; on the other ranks
``ReplicaPool.follow()`` serves rank 0's batches. All replicas of a mesh
share its one ``MeshLane``, so their batches take turns on one set of
process groups, in one order on every rank.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import dataclasses

from repro_torch.core.executor import PooledExecutor
from repro_torch.core.matcache import MaterializedSubqueryCache
from repro_torch.device import resolve_device
from repro_torch.serving.engine import ServingConfig, ServingEngine


def _device(device, ctx):
    """``device``, else the mesh rank's device, else ``cuda``."""
    if device is None and ctx is not None and ctx.is_sharded:
        return ctx.device
    return resolve_device(device)


class Replica:
    """One serving replica: engine + private executor/cache stack."""

    def __init__(self, rid: int, model, params,
                 cfg: Optional[ServingConfig] = None,
                 mat_budget_rows: int = 0, b_max: int = 256, device=None,
                 started: bool = True, ctx=None, plan_cache_size: int = 512):
        self.rid = int(rid)
        cfg = cfg or ServingConfig()
        # The swap contract is per-replica: requests complete on the params
        # they were admitted under even while the pool swaps underneath.
        cfg = dataclasses.replace(cfg, pin_params_on_admit=True)
        device = _device(device, ctx)
        self.mat_cache = (MaterializedSubqueryCache(
            mat_budget_rows, name=f"replica{self.rid}")
            if mat_budget_rows > 0 else None)
        self.executor = PooledExecutor(model, b_max=b_max, device=device, ctx=ctx,
                                       plan_cache_size=plan_cache_size)
        self.engine = ServingEngine(
            model, params, executor=self.executor, cfg=cfg, device=device,
            mat_cache=self.mat_cache, started=started,
            obs_labels={"replica": str(self.rid)},
            name=f"replica {self.rid}", ctx=ctx)

    # Thin pass-throughs: the router talks to replicas, not engines.
    def submit(self, query, top_k=None, timeout=None):
        return self.engine.submit(query, top_k=top_k, timeout=timeout)

    def submit_many(self, queries, top_k=None, timeout=None):
        return self.engine.submit_many(queries, top_k=top_k, timeout=timeout)

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def update_params(self, params) -> None:
        self.engine.update_params(params)

    def retraces(self) -> int:
        return self.engine.retraces()

    def reset_counters(self, clear_log: bool = True) -> None:
        self.engine.reset_counters(clear_log=clear_log)

    def stats(self) -> Dict:
        return self.engine.stats()

    def start(self) -> None:
        self.engine.start()

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        self.engine.close(drain=drain, timeout=timeout)


class ReplicaPool:
    """N replicas over one shared read-only model/params.

    ``membership_token`` bumps on every join/leave; the router memoizes its
    rendezvous rankings against it, so membership changes remap topologies
    (at most ~1/N of them — the rendezvous property) without any explicit
    invalidation call.
    """

    def __init__(self, model, params, n_replicas: int = 1,
                 cfg: Optional[ServingConfig] = None,
                 mat_budget_rows: int = 0, b_max: int = 256, device=None,
                 started: bool = True, ctx=None, plan_cache_size: int = 512):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.model = model
        self.params = params
        self._cfg = cfg or ServingConfig()
        self._mat_budget_rows = mat_budget_rows
        self._b_max = b_max
        self._device = _device(device, ctx)
        self._ctx = ctx
        self._plan_cache_size = plan_cache_size
        self._lock = threading.Lock()
        self._next_rid = 0
        self._replicas: Dict[int, Replica] = {}
        self.membership_token = 0
        for _ in range(n_replicas):
            self.add_replica(started=started)

    def _make(self, rid: int, started: bool) -> Replica:
        return Replica(rid, self.model, self.params, cfg=self._cfg,
                       mat_budget_rows=self._mat_budget_rows,
                       b_max=self._b_max, device=self._device,
                       started=started, ctx=self._ctx,
                       plan_cache_size=self._plan_cache_size)

    def add_replica(self, started: bool = True) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._replicas[rid] = self._make(rid, started)
            self.membership_token += 1
        return rid

    def remove_replica(self, rid: int, drain: bool = True) -> None:
        with self._lock:
            rep = self._replicas.pop(rid)
            self.membership_token += 1
        rep.close(drain=drain)

    def replicas(self) -> Dict[int, Replica]:
        """Point-in-time member snapshot (copy — safe to iterate while
        membership changes)."""
        with self._lock:
            return dict(self._replicas)

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    def update_params(self, params) -> None:
        """Hot model swap, pool-wide and without draining: each engine swaps
        under its own lock, bumps its params version and mat-cache stamp, and
        keeps serving in-flight requests on their ADMITTED params snapshot.
        New replicas added after the swap start on the new params. Under a
        mesh it is collective: every rank calls it with its own shards, in
        the same order (a rank other than 0 may call it before it follows);
        each replica engine's swap lands at one point of the lane."""
        with self._lock:
            self.params = params
            reps = list(self._replicas.values())
        for rep in reps:
            rep.update_params(params)

    def follow(self) -> int:
        """A rank other than 0 under a mesh: serve rank 0's batches for every
        replica until rank 0's pool closes. The replicas share one lane, so
        any one engine follows for all (``ServingEngine.follow``)."""
        reps = list(self.replicas().values())
        if not reps:
            raise RuntimeError("follow() on an empty pool")
        return reps[0].engine.follow()

    def retraces(self) -> Dict[int, int]:
        return {rid: rep.retraces() for rid, rep in self.replicas().items()}

    def reset_counters(self, clear_log: bool = True) -> None:
        for rep in self.replicas().values():
            rep.reset_counters(clear_log=clear_log)

    def stats(self) -> Dict:
        per = {rid: rep.stats() for rid, rep in self.replicas().items()}
        return {
            "replicas": len(per),
            "membership_token": self.membership_token,
            "per_replica": per,
            "submitted": sum(s["submitted"] for s in per.values()),
            "completed": sum(s["completed"] for s in per.values()),
            "failures": sum(s["failures"] for s in per.values()),
        }

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        for rep in self.replicas().values():
            rep.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
