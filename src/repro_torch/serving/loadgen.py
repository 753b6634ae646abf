"""Closed- and open-loop load generation, multi-tenant mixes and
offline-oracle replay for the serving engine (or a ``Router``, which takes
the same ``submit``).

* **closed loop** — a fixed number of in-flight requests (``concurrency``);
  a new request is submitted only when one completes. Measures the maximum
  sustainable throughput of the engine (the classic closed-system probe).
* **open loop** — requests arrive on a fixed schedule (``qps``; 0 = burst,
  i.e. submit as fast as admission allows). Measures latency UNDER a given
  offered load, including queueing. Arrival pacing never waits for
  completions, so a saturated engine shows up as growing p99.
* **tenant mix** — one paced open-loop submitter thread per tenant through
  a router, reporting completions, typed sheds and latency per tenant.

Workloads are deterministic (seeded sampler), so a warmup pass followed by a
replay sees identical micro-batch compositions.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.patterns import QueryInstance
from repro_torch.obs.trace import TRACER
from repro_torch.sampling.online import OnlineSampler


def make_workload(kg, n: int, seed: int = 11,
                  patterns: Optional[Sequence[str]] = None) -> List[QueryInstance]:
    """Deterministic mixed-pattern request stream (same seed ⇒ same queries,
    and the same queries as the JAX package's ``make_workload``)."""
    sampler = (OnlineSampler(kg, patterns=patterns, seed=seed)
               if patterns is not None else OnlineSampler(kg, seed=seed))
    return [s.query for s in sampler.sample_batch(n)]


def latency_summary(lat_ms: Sequence[float]) -> Dict[str, float]:
    lat = np.asarray(lat_ms, dtype=np.float64)
    if len(lat) == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(lat.mean()), "n": int(len(lat))}


@dataclasses.dataclass
class LoadReport:
    mode: str                  # closed | open
    results: List[Dict]        # per-request result dicts, submission order
    wall_s: float
    qps: float
    latency_ms: Dict[str, float]
    # Open loop only: the arrival rate the generator ACTUALLY offered —
    # submissions / submit-phase wall time, pacing slip included.
    offered_qps: float = 0.0

    def describe(self) -> str:
        l = self.latency_ms
        offered = (f" (offered {self.offered_qps:.0f} q/s)"
                   if self.mode == "open" else "")
        return (f"[{self.mode}] {len(self.results)} requests in "
                f"{self.wall_s:.2f}s = {self.qps:.0f} q/s{offered} | "
                f"latency p50 {l['p50']:.1f} ms, p95 {l['p95']:.1f} ms, "
                f"p99 {l['p99']:.1f} ms")


def _closed_window(engine, queries, indices, results, concurrency, timeout,
                   lane: Optional[str] = None):
    """One submitter's closed window over its share of the workload."""
    if lane is not None:
        TRACER.set_lane(lane)
    window: deque = deque()
    for i in indices:
        while len(window) >= concurrency:
            j, f = window.popleft()
            results[j] = f.result(timeout=timeout)
        window.append((i, engine.submit(queries[i])))
    while window:
        j, f = window.popleft()
        results[j] = f.result(timeout=timeout)


def run_closed_loop(engine, queries: Sequence[QueryInstance],
                    concurrency: int = 32, timeout: float = 120.0,
                    threads: int = 1) -> LoadReport:
    """Keep ``concurrency`` requests in flight until the workload drains.

    ``threads > 1`` splits the workload round-robin over that many client
    threads, each keeping its share of the window in flight — a
    multi-client probe, and one "client N" trace lane a submitter.
    ``threads=1`` runs one submitter on the calling thread ("client 0")."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    if threads < 1:
        raise ValueError("threads must be >= 1")
    results: List[Optional[Dict]] = [None] * len(queries)
    t0 = time.perf_counter()
    if threads == 1:
        TRACER.set_lane("client 0")
        _closed_window(engine, queries, range(len(queries)), results,
                       concurrency, timeout)
    else:
        per = max(concurrency // threads, 1)
        ts = [threading.Thread(
                  target=_closed_window,
                  args=(engine, queries, range(w, len(queries), threads),
                        results, per, timeout, f"client {w}"),
                  daemon=True)
              for w in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    wall = time.perf_counter() - t0
    return LoadReport(
        mode="closed", results=results, wall_s=wall,
        qps=len(queries) / max(wall, 1e-9),
        latency_ms=latency_summary([r["latency_ms"] for r in results]))


def check_against_offline(batch_log, serve_fn) -> int:
    """Replay recorded engine micro-batches (``ServingEngine`` with
    ``record_batches=True``) through an offline oracle and demand EXACT
    per-request equality of top-k ids and scores — the engine⇔``serve_batch``
    bit-identity contract. ``serve_fn(queries) -> results`` is typically a
    ``launch/serve.py::serve_batch`` closure. Returns the number of requests
    checked."""
    checked = 0
    for rec in batch_log:
        oracle = serve_fn(rec.queries)
        for got, want in zip(rec.results[: rec.n_real], oracle[: rec.n_real]):
            if got["top_entities"] != want["top_entities"]:
                raise AssertionError(
                    f"top-k id mismatch vs offline oracle ({got['pattern']}): "
                    f"{got['top_entities']} != {want['top_entities']}")
            if got["scores"] != want["scores"]:
                raise AssertionError(
                    f"top-k score mismatch vs offline oracle "
                    f"({got['pattern']}): {got['scores']} != {want['scores']}")
            checked += 1
    return checked


def run_open_loop(engine, queries: Sequence[QueryInstance], qps: float = 0.0,
                  timeout: float = 120.0) -> LoadReport:
    """Submit on a fixed arrival schedule (``qps``; 0 = burst) and then wait
    for every future. Submission never waits on completions — the bounded
    admission queue is the only brake (blocking ``submit`` = backpressure),
    so latency includes real queueing delay."""
    futures = []
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        if qps > 0:
            lag = t0 + i / qps - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        futures.append(engine.submit(q))
    # Offered rate = what the arrival process actually delivered over the
    # SUBMIT phase; qps below is the end-to-end rate over submit + drain.
    t_submitted = time.perf_counter()
    results = [f.result(timeout=timeout) for f in futures]
    wall = time.perf_counter() - t0
    return LoadReport(
        mode="open", results=results, wall_s=wall,
        qps=len(queries) / max(wall, 1e-9),
        latency_ms=latency_summary([r["latency_ms"] for r in results]),
        offered_qps=len(queries) / max(t_submitted - t0, 1e-9))


# ---------------------------------------------------------------------------
# Multi-tenant mixed-SLO workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantLoad:
    """One tenant's open-loop arrival process: ``qps=0`` floods (submits as
    fast as the router admits — the overload aggressor)."""

    tenant: str
    queries: List[QueryInstance]
    qps: float = 0.0


@dataclasses.dataclass
class TenantReport:
    tenant: str
    offered: int               # submit() calls attempted
    completed: int
    shed: int                  # typed ShedError admissions (never blocking)
    failures: int              # futures that resolved with a real error
    wall_s: float
    offered_qps: float
    latency_ms: Dict[str, float]
    # Distribution of individual submit() call durations: for a shed
    # (low-priority) tenant, the evidence that sheds never block.
    submit_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        l = self.latency_ms
        s = self.submit_ms or {"p99": 0.0}
        return (f"[tenant {self.tenant}] offered {self.offered} "
                f"({self.offered_qps:.0f} q/s), completed {self.completed}, "
                f"shed {self.shed}, failed {self.failures} | p50 "
                f"{l['p50']:.1f} ms, p99 {l['p99']:.1f} ms | submit p99 "
                f"{s['p99']:.2f} ms")


def _tenant_loop(router, load: TenantLoad, report_slot: Dict, timeout: float):
    from repro_torch.serving.router import ShedError

    TRACER.set_lane(f"tenant {load.tenant}")
    futures = []
    shed = 0
    submit_ms: List[float] = []
    t0 = time.perf_counter()
    for i, q in enumerate(load.queries):
        if load.qps > 0:
            lag = t0 + i / load.qps - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        ts = time.perf_counter()
        try:
            futures.append(router.submit(q, tenant=load.tenant))
        except ShedError:
            shed += 1
        submit_ms.append((time.perf_counter() - ts) * 1e3)
    t_submitted = time.perf_counter()
    lat, failures = [], 0
    for f in futures:
        try:
            lat.append(f.result(timeout=timeout)["latency_ms"])
        except Exception:
            failures += 1
    wall = time.perf_counter() - t0
    sub = latency_summary(submit_ms)
    sub["max"] = float(max(submit_ms)) if submit_ms else 0.0
    report_slot[load.tenant] = TenantReport(
        tenant=load.tenant, offered=len(load.queries), completed=len(lat),
        shed=shed, failures=failures, wall_s=wall,
        offered_qps=len(load.queries) / max(t_submitted - t0, 1e-9),
        latency_ms=latency_summary(lat), submit_ms=sub)


def run_tenant_mix(router, loads: Sequence[TenantLoad],
                   timeout: float = 120.0) -> Dict[str, TenantReport]:
    """Drive several tenants' arrival processes concurrently through one
    router (one paced submitter thread per tenant, as independent clients)
    and report per-tenant completion/shed/latency."""
    reports: Dict[str, TenantReport] = {}
    ts = [threading.Thread(target=_tenant_loop,
                           args=(router, load, reports, timeout), daemon=True)
          for load in loads]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return reports
