"""Closed-loop load generation and offline-oracle replay for the serving
engine.

* **closed loop** — a fixed number of in-flight requests (``concurrency``);
  a new request is submitted only when one completes. Measures the maximum
  sustainable throughput of the engine (the classic closed-system probe).

Workloads are deterministic (seeded sampler), so a warmup pass followed by a
replay sees identical micro-batch compositions.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.patterns import QueryInstance
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
    results: List[Dict]        # per-request result dicts, submission order
    wall_s: float
    qps: float
    latency_ms: Dict[str, float]

    def describe(self) -> str:
        l = self.latency_ms
        return (f"[closed] {len(self.results)} requests in "
                f"{self.wall_s:.2f}s = {self.qps:.0f} q/s | "
                f"latency p50 {l['p50']:.1f} ms, p95 {l['p95']:.1f} ms, "
                f"p99 {l['p99']:.1f} ms")


def run_closed_loop(engine, queries: Sequence[QueryInstance],
                    concurrency: int = 32, timeout: float = 120.0) -> LoadReport:
    """Keep ``concurrency`` requests in flight until the workload drains."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    results: List[Optional[Dict]] = [None] * len(queries)
    window: deque = deque()
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        while len(window) >= concurrency:
            j, f = window.popleft()
            results[j] = f.result(timeout=timeout)
        window.append((i, engine.submit(q)))
    while window:
        j, f = window.popleft()
        results[j] = f.result(timeout=timeout)
    wall = time.perf_counter() - t0
    return LoadReport(
        results=results, wall_s=wall,
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
