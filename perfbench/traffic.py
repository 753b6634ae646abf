"""The one traffic generator: a pool of distinct queries made from the seed
by the frozen sampler, and a seeded replay order over it.

A mix file (``perfbench/traffic/<mix>.json``) gives its parameters:

* ``patterns``: relative weight of each query pattern. The pool holds each
  pattern's share of ``pool`` queries exactly (largest remainders), so every
  seed serves the same set of sizes, in another order and with other
  anchors and relations;
* ``pool``: distinct queries made in set-up;
* ``system``: the system under test, ``perfbench/systems/<system>.py``,
  which takes its settings from the mix: the serving engine takes every
  ``ServingConfig`` field given here, such as ``max_batch`` and
  ``max_wait_ms``;
* ``loop``: the load generator, ``perfbench/loops/<loop>.py``, with its
  parameters: ``clients``, the requests a closed loop keeps in flight;
* ``top_k``: the answers a request asks for, which the check reads;
* ``warmup_requests``: requests served in set-up before the window;
* ``check_requests``: answered requests that the reference checks.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List

import numpy as np

from perfbench.sampler import TEMPLATES, OnlineSampler, Query

REQUIRED = ("patterns", "pool", "system", "loop", "clients", "top_k", "warmup_requests",
            "check_requests")


def check_mix(mix: dict) -> dict:
    missing = [k for k in REQUIRED if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    unknown = [p for p in mix["patterns"] if p not in TEMPLATES]
    if unknown:
        raise ValueError(f"traffic mix names unknown patterns {unknown}")
    if mix["pool"] < 2 * mix["clients"]:
        raise ValueError("the pool must hold at least twice the clients")
    return mix


def pattern_counts(weights: Dict[str, float], total: int) -> Dict[str, int]:
    """``total`` split by ``weights`` with the largest remainders rounded up
    (ties to the earlier pattern)."""
    names = list(weights)
    w = np.array([float(weights[n]) for n in names])
    exact = w / w.sum() * total
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: total - counts.sum()]:
        counts[i] += 1
    return dict(zip(names, counts.tolist()))


def make_pool(graph, mix: dict, seed: int) -> List[Query]:
    """``mix['pool']`` distinct queries in a seeded order of patterns."""
    counts = pattern_counts(mix["patterns"], mix["pool"])
    rng = np.random.default_rng([seed, 1])
    order = np.repeat(np.array(list(counts)), list(counts.values()))
    rng.shuffle(order)
    sampler = OnlineSampler(graph, seed=seed)
    seen, pool = set(), []
    for pattern in order.tolist():
        for _ in range(64):
            q = sampler.sample(pattern)
            if q not in seen:
                break
        else:
            raise RuntimeError(f"no distinct {pattern} query in 64 draws")
        seen.add(q)
        pool.append(q)
    return pool


def replay(n: int, seed: int) -> Iterator[int]:
    """Pool indices forever: one seeded permutation after another."""
    rng = np.random.default_rng([seed, 2])
    while True:
        yield from rng.permutation(n).tolist()


class Feed:
    """The next pool index to submit, never one already in flight: an index
    met while in flight waits, and goes out first once it has landed."""

    def __init__(self, n: int, seed: int):
        self._order = replay(n, seed)
        self._waiting: deque = deque()
        self.in_flight: set = set()

    def next(self) -> int:
        for _ in range(len(self._waiting)):
            i = self._waiting.popleft()
            if i not in self.in_flight:
                self.in_flight.add(i)
                return i
            self._waiting.append(i)
        while True:
            i = next(self._order)
            if i not in self.in_flight:
                self.in_flight.add(i)
                return i
            self._waiting.append(i)

    def landed(self, i: int) -> None:
        self.in_flight.discard(i)
