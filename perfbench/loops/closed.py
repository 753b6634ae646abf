"""The closed loop: ``mix['clients']`` requests in flight, each client
sending its next request as soon as its last one is answered.

The loop keeps no thread of its own. A client's next request is sent from
the done-callback of its last one, in the thread that resolves that future
(the serving engine's batcher), so the benchmark adds no second Python
thread that would contend with the system under test for the interpreter's
lock and wake across cores on every answer. The calling thread sends the
first requests, then sleeps until the window has closed and the requests in
flight have landed.

What the loop keeps of an answer is held in plain tuples of numbers, which
the collector stops tracking: the benchmark's record of some 60,000
answers would otherwise lengthen every full collection the program's own
objects pay for.

Each request is timed on the client side, from just before its ``submit``
call to the start of its done-callback. The window is a span of host time:
the requests answered inside it make the rate and the latency tail; a
request answered after it closes counts as attempted and not answered in
the window. After the close no request is sent; those in flight are waited
for, up to ``grace_s``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List

from perfbench.loops import Served, Window


def run(submit: Callable, feed, mix: dict, seconds: float = 0.0,
        requests: int = 0, grace_s: float = 60.0) -> Window:
    lock = threading.RLock()
    served: List[Served] = []
    landed_all = threading.Event()
    st = {"sent": 0, "in_flight": 0, "closed": False, "over": False}
    t0 = time.perf_counter()
    t1 = t0 + seconds

    def is_open() -> bool:
        if not st["closed"]:
            st["closed"] = (st["sent"] >= requests if requests
                            else time.perf_counter() >= t1)
        return not st["closed"]

    def send() -> None:          # under the lock
        i = feed.next()
        t = time.perf_counter()
        try:
            fut = submit(i)
        except Exception as e:   # a refused request fails; its client stops
            feed.landed(i)
            served.append((i, t, time.perf_counter(), None, repr(e)))
            return
        st["sent"] += 1
        st["in_flight"] += 1
        fut.add_done_callback(lambda f, i=i, t=t: landed(i, t, f))

    def landed(i: int, t_sub: float, fut) -> None:
        t_done = time.perf_counter()
        with lock:
            if st["over"]:
                return
            st["in_flight"] -= 1
            feed.landed(i)
            exc = fut.exception()
            served.append((i, t_sub, t_done, None if exc else _kept(fut.result()),
                           None if exc is None else repr(exc)))
            if is_open():
                send()
            if st["closed"] and not st["in_flight"]:
                landed_all.set()

    with lock:
        for _ in range(mix["clients"]):
            if is_open():
                send()
        if not st["in_flight"]:
            landed_all.set()
    closed_at = None
    while not landed_all.wait(0.5):
        with lock:
            is_open()
            if st["closed"] and not st["in_flight"]:
                break
            if st["closed"] and closed_at is None:
                closed_at = time.perf_counter()
            if closed_at is not None and time.perf_counter() - closed_at >= grace_s:
                break
    with lock:
        st["over"] = True
        if requests:
            t1 = time.perf_counter()
        return Window(t0, t1, [Served(i, a, b, _answer(r), e) for i, a, b, r, e in served],
                      st["in_flight"])


KEYS = ("top_entities", "scores")


def _kept(result):
    """An answer's ids and scores as tuples; any other shape as it came."""
    if isinstance(result, dict) and all(isinstance(result.get(k), list) for k in KEYS):
        return tuple(tuple(result[k]) for k in KEYS)
    return result


def _answer(kept):
    if isinstance(kept, tuple):
        return {k: list(v) for k, v in zip(KEYS, kept)}
    return kept
