"""Milliseconds a request waited in the serving engine, from its ``submit``
to the close of its micro-batch: the mean of the engine's
``serving_queue_wait_ms`` histogram over the window (``stats()``). None
where the program keeps no such counter."""
from perfbench.lanes import on_card


def read(run):
    wait = run.stats.get("queue_wait_ms")
    return wait["mean"] if on_card(run) and wait else None
