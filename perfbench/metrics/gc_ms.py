"""Milliseconds of garbage collection on the serving engine's batcher
thread a micro-batch: the ``gc`` spans on its lane over the ``batch`` spans
in the window. None where the program records no ``respond`` span: a
program that records those records the collections too, so there 0 means
that none ran."""
from perfbench.lanes import on_card


def read(run):
    names = [n for n, _, _ in run.spans]
    batches = names.count("batch")
    if not on_card(run) or not batches or "respond" not in names:
        return None
    return sum(b - a for n, a, b in run.spans if n == "gc") * 1e-6 / batches
