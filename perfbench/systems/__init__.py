"""The systems under test, one module each, found by the name a traffic mix
gives under ``system``: ``perfbench/systems/<system>.py`` with

    build(cell, graph, weights, pool, device) -> a system

whose ``submit(pool_index) -> Future`` serves one query of the pool, and
``warm_up()``, ``reset_counters()``, ``stats() -> dict`` and ``close()``.
A system takes everything it is built from out of the cell's configuration
and mix, so a new deployment of the program comes in as files.
"""
