"""The program's spans on the lanes that the harness does not hand to the
metric readers: the card's time a phase, which the serving engine puts as
``<phase>.device`` spans on its lane "<engine> device" of the program's
tracer (``repro_torch.obs.trace.TRACER``). Read after the window: the
tracer keeps its events when disabled. A program that records no such
lane, and a run on the CPU, have none to read.

The readers of the engine's spans and counters from inside a batch
(``plan``, ``respond``, ``gc``, the queue wait and the device lane) report
only in a run traced on a card (``on_card``), so a traced run on the CPU
keeps the metric set that ``tests/test_perfbench_harness.py`` holds it to.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

LANE_SUFFIX = " device"


def on_card(run) -> bool:
    """Whether the run holds the card's trace: every traced run on a card."""
    return run.trace is not None


def mean_device_ms(run, name: str) -> Optional[float]:
    """The mean duration in ms of the program's spans ``name`` on its device
    lanes, in the last trace its tracer recorded; None without the card's
    trace or without such spans."""
    if not on_card(run):
        return None
    from repro_torch.obs.trace import TRACER
    events = TRACER.events()
    lanes = {e["tid"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
             and e.get("args", {}).get("name", "").endswith(LANE_SUFFIX)}
    d = [e["dur"] * 1e-3 for e in events
         if e.get("ph") == "X" and e.get("name") == name and e.get("tid") in lanes]
    return float(np.mean(d)) if d else None
