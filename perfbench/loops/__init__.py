"""Load generators, one module each, found by the name a traffic mix gives
under ``loop``: ``perfbench/loops/<loop>.py`` with

    run(submit, feed, mix, seconds=0.0, requests=0) -> Window

which drives ``submit(pool_index) -> Future`` for ``seconds`` of host time
(or until ``requests`` have been sent, when given) and takes the next
index from ``feed`` (``traffic.Feed``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Served:
    index: int                 # pool index
    t_submit: float
    t_done: float
    result: Optional[Dict]     # the served answer, None when it failed
    error: Optional[str] = None


@dataclasses.dataclass
class Window:
    t0: float
    t1: float                  # the window's close
    served: List[Served]       # every request sent in the window, in order of answer
    unanswered: int            # still in flight after the grace period

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def in_window(self) -> List[Served]:
        return [s for s in self.served if s.t_done <= self.t1 and s.result is not None]
