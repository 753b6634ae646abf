"""The traced window: ``torch.profiler`` over the card, reduced to device
intervals, and the program's host spans (``repro_torch.obs.trace.TRACER``)
put on the profiler's clock.

Device time is the union of the intervals of every kernel, copy and set on
the card, so work on overlapping streams counts once. A host time maps onto
the profiler's clock through an anchor: a ``record_function`` range opened
right after reading ``perf_counter_ns``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

ANCHOR = "perfbench.anchor"


@dataclasses.dataclass
class DeviceTrace:
    t0_ns: int                          # the window on the profiler's clock
    t1_ns: int
    ops: List[Tuple[str, int, int]]     # (name, start_ns, end_ns) on the card

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the ops' intervals, clipped to the window, sorted."""
        out: List[List[int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0_ns), min(b, self.t1_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def gaps(self) -> List[Tuple[int, int]]:
        """The window's idle intervals."""
        out, at = [], self.t0_ns
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = b
        if self.t1_ns > at:
            out.append((at, self.t1_ns))
        return out

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """name -> (launches, seconds) of the ops that started in the window."""
        out: Dict[str, List[float]] = {}
        for name, a, b in self.ops:
            if self.t0_ns <= a < self.t1_ns:
                e = out.setdefault(name, [0, 0.0])
                e[0] += 1
                e[1] += (b - a) * 1e-9
        return {k: (int(v[0]), v[1]) for k, v in out.items()}


class Profiler:
    """``torch.profiler`` from ``start()`` to ``stop()`` on a CUDA device."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._anchor_host_ns = 0
        self._t0_host_ns = self._t1_host_ns = 0

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof.start()
        self._anchor_host_ns = time.perf_counter_ns()
        with record_function(ANCHOR):
            pass
        self._t0_host_ns = time.perf_counter_ns()

    def stop(self) -> DeviceTrace:
        import torch
        torch.cuda.synchronize()
        self._t1_host_ns = time.perf_counter_ns()
        self._prof.stop()
        ops, anchor = [], None
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                ops.append((e.name(), int(e.start_ns()), int(e.end_ns())))
            elif anchor is None and e.name() == ANCHOR:
                anchor = int(e.start_ns())
        if anchor is None:
            raise RuntimeError("the profiler recorded no anchor range")
        self.offset_ns = anchor - self._anchor_host_ns
        return DeviceTrace(self._t0_host_ns + self.offset_ns,
                           self._t1_host_ns + self.offset_ns, ops)


def host_spans(events: Sequence[dict], epoch: float, lane_suffix: str = "batcher"
               ) -> List[Tuple[str, int, int]]:
    """The tracer's complete spans on the lanes whose name ends with
    ``lane_suffix``, as (name, start, end) in ``perf_counter_ns``."""
    lanes = {e["tid"] for e in events if e.get("ph") == "M"
             and e.get("args", {}).get("name", "").endswith(lane_suffix)}
    base = epoch * 1e9
    return [(e["name"], int(base + e["ts"] * 1e3), int(base + (e["ts"] + e["dur"]) * 1e3))
            for e in events if e.get("ph") == "X" and e["tid"] in lanes]


def idle_by_span(trace: DeviceTrace, spans: Sequence[Tuple[str, int, int]],
                 offset_ns: int) -> Dict[str, float]:
    """Idle seconds of the card by the innermost host span open at each
    idle interval's midpoint ("between batches" where none is)."""
    shifted = sorted((a + offset_ns, b + offset_ns, name) for name, a, b in spans)
    starts = [s for s, _, _ in shifted]
    out: Dict[str, float] = {}
    for a, b in trace.gaps():
        mid = (a + b) // 2
        best: Optional[Tuple[int, str]] = None
        # One lane's spans nest, so those open at mid are among the last few
        # that started before it.
        hi = bisect.bisect_right(starts, mid)
        for s, e, name in shifted[max(hi - 8, 0):hi]:
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        key = best[1] if best else "between batches"
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out
