"""Span tracer emitting Chrome-trace-event / Perfetto JSON.

One process-wide :data:`TRACER`, disabled by default. When disabled,
``span()`` returns a shared null context manager — the steady-state cost of
an instrumented call site is one attribute read and one identity return,
which is what lets the instrumentation live permanently in the hot paths
(pipeline scheduler, serving batcher) instead of behind copy-pasted
``if profiling:`` forks.

Event model (the subset of the trace-event format Perfetto's JSON importer
accepts):

* ``ph:"X"`` complete events — a named span with ``ts``/``dur`` (µs since
  tracer start), on the emitting thread's lane.
* ``ph:"M"`` metadata — ``thread_name`` per lane, emitted by
  :meth:`SpanTracer.set_lane` from each instrumented thread ("main
  dispatch", "pipeline scheduler", "sampling worker 0", "serving batcher").
* ``ph:"b"``/``ph:"e"`` async events — cross-thread request spans keyed by
  ``id``; the serving engine opens one per request at submit and closes it
  at completion, so coalesced duplicates keep distinct request spans while
  sharing one batch/compute span.
* ``ph:"i"`` instants and ``ph:"C"`` counters — flush triggers, queue depth.

Spans optionally bridge into ``torch.profiler.record_function`` so the same
names appear as user annotations in a ``torch.profiler`` trace, above the
CUDA kernels launched under them. A span never synchronizes the device: it
times host work only (the enqueue of whatever it launches), as kernels run
asynchronously. ``record_function`` costs a little even with no profiler
active, so the bridge can be switched off (``enable(profiler_annotations=
False)``) where only the host timeline is wanted.

Thread safety: events go into a plain list via ``list.append`` (GIL-atomic);
lane registration takes a lock (rare). ``max_events`` caps memory — on
overflow the tracer drops further events and flags ``truncated`` in the
written file rather than growing without bound.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

from torch.profiler import record_function

__all__ = ["SpanTracer", "TRACER", "validate_trace"]

_NULL = contextlib.nullcontext()


class _Span:
    """Context manager recording one ph:"X" event on the current lane."""

    __slots__ = ("tracer", "name", "args", "t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self._ann = None

    def __enter__(self):
        if self.tracer.profiler_annotations:
            ann = record_function(self.name)
            ann.__enter__()
            self._ann = ann
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr = self.tracer
        ev = {"name": self.name, "ph": "X", "pid": tr.pid,
              "tid": tr.lane_tid(),
              "ts": (self.t0 - tr.epoch) * 1e6,
              "dur": (t1 - self.t0) * 1e6, "cat": "repro"}
        if self.args:
            ev["args"] = self.args
        tr._emit(ev)
        return False


class SpanTracer:
    """Process-wide span recorder. ``enable()`` before the run, ``write()``
    after; everything between is near-free when disabled."""

    def __init__(self, max_events: int = 2_000_000):
        self.enabled = False
        self.profiler_annotations = False
        self.pid = 1
        self.epoch = time.perf_counter()
        self.max_events = max_events
        self.truncated = False
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._lanes: Dict[int, int] = {}  # thread ident -> tid
        self._lane_names: Dict[int, str] = {}  # thread ident -> lane name
        self._next_tid = itertools.count(1)
        self._next_async = itertools.count(1)

    # ------------------------------------------------------------ lifecycle
    def enable(self, *, profiler_annotations: bool = True,
               max_events: Optional[int] = None) -> None:
        self.epoch = time.perf_counter()
        self.truncated = False
        self._events = []
        if max_events is not None:
            self.max_events = max_events
        self.profiler_annotations = profiler_annotations
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # ----------------------------------------------------------------- lanes
    def set_lane(self, name: str) -> None:
        """Name the calling thread's lane (ph:"M" thread_name). Works even
        while the tracer is disabled — long-lived threads (the serving
        batcher, the pipeline scheduler) register once at thread start and
        keep their name across later ``enable()`` calls; the latest name per
        thread wins."""
        ident = threading.get_ident()
        with self._lock:
            tid = self._lanes.get(ident)
            if tid is None:
                tid = next(self._next_tid)
                self._lanes[ident] = tid
            self._lane_names[ident] = name

    def lane_tid(self) -> int:
        ident = threading.get_ident()
        tid = self._lanes.get(ident)
        if tid is None:
            with self._lock:
                tid = self._lanes.get(ident)
                if tid is None:
                    tid = next(self._next_tid)
                    self._lanes[ident] = tid
        return tid

    # ---------------------------------------------------------------- events
    def _emit(self, ev: dict) -> None:
        if len(self._events) >= self.max_events:
            self.truncated = True
            return
        self._events.append(ev)  # GIL-atomic

    def span(self, name: str, **args):
        """Context manager for a named span on the calling thread's lane.
        Returns a shared null context when tracing is off (the fast path)."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self.pid,
              "tid": self.lane_tid(),
              "ts": (time.perf_counter() - self.epoch) * 1e6, "cat": "repro"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, **values) -> None:
        """ph:"C" counter track (queue depth, batch occupancy over time)."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C", "pid": self.pid,
                    "tid": self.lane_tid(),
                    "ts": (time.perf_counter() - self.epoch) * 1e6,
                    "cat": "repro", "args": values})

    # Async (ph b/e) spans: cross-thread, keyed by id. Used for per-request
    # serving spans — begin on the client thread at submit, end on whichever
    # thread completes the future.
    def next_id(self) -> int:
        return next(self._next_async)

    def async_begin(self, name: str, span_id: int, **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "b", "id": span_id, "pid": self.pid,
              "tid": self.lane_tid(),
              "ts": (time.perf_counter() - self.epoch) * 1e6, "cat": "request"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_end(self, name: str, span_id: int, **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "e", "id": span_id, "pid": self.pid,
              "tid": self.lane_tid(),
              "ts": (time.perf_counter() - self.epoch) * 1e6, "cat": "request"}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ---------------------------------------------------------------- output
    def events(self) -> List[dict]:
        with self._lock:
            meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid, "args": {"name": self._lane_names[ident]}}
                    for ident, tid in sorted(self._lanes.items(),
                                             key=lambda kv: kv[1])
                    if ident in self._lane_names]
        return meta + self._events

    def to_json(self) -> Dict[str, Any]:
        obj: Dict[str, Any] = {"traceEvents": self.events(),
                               "displayTimeUnit": "ms"}
        if self.truncated:
            obj["otherData"] = {"truncated": True}
        return obj

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


#: The process-wide tracer all instrumented call sites share.
TRACER = SpanTracer()


_REQUIRED = {"X": ("name", "ph", "ts", "dur", "pid", "tid"),
             "M": ("name", "ph", "pid", "tid", "args"),
             "i": ("name", "ph", "ts", "pid", "tid"),
             "C": ("name", "ph", "ts", "pid", "tid", "args"),
             "b": ("name", "ph", "ts", "id", "pid", "tid"),
             "e": ("name", "ph", "ts", "id", "pid", "tid")}


def validate_trace(obj: Any) -> Dict[str, Any]:
    """Validate a trace object against the trace-event rules Perfetto's JSON
    importer enforces; raise ``ValueError`` on violation, else return a
    summary (``lanes``, ``names``, per-phase ``counts``, async balance).

    Checks: top-level ``traceEvents`` list; every event has the required
    keys for its phase with numeric ``ts``/``dur`` (``dur >= 0``);
    ``thread_name`` metadata carries ``args.name``; ``b``/``e`` events
    balance per (cat, id) with begin-before-end; JSON-serializability.
    """
    if isinstance(obj, str):
        obj = json.loads(obj)
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    events = obj["traceEvents"]
    json.dumps(events)  # everything must serialize
    lanes: Dict[int, str] = {}
    names = set()
    counts: Dict[str, int] = {}
    open_async: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        req = _REQUIRED.get(ph)
        if req is None:
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        for k in req:
            if k not in ev:
                raise ValueError(f"event {i} (ph={ph}): missing key {k!r}")
        counts[ph] = counts.get(ph, 0) + 1
        if ph == "M":
            if ev["name"] == "thread_name":
                tname = ev.get("args", {}).get("name")
                if not isinstance(tname, str) or not tname:
                    raise ValueError(f"event {i}: thread_name without a name")
                lanes[ev["tid"]] = tname
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)):
            raise ValueError(f"event {i}: non-numeric ts {ts!r}")
        if ph == "X":
            dur = ev["dur"]
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        names.add(ev["name"])
        if ph == "b":
            key = (ev.get("cat"), ev["id"], ev["name"])
            open_async[key] = open_async.get(key, 0) + 1
        elif ph == "e":
            key = (ev.get("cat"), ev["id"], ev["name"])
            n = open_async.get(key, 0)
            if n <= 0:
                raise ValueError(f"event {i}: async end without begin ({key})")
            open_async[key] = n - 1
    dangling = {k: v for k, v in open_async.items() if v}
    if dangling:
        raise ValueError(f"unbalanced async spans: {dangling}")
    return {"n_events": len(events), "lanes": sorted(lanes.values()),
            "names": sorted(names), "counts": counts}
