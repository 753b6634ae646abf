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
* one ``ph:"M"`` event ``clock_sync`` — a ``perf_counter_ns`` reading and a
  ``time.time_ns()`` reading taken back to back at ``enable()`` (the
  tightest of a few pairs). ``ts`` 0 is that ``perf_counter_ns`` reading,
  so a span's Unix time in ns is ``unix_ns + ts * 1e3``: the clock
  ``torch.profiler`` stamps its events in, so the file lines up with a
  profiler export.

The card's time a phase: a caller that launches on a CUDA device opens a
device window on its thread (``device_open``), marks the ends of its phases
on the device's current stream (``device_mark``: one CUDA event each) and
closes the window once a copy to the host has returned (``device_close``),
when the stream is idle, so an event recorded then reaches the card at its
host time. Each pair of consecutive marks becomes a complete span
``<phase>.device`` on a lane of its own, placed on the tracer's clock
backwards from that anchor by ``elapsed_time``. Spans are emitted once the
card has passed the anchor (checked with ``Event.query``, never by
waiting); a mark made on a thread with no open window is dropped.

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
from typing import Any, Dict, List, Optional, Tuple

import torch
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


def _clock_pair(reads: int = 5) -> Tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read back to back: of ``reads`` tries,
    the one whose two ``perf_counter_ns`` reads around ``time_ns`` lie
    closest, with their midpoint."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, unix)
    return best[1], best[2]


class _DeviceWindow:
    """One device window: the stream its device launches on, the CUDA events
    marking the ends of its phases there, in order, and the anchor recorded
    at its close."""

    __slots__ = ("tid", "gen", "stream", "marks", "anchor", "t_anchor")

    def __init__(self, tid: int, gen: int, stream):
        self.tid = tid
        self.gen = gen
        self.stream = stream
        self.marks: List[Tuple[str, Any]] = []
        self.anchor = None
        self.t_anchor = 0.0


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
        self._named_lanes: Dict[str, int] = {}  # lanes no thread owns -> tid
        self._next_tid = itertools.count(1)
        self._next_async = itertools.count(1)
        self.clock_sync: Optional[Tuple[int, int]] = None
        # Device windows: each thread's open one, and the closed ones whose
        # anchor the card has not passed yet. ``enable()`` bumps the
        # generation, so a window from before it is dropped.
        self._local = threading.local()
        self._gen = 0
        self._device_pending: List[_DeviceWindow] = []

    # ------------------------------------------------------------ lifecycle
    def enable(self, *, profiler_annotations: bool = True,
               max_events: Optional[int] = None) -> None:
        self.clock_sync = _clock_pair()
        self.epoch = self.clock_sync[0] * 1e-9
        self.truncated = False
        self._events = []
        with self._lock:
            self._gen += 1
            self._device_pending = []
            self._named_lanes = {}   # named again by the windows of this trace
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

    def named_lane(self, name: str) -> int:
        """The tid of a lane that no thread owns (the card's phases), named
        ``name``; the same tid for the same name."""
        tid = self._named_lanes.get(name)
        if tid is None:
            with self._lock:
                tid = self._named_lanes.get(name)
                if tid is None:
                    tid = self._named_lanes[name] = next(self._next_tid)
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

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """A ph:"X" span from two ``perf_counter()`` readings, on the calling
        thread's lane (for a span whose ends are not one block's)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "pid": self.pid, "tid": self.lane_tid(),
              "ts": (t0 - self.epoch) * 1e6, "dur": (t1 - t0) * 1e6, "cat": "repro"}
        if args:
            ev["args"] = args
        self._emit(ev)

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

    # ----------------------------------------------------- the card's phases
    def device_open(self, lane: str, device) -> None:
        """Open this thread's device window (module docstring) when the
        tracer is on and ``device`` is a CUDA device; its spans go on the
        lane named ``lane``. Replaces a window left open."""
        if not self.enabled or torch.device(device).type != "cuda":
            self._local.window = None
            return
        device = torch.device(device)
        self._local.window = _DeviceWindow(self.named_lane(lane), self._gen,
                                           torch.cuda.current_stream(device))

    def device_mark(self, phase: str) -> None:
        """A CUDA event where ``phase`` ends, on the stream of this thread's
        open window; dropped where none is open."""
        if not self.enabled:
            return
        w = getattr(self._local, "window", None)
        if w is None or w.gen != self._gen:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(w.stream)
        w.marks.append((phase, ev))

    def device_close(self) -> None:
        """Close this thread's window once a copy to the host has returned:
        record the anchor, then emit the spans of every closed window the
        card has passed."""
        w = getattr(self._local, "window", None)
        self._local.window = None
        if w is None or w.gen != self._gen or not self.enabled or len(w.marks) < 2:
            return
        w.anchor = torch.cuda.Event(enable_timing=True)
        # Read before the record: a delay after it (the thread preempted, a
        # profiler's callbacks) would place every phase late.
        w.t_anchor = time.perf_counter()
        w.anchor.record(w.stream)
        with self._lock:
            self._device_pending.append(w)
        self._emit_device()

    _PENDING_MAX = 64

    def _emit_device(self) -> None:
        with self._lock:
            if not self._device_pending:
                return
            ready = [w for w in self._device_pending if w.anchor.query()]
            # An anchor not passed after this many later windows never will be.
            self._device_pending = [w for w in self._device_pending
                                    if w not in ready][-self._PENDING_MAX:]
            gen = self._gen
        for w in ready:
            if w.gen != gen:
                continue
            at = [(phase, w.t_anchor - ev.elapsed_time(w.anchor) * 1e-3)
                  for phase, ev in w.marks]
            for (_, a), (phase, b) in zip(at, at[1:]):
                self._emit({"name": f"{phase}.device", "ph": "X", "pid": self.pid,
                            "tid": w.tid, "ts": (a - self.epoch) * 1e6,
                            "dur": max(b - a, 0.0) * 1e6, "cat": "device"})

    # ---------------------------------------------------------------- output
    def events(self) -> List[dict]:
        self._emit_device()
        with self._lock:
            lanes = [(tid, self._lane_names[ident]) for ident, tid in self._lanes.items()
                     if ident in self._lane_names]
            lanes += [(tid, name) for name, tid in self._named_lanes.items()]
        meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": tid, "args": {"name": name}} for tid, name in sorted(lanes)]
        if self.clock_sync is not None:
            meta.append({"name": "clock_sync", "ph": "M", "pid": self.pid, "tid": 0,
                         "args": {"perf_counter_ns": self.clock_sync[0],
                                  "unix_ns": self.clock_sync[1]}})
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
