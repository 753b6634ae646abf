"""Process-wide metrics registry.

The substrate under every counter the serving slice keeps (cache hit/miss
counts, executor sharing totals, engine request counters and the latency
window):

* **Metric primitives** — ``Counter`` (int-like, so ``self.hits += 1`` call
  sites read naturally), ``Gauge`` (last-set value: queue depth, batch
  occupancy) and ``Histogram`` (bounded observation window + lifetime
  count/sum: request latency). All carry a name and a label tuple
  (``cache="schedule"``), so many instances of one component aggregate
  cleanly in a snapshot.
* **Lock-free fast path** — ``Counter.inc``/``Gauge.set``/``Histogram.
  observe`` take no registry lock; call sites that need exactness hold their
  component's lock. The registry lock is touched only at metric creation and
  snapshot time.
* **Snapshot / delta / reset** — ``snapshot()`` aggregates every live
  metric by ``name{labels}`` key; ``delta(before)`` subtracts the summable
  keys; ``reset()`` zeroes every counter and histogram in the process and
  then runs the hooks registered with ``on_reset`` (the serving engine
  re-baselines its derived deltas there).
* **Weak registration** — the registry holds weakrefs, to metrics and to
  reset hooks. Components own their metrics (via a ``MetricGroup``); when an
  engine is garbage-collected its metrics and its hook leave with it.
"""
from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricGroup", "MetricsRegistry",
           "get_registry"]


def _val(x):
    return x._v if isinstance(x, Counter) else x


class Counter:
    """An int-like accumulator: ``c += 1`` and ``c.inc()`` bump it in place;
    comparisons against numbers or other counters read its value."""

    kind = "counter"
    __slots__ = ("name", "labels", "_v", "__weakref__")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._v = 0

    def inc(self, n=1) -> None:
        self._v += n

    def __iadd__(self, n):
        self._v += n
        return self

    def __isub__(self, n):
        self._v -= n
        return self

    @property
    def value(self):
        return self._v

    def read(self):
        return self._v

    def reset(self) -> None:
        self._v = 0

    def __int__(self):
        return int(self._v)

    def __index__(self):
        return int(self._v)

    def __float__(self):
        return float(self._v)

    def __bool__(self):
        return bool(self._v)

    def __eq__(self, other):
        return self._v == _val(other)

    def __lt__(self, other):
        return self._v < _val(other)

    def __le__(self, other):
        return self._v <= _val(other)

    def __gt__(self, other):
        return self._v > _val(other)

    def __ge__(self, other):
        return self._v >= _val(other)

    def __add__(self, other):
        return self._v + _val(other)

    def __radd__(self, other):
        return _val(other) + self._v

    def __sub__(self, other):
        return self._v - _val(other)

    def __rsub__(self, other):
        return _val(other) - self._v

    def __truediv__(self, other):
        return self._v / _val(other)

    def __rtruediv__(self, other):
        return _val(other) / self._v

    def __mul__(self, other):
        return self._v * _val(other)

    __rmul__ = __mul__
    __hash__ = None  # mutable: never a dict key

    def __repr__(self):
        return f"Counter({metric_key(self)}={self._v})"


class Gauge(Counter):
    """Current-state value (queue depth, occupancy). ``reset()`` is a no-op:
    zeroing a gauge would fabricate a state the system is not in."""

    kind = "gauge"
    __slots__ = ()

    def set(self, v) -> None:
        self._v = v

    def reset(self) -> None:
        pass

    def __repr__(self):
        return f"Gauge({metric_key(self)}={self._v})"


class Histogram:
    """Bounded observation window + lifetime count/sum. The window serves
    percentiles; the lifetime count/sum serve rates and means."""

    kind = "histogram"
    __slots__ = ("name", "labels", "window", "_win", "_count", "_sum",
                 "__weakref__")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 window: int = 8192):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name = name
        self.labels = labels
        self.window = window
        self._win: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0

    def observe(self, v) -> None:
        self._win.append(v)
        self._count += 1
        self._sum += v

    def __len__(self):
        return len(self._win)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def window_values(self) -> List[float]:
        return list(self._win)

    def summary(self) -> Dict[str, float]:
        win = np.asarray(self._win, dtype=np.float64)
        out = {"count": int(self._count), "sum": float(self._sum),
               "mean": float(self._sum / self._count) if self._count else 0.0,
               "window_n": int(len(win)), "window": int(self.window)}
        if len(win):
            p50, p95, p99 = np.percentile(win, [50, 95, 99])
            out.update(p50=float(p50), p95=float(p95), p99=float(p99),
                       max=float(win.max()))
        else:
            out.update(p50=0.0, p95=0.0, p99=0.0, max=0.0)
        return out

    def reset(self) -> None:
        self._win.clear()
        self._count = 0
        self._sum = 0.0

    def __repr__(self):
        return f"Histogram({metric_key(self)} n={self._count})"


def metric_key(m) -> str:
    """Stable flat key: ``name`` or ``name{k=v,...}`` (sorted labels)."""
    if not m.labels:
        return m.name
    inner = ",".join(f"{k}={v}" for k, v in sorted(m.labels))
    return f"{m.name}{{{inner}}}"


class MetricGroup:
    """One component's metrics: a shared name prefix + label set. The
    component holds the group (strong refs); the registry holds weakrefs."""

    def __init__(self, registry: "MetricsRegistry", prefix: str, **labels):
        self._registry = registry
        self.prefix = prefix
        self.labels = tuple(sorted((k, str(v)) for k, v in labels.items()))
        self._metrics: List = []

    def _add(self, m):
        self._metrics.append(m)
        self._registry.register(m)
        return m

    def _labels(self, labels) -> Tuple[Tuple[str, str], ...]:
        return self.labels + tuple(sorted((k, str(v)) for k, v in labels.items()))

    def counter(self, name: str, **labels) -> Counter:
        return self._add(Counter(f"{self.prefix}_{name}", self._labels(labels)))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._add(Gauge(f"{self.prefix}_{name}", self._labels(labels)))

    def histogram(self, name: str, window: int = 8192, **labels) -> Histogram:
        return self._add(Histogram(f"{self.prefix}_{name}",
                                   self._labels(labels), window=window))

    def reset(self, only: Optional[Iterable] = None) -> None:
        """Zero this group's counters/histograms (gauges keep state); with
        ``only``, just those metric objects."""
        for m in (self._metrics if only is None else only):
            m.reset()

    def metrics(self) -> List:
        return list(self._metrics)


class MetricsRegistry:
    """Weak collection of every live metric in the process + reset hooks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: List[weakref.ref] = []
        self._hooks: List = []  # weakref.ref / weakref.WeakMethod

    def group(self, prefix: str, **labels) -> MetricGroup:
        return MetricGroup(self, prefix, **labels)

    def register(self, metric) -> None:
        with self._lock:
            self._metrics.append(weakref.ref(metric))

    def on_reset(self, fn) -> None:
        """Register a callback run after every registry-wide ``reset()``,
        held weakly: a dead component's hook disappears with it."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            self._hooks.append(ref)

    def metrics(self) -> List:
        """Live metrics (dead weakrefs pruned as a side effect)."""
        with self._lock:
            live = [m for m in (r() for r in self._metrics) if m is not None]
            self._metrics = [weakref.ref(m) for m in live]
        return live

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{key: number}`` view of every live metric, aggregated by
        key: counters and gauges sum across same-key instances; histograms
        emit ``_count``/``_sum`` plus window percentiles."""
        out: Dict[str, float] = {}
        windows: Dict[str, list] = {}
        for m in self.metrics():
            key = metric_key(m)
            if m.kind == "histogram":
                out[key + "_count"] = out.get(key + "_count", 0) + m.count
                out[key + "_sum"] = out.get(key + "_sum", 0.0) + m.sum
                windows.setdefault(key, []).extend(m.window_values())
            else:
                out[key] = out.get(key, 0) + m.read()
        for key, win in windows.items():
            if win:
                p50, p95, p99 = np.percentile(np.asarray(win, np.float64),
                                              [50, 95, 99])
                out.update({key + "_p50": float(p50), key + "_p95": float(p95),
                            key + "_p99": float(p99)})
            out[key + "_window_n"] = len(win)
        return out

    def delta(self, before: Dict[str, float]) -> Dict[str, float]:
        """Current snapshot minus ``before`` for subtractable keys (counters,
        gauges, histogram counts/sums); percentiles and window sizes pass
        through as they are now."""
        out = {}
        for k, v in self.snapshot().items():
            if k.endswith(("_p50", "_p95", "_p99", "_window_n")):
                out[k] = v
            else:
                out[k] = v - before.get(k, 0)
        return out

    def reset(self) -> None:
        """Zero EVERY counter and histogram in the process (gauges keep
        their state), then run the reset hooks."""
        for m in self.metrics():
            m.reset()
        with self._lock:
            live = [(r, r()) for r in self._hooks]
            self._hooks = [r for r, fn in live if fn is not None]
        for _, fn in live:
            if fn is not None:
                fn()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every component registers into."""
    return _REGISTRY
