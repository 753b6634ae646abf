"""Metrics registry (counters, gauges, the latency histogram)."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricGroup,
                                      MetricsRegistry, get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricGroup", "MetricsRegistry",
           "get_registry"]
