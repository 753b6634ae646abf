"""Unified telemetry: metrics registry, span tracer, JSONL sink.

    from repro_torch.obs import get_registry, TRACER, MetricsSink
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram, MetricGroup,
                                      MetricsRegistry, get_registry)
from repro_torch.obs.sink import MetricsSink, read_jsonl
from repro_torch.obs.trace import TRACER, SpanTracer, validate_trace

__all__ = ["Counter", "Gauge", "Histogram", "MetricGroup", "MetricsRegistry",
           "get_registry", "MetricsSink", "read_jsonl", "TRACER",
           "SpanTracer", "validate_trace"]
