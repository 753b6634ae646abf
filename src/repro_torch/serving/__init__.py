"""Continuous-batching serving subsystem."""
from repro_torch.serving.engine import (BatchRecord, CachedScorer,
                                        ServingConfig, ServingEngine,
                                        pad_to_bucket, scorer_for, topk_desc)
from repro_torch.serving.loadgen import (LoadReport, check_against_offline,
                                         latency_summary, make_workload,
                                         run_closed_loop)

__all__ = [
    "BatchRecord", "CachedScorer", "ServingConfig", "ServingEngine",
    "pad_to_bucket", "scorer_for", "topk_desc",
    "LoadReport", "check_against_offline", "latency_summary",
    "make_workload", "run_closed_loop",
]
