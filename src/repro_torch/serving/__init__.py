"""Continuous-batching serving subsystem: the engine, live writes, load
generation, and the replica tier with its router."""
from repro_torch.serving.engine import (BatchRecord, CachedScorer,
                                        ServingConfig, ServingEngine,
                                        StaleVersionError, pad_to_bucket,
                                        scorer_for, topk_desc)
from repro_torch.serving.live import LiveNGDB, WriteReceipt, grow_entity_rows
from repro_torch.serving.loadgen import (LoadReport, TenantLoad, TenantReport,
                                         check_against_offline,
                                         latency_summary, make_workload,
                                         run_closed_loop, run_open_loop,
                                         run_tenant_mix)
from repro_torch.serving.replica import Replica, ReplicaPool
from repro_torch.serving.router import (Router, RouterConfig, ShedError,
                                        TenantSpec, query_topology_key,
                                        rendezvous_rank)

__all__ = [
    "BatchRecord", "CachedScorer", "ServingConfig", "ServingEngine",
    "StaleVersionError", "pad_to_bucket", "scorer_for", "topk_desc",
    "LiveNGDB", "WriteReceipt", "grow_entity_rows",
    "LoadReport", "TenantLoad", "TenantReport", "check_against_offline",
    "latency_summary", "make_workload", "run_closed_loop", "run_open_loop",
    "run_tenant_mix",
    "Replica", "ReplicaPool",
    "Router", "RouterConfig", "ShedError", "TenantSpec",
    "query_topology_key", "rendezvous_rank",
]
