# The paper's primary contribution: operator-level batched execution.
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.compiler import PlanCache, build_plan, compile_batch, plan_to_dag
from repro_torch.core.executor import PooledExecutor, QueryLevelExecutor
from repro_torch.core.matcache import MaterializedSubqueryCache
from repro_torch.core.ops import OpType
from repro_torch.core.plan import CompiledPlan, PlanGraph, PlanNode, SharingReport
from repro_torch.core.patterns import (
    EVAL_PATTERNS,
    NEGATION_PATTERNS,
    PATTERN_NAMES,
    TEMPLATES,
    QueryInstance,
    answer_query,
)
from repro_torch.core.querydag import BatchedDAG, build_batched_dag
from repro_torch.core.scheduler import ExecutionSchedule, PoolStep, schedule

__all__ = [
    "OpType",
    "TEMPLATES",
    "PATTERN_NAMES",
    "NEGATION_PATTERNS",
    "EVAL_PATTERNS",
    "QueryInstance",
    "answer_query",
    "BatchedDAG",
    "build_batched_dag",
    "ExecutionSchedule",
    "PoolStep",
    "schedule",
    "PooledExecutor",
    "MaterializedSubqueryCache",
    "QueryLevelExecutor",
    "CompiledPlan",
    "PlanGraph",
    "PlanNode",
    "SharingReport",
    "build_plan",
    "compile_batch",
    "plan_to_dag",
    "CompileCache",
    "PlanCache",
]
