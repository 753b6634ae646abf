from repro_torch.distributed.context import (
    ExecutionContext,
    ProcessMesh,
    VirtualMesh,
    init_process_group_from_env,
    make_execution_context,
    parse_mesh_spec,
)
from repro_torch.distributed.pipeline_parallel import bubble_fraction, gpipe_forward
from repro_torch.distributed.sharding import (
    batch_specs,
    cache_spec,
    dp_axes,
    param_spec,
    param_specs,
)

__all__ = [
    "ExecutionContext",
    "ProcessMesh",
    "VirtualMesh",
    "init_process_group_from_env",
    "make_execution_context",
    "parse_mesh_spec",
    "param_spec",
    "param_specs",
    "batch_specs",
    "cache_spec",
    "dp_axes",
    "gpipe_forward",
    "bubble_fraction",
]
