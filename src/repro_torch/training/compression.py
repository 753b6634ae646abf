"""Int8 gradient compression with error feedback for slow (inter-pod) links.

Quantize → all-reduce(int32) → dequantize, with a persistent error-feedback
accumulator so compression noise is re-injected next step instead of lost
(convergence-neutral in expectation). Intended for the ``pod`` mesh axis,
whose links are the collective bottleneck at multi-pod scale. The JAX
package's formula, over a ``torch.distributed`` process group."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): ``round(x / scale)`` clipped to ±127 as int8, rounding
    half to even as ``jnp.round`` does, and the fp32 scale max|x| / 127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grad: torch.Tensor, group, error: torch.Tensor):
    """Returns (mean-reduced grad, new error feedback) over ``group`` (a
    process group; None is the default group). Collective.

    The int8 payload is reduced as int32 (4x smaller than fp32 on a wire
    that carried int8); scales are reduced separately (a MAX). Error feedback
    keeps the quantization residual local."""
    g = grad + error
    q, scale = quantize_int8(g)
    local = dequantize_int8(q, scale)
    new_error = g - local
    # Reduce the quantized values at int32 precision, then rescale by the
    # max scale across the group (conservative; avoids per-peer scale exchange).
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    max_scale = scale.clone()
    dist.all_reduce(max_scale, op=dist.ReduceOp.MAX, group=group)
    n = float(dist.get_world_size(group))
    return summed.to(torch.float32) * max_scale / n, new_error


def compressed_tree_psum(grads: Mapping[str, torch.Tensor], group,
                         errors: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """``compressed_psum`` of every name, in sorted-name order (the
    reference's pytree order), so every rank issues the same sequence."""
    outs, new_errs = {}, {}
    for k in sorted(grads):
        outs[k], new_errs[k] = compressed_psum(grads[k], group, errors[k])
    return outs, new_errs
