"""Mixture-of-Experts FFN with sort-based pool dispatch, as the JAX package's
``lm/moe.py`` computes it on one device.

Token→expert dispatch is operator-pool batching at the layer level: experts
are operator types, tokens are ready operators, and the capacity factor is
the pool's fill limit (overflowing tokens are dropped). Packing sorts the
(token, slot) pairs by expert and builds the dense [E, C, D] pools by gather;
the combine walks the token-major (T, k) layout back.

Routing picks and drops exactly the reference's: ``jax.lax.top_k`` puts the
lower expert index first on a tie and the packing's argsort is stable, so
the port takes its top-k from a stable descending sort and packs by a stable
argsort (``torch.topk`` promises no order among ties).

The mesh branches (``shard_map`` over the model axis, tp and ep layouts)
come with slice 10b: ``moe_ffn`` given a mesh raises.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.lm.modules import silu


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, descending, the
    lower index first among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pack_by_expert(x, expert_idx, gates, n_experts: int, capacity: int):
    """Sort-based pool packing. x [T, D]; expert_idx/gates [T, k].

    Returns (packed [E, C, D], combine metadata). Overflow beyond capacity is
    dropped, in the order of a stable sort of the expert ids."""
    T, k = expert_idx.shape
    dev = x.device
    flat_e = expert_idx.reshape(-1).long()
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    starts = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = pos < capacity
    ec = n_experts * capacity
    dest = torch.where(keep, se * capacity + pos, torch.full_like(se, ec))  # trash slot
    gather_idx = torch.zeros((ec + 1,), dtype=torch.long, device=dev)
    gather_idx[dest[keep]] = st[keep]
    filled = torch.zeros((ec + 1,), dtype=torch.bool, device=dev)
    filled[dest[keep]] = True
    packed = torch.where(filled[:ec, None], x[gather_idx[:ec]], x.new_zeros(()))
    dest_by_flat = torch.empty((T * k,), dtype=torch.long, device=dev)
    dest_by_flat[order] = dest
    return packed.reshape(n_experts, capacity, -1), (dest_by_flat, gates, T, k)


def combine_from_experts(y, meta, T: int):
    """Inverse of ``pack_by_expert`` with gate weighting. y [E, C, D]."""
    dest_by_flat, gates, T_, k = meta
    e, c, d = y.shape
    y_flat = y.reshape(e * c, d)
    safe = torch.clamp(dest_by_flat, max=e * c - 1)
    vals = torch.where((dest_by_flat < e * c)[:, None], y_flat[safe], y.new_zeros(()))
    vals = vals * gates.reshape(T_ * k, 1).to(y.dtype)
    return vals.reshape(T_, k, d).sum(dim=1)


def moe_local(x, router, w_gate, w_up, w_down, *, n_experts, top_k_: int,
              capacity_factor) -> torch.Tensor:
    """The reference's per-shard body (``_moe_local``) on one device: every
    expert whole. x [T, D]."""
    T, D = x.shape
    logits = x.float() @ router.float()                               # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, top_k_)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    capacity = max(int(math.ceil(T * top_k_ / n_experts * capacity_factor)), 1)
    packed, meta = pack_by_expert(x, eidx, gates, n_experts, capacity)  # [E, C, D]
    h = silu(torch.einsum("ecd,edf->ecf", packed, w_gate)) * torch.einsum(
        "ecd,edf->ecf", packed, w_up)
    y = torch.einsum("ecf,efd->ecd", h, w_down)
    return combine_from_experts(y.to(x.dtype), meta, T)


def moe_ffn(x, router, w_gate, w_up, w_down, cfg, mesh=None,
            dp_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """x [B, S, D] (or [T, D]). Weights: router [D, E]; w_* [E, D, F]/[E, F, D]."""
    if mesh is not None:
        raise NotImplementedError("moe_ffn over a mesh (shard_map, tp/ep) comes with "
                                  "slice 10b")
    shape = x.shape
    out = moe_local(x.reshape(-1, shape[-1]), router, w_gate, w_up, w_down,
                    n_experts=cfg.n_experts, top_k_=cfg.top_k,
                    capacity_factor=cfg.capacity_factor)
    return out.reshape(shape)
