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

Over a mesh (the reference's ``shard_map``), rank-local: a rank routes and
packs its own tokens, which are its rows of the batch (``batch_spec`` splits
the batch over the dp axes that divide it, and tokens are whole on every
rank of an axis that does not: the reference's dropping of the dp axes that
do not divide the token count, for every cell of the zoo), and holds
either every expert's F/m slice (``moe_mode="tp"``) or its E/m experts
whole (``"ep"``, E % m == 0); its output is a partial sum, reduced by one
all-reduce over ``model`` after ``combine_from_experts`` (``moe_ffn``; the
LM's layers take ``moe_partial`` and reduce it themselves). The port's
``moe_ffn`` takes the step's ``MeshPlan`` in place of the reference's
``mesh`` and ``dp_axes``: its tokens are already the rank's.
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
    # Scattered through dest itself (a fixed shape, as the meta device needs):
    # the dropped entries all land in the trash slot ec, never read.
    gather_idx = torch.zeros((ec + 1,), dtype=torch.long, device=dev)
    gather_idx[dest] = st
    filled = torch.zeros((ec + 1,), dtype=torch.bool, device=dev)
    filled[dest] = keep
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
              capacity_factor, ep_shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The reference's per-shard body (``_moe_local``). x [T, D]. The
    weights are every expert's (whole, or its F/m slice: a partial output),
    or, given ``ep_shard`` = (shard, shards), that shard's E/shards experts
    whole: the other experts' tokens combine to zero here."""
    T, D = x.shape
    logits = x.float() @ router.float()                               # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, top_k_)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    capacity = max(int(math.ceil(T * top_k_ / n_experts * capacity_factor)), 1)
    packed, meta = pack_by_expert(x, eidx, gates, n_experts, capacity)  # [E, C, D]
    shard, shards = ep_shard
    if shards > 1:
        e_loc = n_experts // shards
        packed = packed[shard * e_loc:(shard + 1) * e_loc]
    h = silu(torch.einsum("ecd,edf->ecf", packed, w_gate)) * torch.einsum(
        "ecd,edf->ecf", packed, w_up)
    y = torch.einsum("ecf,efd->ecd", h, w_down)
    if shards > 1:
        pad = (0, 0, 0, 0, shard * e_loc, (shards - 1 - shard) * e_loc)
        y = torch.nn.functional.pad(y, pad)
    return combine_from_experts(y.to(x.dtype), meta, T)


def moe_partial(x, router, w_gate, w_up, w_down, cfg, par) -> torch.Tensor:
    """One rank's partial output over the model axis of ``par`` (a
    ``MeshPlan``; module docstring): x [B, S, D] its tokens, router whole,
    w_* its tp or ep slice. ``x`` and ``router`` enter as replicated values
    whose gradients are partial sums."""
    from repro_torch.lm.parallel import MODEL

    shard = (0, 1)
    if cfg.moe_mode == "ep":
        assert cfg.n_experts % par.m == 0, (cfg.n_experts, par.m)
        shard = (par.mesh.index(MODEL), par.m)
    shape = x.shape
    x = par.copy_in(x)
    router = par.copy_in(router)
    out = moe_local(x.reshape(-1, shape[-1]), router, w_gate, w_up, w_down,
                    n_experts=cfg.n_experts, top_k_=cfg.top_k,
                    capacity_factor=cfg.capacity_factor, ep_shard=shard)
    return out.reshape(shape)


def moe_ffn(x, router, w_gate, w_up, w_down, cfg, par=None) -> torch.Tensor:
    """x [B, S, D] (or [T, D]). Weights: router [D, E]; w_* [E, D, F]/[E, F, D]
    whole, or under ``par`` (a 2d ``MeshPlan``, the reference's ``mesh``)
    this rank's tokens and tp/ep slices (module docstring), the output
    summed over model."""
    if par is not None:
        return par.row_sum(moe_partial(x, router, w_gate, w_up, w_down, cfg, par))
    shape = x.shape
    out = moe_local(x.reshape(-1, shape[-1]), router, w_gate, w_up, w_down,
                    n_experts=cfg.n_experts, top_k_=cfg.top_k,
                    capacity_factor=cfg.capacity_factor)
    return out.reshape(shape)
