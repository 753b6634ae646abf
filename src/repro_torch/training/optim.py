"""Adam written out by hand, as the JAX package's ``training/optim.py`` has
it, with frozen-parameter masking (the H_sem buffer receives no updates) and
global-norm clipping. ``torch.optim.Adam`` differs from it: it adds weight
decay to the gradient, where the reference adds ``weight_decay·p`` inside the
learning-rate term, and it keeps full moments for every tensor.

State is ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32 scalar}``
— the reference's pytree, so checkpoints carry the same keys. ``adam_update``
updates parameters and moments in place (the reference returns new arrays),
which keeps one copy of each on the device."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4           # Table 5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 0.0     # 0 = off
    # H_sem in either layout: full-resident table, or hot-set cache buffer +
    # its int32 entity->slot indirection.
    frozen: Tuple[str, ...] = ("sem_table", "sem_cache", "sem_slot")


def adam_init(params: Mapping[str, torch.Tensor],
              cfg: AdamConfig = AdamConfig(), ctx=None) -> Dict:
    """Zero moments; frozen buffers get (1,) token moments — they receive no
    updates, so real moments would only take memory.

    Under a mesh ``ctx`` the params are this rank's shards
    (``init_params(ctx=)``), so each moment, zeros like its parameter, is
    the shard ``ctx.shard`` keeps of the full moment: the moments are
    sharded like their parameters, and ``adam_update`` runs unchanged on
    the local shards. The context is taken for the reference's signature;
    the shards carry all it would say."""

    def zeros(k, p):
        if k in cfg.frozen:
            return torch.zeros((1,), dtype=p.dtype, device=p.device)
        return torch.zeros_like(p)

    dev = next(iter(params.values())).device
    return {"m": {k: zeros(k, p) for k, p in params.items()},
            "v": {k: zeros(k, p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, summed in the
    reference's pytree order (sorted names)."""
    return torch.sqrt(sum((tensors[k] * tensors[k]).sum() for k in sorted(tensors)))


@torch.no_grad()
def adam_update(grads: Mapping[str, torch.Tensor], state: Dict,
                params: Mapping[str, torch.Tensor],
                cfg: AdamConfig = AdamConfig()) -> Tuple[Mapping, Dict]:
    """One Adam step over every non-frozen name of ``params``, in place.
    Returns ``(params, state)`` (the same objects)."""
    step = state["step"] + 1
    if cfg.clip_norm > 0:
        g_norm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (g_norm + 1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    # The bias corrections in fp32 from the int32 step, as the reference.
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2t = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for k in sorted(params):
        if k in cfg.frozen:
            continue
        p, g, m, v = params[k], grads[k], state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        upd = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p
        p.sub_(cfg.lr * upd)
    state["step"] = step
    return params, state
