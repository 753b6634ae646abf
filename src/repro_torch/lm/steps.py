"""Step functions: train (forward, backward, Adam), prefill and decode, as the
JAX package's ``lm/steps.py`` makes them.

Adam is the port's own (``training/optim.py``), which takes a flat
``{name: tensor}``: the nested, stacked parameter tree goes through it
flattened by path (``"blocks/pos0/wq"``) with nothing frozen (``LM_ADAM``),
and updates the tree's own tensors in place. ``lm_adam_init`` makes the
matching state.

Given a ``mesh`` (a ``ProcessMesh``, or the dry run's ``VirtualMesh``) and its
profile's ``dp_axes`` (``sharding.dp_axes(mesh, profile)``; ``model`` among
them means ``fsdp``), a step runs one rank's program (``lm/parallel.py``):
its inputs are the global batch, of which it takes its rows
(``sharding.batch_spec``); parameters, Adam moments and decode caches are its
shards (``sharding.param_specs``, ``sharding.cache_spec`` under ``2d``, the
rank's rows under ``fsdp``); its outputs are the global loss and its rows'
logits and caches. The train step's loss is its rows' share of the global
mean; each gradient reaches its shard summed over the batch axes (in the
backward of a gathered weight, else by one all-reduce of every other
gradient here) and Adam updates the shards in place; nothing gathered
outlives the step.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.lm.config import LMConfig
from repro_torch.lm.model import (COMPUTE_DTYPE, block_pattern, chunked_ce_loss,
                                  forward, logits_fn, n_repeats)
from repro_torch.training.optim import AdamConfig, adam_init, adam_update

LM_ADAM = AdamConfig(lr=1e-4, frozen=())


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a/b/c": leaf}`` of a nested tree (the same tensors)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_adam_init(params: Mapping, adam: AdamConfig = LM_ADAM) -> Dict:
    """Adam state of a parameter tree: the port's flat state over its paths."""
    return adam_init(flatten(params), adam)


def _forward_kwargs(cfg: LMConfig, batch: Dict) -> Dict:
    kw = {}
    if "embeddings" in batch:
        kw["embeddings"] = batch["embeddings"]
    else:
        kw["tokens"] = batch["tokens"]
    if cfg.is_encdec:
        kw["enc_frames"] = batch["encoder_frames"]
    return kw


def _plan(cfg: LMConfig, mesh, dp_axes, batch: Dict):
    """(the step's ``MeshPlan``, this rank's rows of ``batch``), or (None,
    ``batch``) without a mesh."""
    if mesh is None:
        return None, batch
    from repro_torch.lm.parallel import MeshPlan

    lead = batch.get("tokens", batch.get("embeddings"))
    plan = MeshPlan(cfg, mesh, dp_axes, lead.shape[0])
    return plan, {k: plan.local_rows(v) for k, v in batch.items()}


def make_train_step(cfg: LMConfig, mesh=None, dp_axes=(), adam: AdamConfig = LM_ADAM):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients by autograd, then Adam in place on the
    tree's tensors (the same objects are returned)."""

    def train_step(params, opt_state, batch):
        plan, batch = _plan(cfg, mesh, dp_axes, batch)
        flat = flatten(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        tree = _unflatten(leaves)
        with torch.enable_grad():
            hidden, _ = forward(tree, cfg, par=plan, **_forward_kwargs(cfg, batch))
            loss = chunked_ce_loss(tree, cfg, hidden, batch["labels"], par=plan)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(flat.items(), grads)}
        loss = loss.detach()
        if plan is not None and plan.batch_axes:
            # The gradients no gathered weight's backward summed, in one
            # all-reduce over the batch axes; the loss over them.
            names = [k for k in sorted(grads) if k not in plan.gathered]
            if names:
                flat_g = plan.mesh.all_reduce(torch.cat([grads[k].reshape(-1) for k in names]),
                                              plan.batch_axes)
                for k, g in zip(names, torch.split(flat_g, [grads[k].numel() for k in names])):
                    grads[k] = g.view(grads[k].shape)
            loss = plan.reduce_batch(loss)
        adam_update(grads, opt_state, flat, adam)
        return params, opt_state, loss

    return train_step


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def make_prefill_step(cfg: LMConfig, mesh=None, dp_axes=(), cache_margin: int = 0):
    """``prefill_step(params, batch) -> (caches, last logits)``. ``cache_margin``
    extra KV slots are reserved so later decode steps have room (a decode
    write at cache_len == capacity would clamp)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        plan, batch = _plan(cfg, mesh, dp_axes, batch)
        tokens = batch.get("tokens", batch.get("embeddings"))
        pad_to = tokens.shape[1] + cache_margin if cache_margin else None
        hidden, caches = forward(params, cfg, caches="init", pad_cache_to=pad_to, par=plan,
                                 **_forward_kwargs(cfg, batch))
        return caches, logits_fn(params, cfg, hidden[:, -1:], par=plan)

    return prefill_step


def make_decode_step(cfg: LMConfig, mesh=None, dp_axes=()):
    """``decode_step(params, caches, tokens [B,1], cache_len) -> (logits,
    new_caches)``."""

    @torch.no_grad()
    def decode_step(params, caches, tokens, cache_len):
        plan, batch = _plan(cfg, mesh, dp_axes, {"tokens": tokens})
        hidden, new_caches = forward(params, cfg, tokens=batch["tokens"], caches=caches,
                                     cache_len=cache_len, par=plan)
        return logits_fn(params, cfg, hidden, par=plan), new_caches

    return decode_step


# ---------------------------------------------------------------- cache spec
def cache_struct(cfg: LMConfig, batch: int, s_cache: int, abstract: bool = True,
                 device=None):
    """Cache tree matching ``forward()``'s layout, {posN: {...}} with every
    leaf stacked [n_rep, ...]: meta tensors (shapes and dtypes only) when
    ``abstract``, else zeros on ``device`` (``cuda`` unless given)."""
    from repro_torch.device import resolve_device

    dev = torch.device("meta") if abstract else resolve_device(device)
    reps = n_repeats(cfg)
    hd = cfg.resolved_head_dim
    kv = cfg.n_kv_heads

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    out = {}
    s_attn = min(s_cache, cfg.sliding_window) if cfg.sliding_window else s_cache
    for pi, (mixer, _) in enumerate(block_pattern(cfg)):
        if mixer == "attn":
            c = {"k": mk((reps, batch, s_attn, kv, hd), COMPUTE_DTYPE),
                 "v": mk((reps, batch, s_attn, kv, hd), COMPUTE_DTYPE)}
            if cfg.is_encdec:
                c["xk"] = mk((reps, batch, cfg.encoder_seq, kv, hd), COMPUTE_DTYPE)
                c["xv"] = mk((reps, batch, cfg.encoder_seq, kv, hd), COMPUTE_DTYPE)
        else:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            c = {"conv": mk((reps, batch, cfg.ssm_conv - 1, conv_dim), COMPUTE_DTYPE),
                 "ssm": mk((reps, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           torch.float32)}
        out[f"pos{pi}"] = c
    return out
