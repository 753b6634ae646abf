"""Divisibility-aware logical sharding rules, as the JAX package has them.

Every parameter/cache/input dimension is mapped to mesh axes through rules
that DROP any mesh axis that does not divide the dimension (whisper's 20
heads on a 16-way axis, qwen2-0.5b's kv=2, 1500 encoder frames, ...). This is
what lets one rule table serve all 10 architectures.

Layout summary (2-D weight sharding, Megatron×FSDP):
  * TP ("model"): attention head projections, MLP/expert F dim, vocab.
  * FSDP ("data"): the other matrix dim of every large parameter, so params
    and Adam state scale 1/(data*model).
  * "pod" (multi-pod): pure DP for parameters (replicated), batch sharded.

The rules are framework-free logic over a mesh's axis sizes: a "mesh" is
anything with ``.shape`` (axis -> size) and ``.axis_names``. A spec is a
plain tuple with one entry a dimension — ``None``, an axis name, or a tuple
of names — the port's stand-in for ``PartitionSpec``; ``()`` replicates.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

Spec = Tuple[object, ...]


def _spec(*entries) -> Spec:
    """A spec from its entries, normalised as ``PartitionSpec`` does: a
    tuple of one axis is that axis, an empty tuple None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


def _fit(dim: int, axis, mesh):
    """Return axis if it divides dim, else None."""
    if axis is None:
        return None
    if dim % _axis_size(mesh, axis) == 0:
        return axis
    # try a prefix for tuple axes, e.g. ("data","model") -> "data"
    if isinstance(axis, (tuple, list)):
        for k in range(len(axis) - 1, 0, -1):
            sub = tuple(axis[:k])
            if dim % _axis_size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
    return None


# name -> spec for the trailing dims (leading stacking dims replicate).
# "F" = TP axis, "D" = FSDP axis.
_MATRIX_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "xwq": ("data", "model"), "xwk": ("data", "model"), "xwv": ("data", "model"),
    "wo": ("model", "data"), "xwo": ("model", "data"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "in_proj": ("data", "model"), "out_proj": ("model", "data"),
    "embed": ("model", "data"), "lm_head": ("data", "model"),
    "router": (None, None),
    "conv_w": (None, "model"),
    "pos_embed": (None, None),
    # NGDB tables
    "entity": ("model", None), "sem_table": ("model", None), "relation": (None, None),
    # Out-of-core semantic hot set (semantic/store.py): bounded by the row
    # budget, so replicate — the scatter staging path stays collective-free.
    "sem_cache": (None, None),
}
_MOE_RULES_TP = {
    "moe_gate": (None, "data", "model"), "moe_up": (None, "data", "model"),
    "moe_down": (None, "model", "data"),
}
_MOE_RULES_EP = {
    "moe_gate": ("model", "data", None), "moe_up": ("model", "data", None),
    "moe_down": ("model", None, "data"),
}
_VECTOR_RULES: Dict[str, Optional[str]] = {
    "bq": "model", "bk": "model", "bv": "model", "b_up": "model",
    "conv_b": "model", "A_log": "model", "dt_bias": "model", "D_skip": "model",
    "ssm_norm": "model",
}


def param_spec(name: str, shape: Tuple[int, ...], mesh, moe_mode: str = "tp") -> Spec:
    rules = dict(_MATRIX_RULES)
    rules.update(_MOE_RULES_EP if moe_mode == "ep" else _MOE_RULES_TP)
    if name in rules:
        rule = rules[name]
        ndim = len(shape)
        spec = [None] * ndim
        for i, axis in enumerate(rule):
            di = ndim - len(rule) + i
            if di < 0:
                continue
            spec[di] = _fit(shape[di], axis, mesh)
        return _spec(*spec)
    if name in _VECTOR_RULES and len(shape) >= 1:
        axis = _fit(shape[-1], _VECTOR_RULES[name], mesh)
        return _spec(*([None] * (len(shape) - 1) + [axis]))
    return ()  # norms, scalars, small tables: replicate


def fsdp_param_spec(name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Pure-FSDP (ZeRO-3) profile: no tensor parallelism — every large
    parameter shards its largest divisible dim over the FLATTENED
    ("data","model") axes, and the batch spreads over all devices."""
    if name in ("sem_cache", "sem_slot"):
        # Hot-set cache + indirection stay replicated in EVERY profile: the
        # plan/apply staging scatter must remain collective-free, and the
        # buffers are already bounded by the row budget (not by E).
        return ()
    if not shape or int(np.prod(shape)) < (1 << 16):
        return ()  # norms/biases: replicate
    spec = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        ax = _fit(shape[i], ("data", "model"), mesh)
        if ax is not None:
            spec[i] = ax
            return _spec(*spec)
    return ()


def profile_spec(name: str, shape: Tuple[int, ...], mesh, profile: str = "2d",
                 moe_mode: str = "tp") -> Spec:
    """One leaf's spec under ``profile``: "2d" (TP x FSDP) | "fsdp"."""
    if profile == "fsdp":
        return fsdp_param_spec(name, tuple(shape), mesh)
    return param_spec(name, tuple(shape), mesh, moe_mode)


def param_specs(tree, mesh, profile: str = "2d", moe_mode: str = "tp"):
    """``tree``'s nested dict (params, or Adam state) with every leaf replaced
    by its spec. A leaf is named by the nearest key on its path that is not
    ``m`` or ``v``, so a moment takes its parameter's rule."""

    def walk(node, name):
        if isinstance(node, Mapping):
            return {k: walk(v, name if k in ("m", "v") else k) for k, v in node.items()}
        return profile_spec(name or "", tuple(node.shape), mesh, profile, moe_mode)

    return walk(tree, None)


# ------------------------------------------------------------------ batches
def dp_axes(mesh, profile: str = "2d") -> Tuple[str, ...]:
    if profile == "fsdp":
        return tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(shape: Tuple[int, ...], mesh, profile: str = "2d") -> Spec:
    """THE batch leaf rule: dim 0 over the DP axes where divisible, else
    replicate. ``ExecutionContext.batch_rows`` takes a rank's rows by it."""
    shape = tuple(shape)
    if not shape:
        return ()
    b_axis = _fit(shape[0], dp_axes(mesh, profile), mesh)
    return _spec(*([b_axis] + [None] * (len(shape) - 1)))


def batch_specs(tree, mesh, profile: str = "2d"):
    """Inputs: shard dim 0 (batch) over DP axes where divisible."""
    if isinstance(tree, Mapping):
        return {k: batch_specs(v, mesh, profile) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(batch_specs(v, mesh, profile) for v in tree)
    return batch_spec(tuple(np.shape(tree)), mesh, profile)


def cache_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """One decode-cache leaf's spec (``cache_shardings``' leaf rule), leaves
    stacked [n_rep, B, ...]:
      * batch over DP axes when divisible (decode_32k),
      * else the longest remaining dim (the S axis at long_500k) over
        ("data","model") / "model",
      * attention KV additionally shards S (or heads/hd) over "model".
    """
    dp = dp_axes(mesh)
    spec = [None] * len(shape)
    used_model = False
    b_axis = _fit(shape[1], dp, mesh)
    spec[1] = b_axis
    if b_axis is None and len(shape) > 2:
        # batch=1 (long_500k): shard the biggest dim over everything
        big = int(np.argmax(shape[2:])) + 2
        val = _fit(shape[big], ("data", "model"), mesh)
        spec[big] = val
        used_model = val == "model" or (isinstance(val, tuple) and "model" in val)
    if not used_model:
        # k/v/xk/xv: [n_rep, B, S, kv, hd]; conv/ssm: trailing dims
        for cand in range(2, len(shape)):
            ax = _fit(shape[cand], "model", mesh)
            if ax is not None:
                spec[cand] = ax
                break
    return _spec(*spec)
