"""Pipeline parallelism over the ``pod`` mesh axis (``--pod-mode=pp``).

GPipe-style schedule, as the JAX package's ``shard_map``/``ppermute`` one:
each pod holds a contiguous stage of the layer stack; microbatch
activations travel to the next stage by ``isend``/``irecv``
(``ProcessMesh.exchange``). With S stages and M microbatches the bubble
fraction is (S-1)/(M+S-1) — at S=2 pods, M=8 microbatches it is ~12%, traded
against NOT replicating the model across pods.

This module is deliberately model-agnostic: ``stage_fn(stage_params, x)``
is any per-stage forward.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch


def _stage(tree, s: int):
    """``tree`` (tensor, mapping, list or tuple of tensors) at leading index s."""
    if isinstance(tree, Mapping):
        return {k: _stage(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, s) for v in tree)
    return tree[s]


def gpipe_forward(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
                  mesh, axis: str = "pod") -> torch.Tensor:
    """Run M microbatches through S pipeline stages, one a rank along
    ``axis`` of ``mesh`` (a ``ProcessMesh``).

    stage_params : leaves with leading dim S; this rank runs its stage's
                   slice (its coordinate on ``axis``).
    x_microbatches : [M, mb, ...] input microbatches (the same on every rank).
    Returns [M, mb, ...] outputs, the last stage's, broadcast to every rank
    of the pipeline. M + S - 1 ticks: stage 0 injects microbatch t (the last
    one again once they run out), every other stage runs what the previous
    stage sent it the tick before, and the last stage keeps microbatch
    t - (S - 1)'s result."""
    S = mesh.shape[axis]
    M = x_microbatches.shape[0]
    stage_id = mesh.coords[axis]
    ranks = sorted(mesh.members((axis,)), key=lambda r: mesh.index((axis,), r))
    params = _stage(stage_params, stage_id)
    inflight = torch.zeros_like(x_microbatches[0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(M + S - 1):
        x_in = x_microbatches[min(t, M - 1)] if stage_id == 0 else inflight
        y = stage_fn(params, x_in)
        if stage_id == S - 1 and t >= S - 1:
            outputs[t - (S - 1)] = y
        nxt = torch.empty_like(inflight) if stage_id > 0 else None
        mesh.exchange(y if stage_id < S - 1 else None,
                      ranks[stage_id + 1] if stage_id < S - 1 else None,
                      nxt, ranks[stage_id - 1] if stage_id > 0 else None)
        if nxt is not None:
            inflight = nxt
    return mesh.broadcast(outputs, ranks[-1], (axis,))


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
