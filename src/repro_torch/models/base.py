"""Unified operator interface for query-encoder backbones.

Every model exposes the five pooled operators over a FLAT state vector
[n, state_dim] so the executor is model-agnostic — the pooled kernels are
exactly the Kernel_{tau}(X_batch; theta_tau) of Eq. 5.

A model is an ``nn.Module`` whose parameters carry the JAX package's names
(``entity``, ``relation``, ``proj_w0``, ``att_w0``, …). The operators take a
``params`` mapping of those names to tensors — ``model.init_params(...)`` and
``params_from_numpy(...)`` return one — so a serving engine can swap a whole
parameter set atomically, as the reference swaps its params pytree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dim: int = 400                 # latent dimension (Table 5)
    gamma: float = 12.0            # margin (Table 5)
    hidden_mult: int = 2           # operator MLP width multiplier
    semantic_dim: int = 0          # d_l of the PTE manifold; 0 = structural-only
    # Pad entity-table rows to a multiple of this; padded rows are masked out
    # of score_all.
    entity_pad: int = 1


def glorot(shape, generator: torch.Generator, device) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    return torch.randn(shape, generator=generator, device=device) * math.sqrt(
        2.0 / (fan_in + fan_out))


def mlp_params(sizes, prefix: str, generator: torch.Generator, device) -> Dict:
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"{prefix}_w{i}"] = glorot((a, b), generator, device)
        p[f"{prefix}_b{i}"] = torch.zeros((b,), device=device)
    return p


def mlp_apply(p: Params, prefix: str, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


class QueryEncoder(nn.Module):
    """Base class. Subclasses implement the geometry."""

    name: str = "base"
    # "dot" | "l1" when the geometry's score is gamma ± <q, e>, which the
    # scoring kernel computes; None = plain PyTorch distance.
    score_mode: Optional[str] = None

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.semantic_dim > 0:
            raise NotImplementedError(
                "semantic augmentation (semantic_dim > 0) is not ported yet")
        self.cfg = cfg
        self.device = device

    # --- geometry interface -------------------------------------------------
    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    def init_geometry(self, generator: torch.Generator, n_entities: int,
                      n_relations: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def entity_state(self, params: Params, ent_vec) -> torch.Tensor:
        """Lift an entity vector [n, dim] into operator state [n, sd]."""
        raise NotImplementedError

    def project(self, params: Params, x, rel_ids) -> torch.Tensor:
        raise NotImplementedError

    def intersect(self, params: Params, X) -> torch.Tensor:  # [n, k, sd] -> [n, sd]
        raise NotImplementedError

    def union(self, params: Params, X) -> torch.Tensor:
        raise NotImplementedError

    def negate(self, params: Params, x) -> torch.Tensor:
        raise NotImplementedError

    def distance(self, params: Params, q, ent_vec) -> torch.Tensor:
        """d(q, e): q [.., sd] vs entity vec [.., dim] -> [..]."""
        raise NotImplementedError

    # --- parameters ----------------------------------------------------------
    def padded_entities(self, n_entities: int) -> int:
        m = self.cfg.entity_pad
        return ((n_entities + m - 1) // m) * m

    def _set_params(self, tensors: Mapping[str, torch.Tensor],
                    n_entities: int) -> Dict[str, torch.Tensor]:
        for k, v in tensors.items():
            self.register_parameter(k, nn.Parameter(v, requires_grad=False))
        self.n_entities = n_entities  # real count; tables may be padded
        return self.params()

    def params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters by name, as the operators take them."""
        return {k: p.detach() for k, p in self.named_parameters()}

    def init_params(self, generator: torch.Generator, n_entities: int,
                    n_relations: int) -> Dict[str, torch.Tensor]:
        """Random parameters at the reference's shapes and distributions,
        drawn from ``generator`` (on the model's device)."""
        d = self.cfg.dim
        rows = self.padded_entities(n_entities)
        p = {"entity": torch.randn((rows, d), generator=generator,
                                   device=self.device) / math.sqrt(d)}
        p.update(self.init_geometry(generator, n_entities, n_relations))
        return self._set_params(p, n_entities)

    # --- entities and scoring -------------------------------------------------
    def fused_entity_vec(self, params: Params, ent_ids) -> torch.Tensor:
        """Entity vectors (structural only: the semantic half of Eq. 12 comes
        with the semantic slice)."""
        return params["entity"][ent_ids]

    def embed(self, params: Params, ent_ids) -> torch.Tensor:
        return self.entity_state(params, self.fused_entity_vec(params, ent_ids))

    def score_ids(self, params: Params, q, ent_ids) -> torch.Tensor:
        """gamma - d(q, e) for given candidate ids. q [B, sd], ids [B, M]."""
        ev = self.fused_entity_vec(params, ent_ids)           # [B, M, dim]
        return self.cfg.gamma - self.distance(params, q[:, None, :], ev)

    def score_all(self, params: Params, q) -> torch.Tensor:
        """Logits against EVERY entity (vectorized logit formulation, Eq. 6).
        Padded table rows are masked to -1e30."""
        ev = params["entity"]                                  # [E, dim]
        rows = ev.shape[0]
        if self.score_mode:
            scores = kops.scoring(q, ev, gamma=self.cfg.gamma,
                                  mode=self.score_mode)
        else:
            scores = self.cfg.gamma - self.distance(
                params, q[:, None, :], ev[None, :, :])
        n_real = getattr(self, "n_entities", rows)
        if n_real != rows:
            ids = torch.arange(rows, device=scores.device)
            scores = torch.where(ids[None, :] < n_real, scores,
                                 torch.full_like(scores, -1e30))
        return scores


def params_from_numpy(model: QueryEncoder, np_params: Mapping[str, np.ndarray],
                      device=None, n_entities: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Load a dict of numpy arrays — the JAX package's ``init_params`` output
    as ``{k: np.asarray(v)}`` — into ``model`` under the same names, on
    ``device`` (the model's device by default). ``n_entities`` is the real
    entity count when the table is padded. Returns the params mapping."""
    device = model.device if device is None else torch.device(device)
    tensors = {k: torch.tensor(np.array(v, dtype=np.float32), device=device)
               for k, v in np_params.items()}
    rows = tensors["entity"].shape[0]
    return model._set_params(tensors, rows if n_entities is None else n_entities)


_REGISTRY: Dict[str, Callable[..., QueryEncoder]] = {}


def register_model(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def _load_builtin():
    import repro_torch.models.betae  # noqa: F401
    import repro_torch.models.complex_e  # noqa: F401
    import repro_torch.models.gqe  # noqa: F401


def make_model(name: str, cfg: Optional[ModelConfig] = None,
               device=None) -> QueryEncoder:
    """A model of family ``name`` on ``device`` (``cuda`` unless given)."""
    _load_builtin()
    return _REGISTRY[name](cfg or ModelConfig(), resolve_device(device))


def model_names():
    _load_builtin()
    return sorted(_REGISTRY)
