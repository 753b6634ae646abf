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
    n_particles: int = 2           # Q2P
    hidden_mult: int = 2           # operator MLP width multiplier
    semantic_dim: int = 0          # d_l of the PTE manifold; 0 = structural-only
    semantic_proj_dim: int = 64    # F: R^{d_l} -> R^{proj} before concat (Eq. 12)
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


_SCALARS: Dict[float, torch.Tensor] = {}


def _scalar(v: float) -> torch.Tensor:
    """``v`` as a 0-dim fp32 CPU tensor, which binary ops take beside a
    tensor on any device without a copy to it."""
    t = _SCALARS.get(v)
    if t is None:
        t = _SCALARS[v] = torch.tensor(v, dtype=torch.float32)
    return t


# The JAX package's elementwise bounds, with its gradient at a tie: jnp.maximum
# and jnp.minimum give each side half, and jnp.clip is their composition.
# (clamp would pass the whole gradient at the bound.)
def maximum(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.maximum(x, _scalar(v))


def minimum(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, _scalar(v))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return minimum(maximum(x, lo), hi)


def mlp_apply(p: Params, prefix: str, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


class QueryEncoder(nn.Module):
    """Base class. Subclasses implement the geometry; the fused-entity path
    (structural ⊕ semantic, Eq. 12) is shared here."""

    name: str = "base"
    # "dot" | "l1" when the geometry's score is gamma ± <q, e>, which the
    # scoring kernel computes; None = plain PyTorch distance.
    score_mode: Optional[str] = None

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
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

    def frozen_param_names(self):
        """The H_sem buffer in either layout (full-resident table, or hot-set
        cache + its int32 indirection): never trained. They are registered
        as buffers, the rest as parameters."""
        return ("sem_table", "sem_cache", "sem_slot")

    def _set_params(self, tensors: Mapping[str, torch.Tensor], n_entities: int,
                    full_shapes: Optional[Mapping[str, tuple]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Register ``tensors``. ``full_shapes`` (name -> the whole tensor's
        shape) is given where they are one rank's shards; ``full_shapes``
        keeps it (the tensors' own shapes otherwise)."""
        self.full_shapes = dict(full_shapes or {k: tuple(v.shape) for k, v in tensors.items()})
        # A new parameter set replaces the old one whole (a resident table
        # must not linger beside a later hot-set layout).
        self._parameters.clear()
        self._buffers.clear()
        frozen = self.frozen_param_names()
        for k, v in tensors.items():
            if k in frozen:
                self.register_buffer(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
        self.n_entities = n_entities  # real count; tables may be padded
        return self.params()

    def params(self) -> Dict[str, torch.Tensor]:
        """Every tensor the operators read, by name: the parameters and the
        frozen semantic buffers. The buffers are the module's own tensors, so
        the hot-set cache's in-place staging reaches them."""
        out = {k: p.detach() for k, p in self.named_parameters()}
        out.update(self.named_buffers())
        return out

    def init_params(self, generator: torch.Generator, n_entities: int,
                    n_relations: int, semantic_table=None,
                    semantic_cache=None, ctx=None) -> Dict[str, torch.Tensor]:
        """Random parameters at the reference's shapes and distributions,
        drawn from ``generator`` (on the model's device). With
        ``semantic_dim > 0`` the semantic layout is decided by which buffer
        is supplied:

        * ``semantic_table`` — full-resident frozen ``sem_table`` [E, d_l]
          (numpy or tensor), zero-padded to the padded row count;
        * ``semantic_cache`` — a ``semantic.store.SemanticCache``: the params
          carry its bounded ``sem_cache`` hot set and the ``sem_slot``
          entity-id -> slot indirection instead of the table. Gathers must be
          preceded by ``cache.plan``/``apply_to``.

        ``ctx`` (a mesh ``distributed.context.ExecutionContext``): every rank
        draws the full tables from ``generator``, bitwise the single-device
        draw, and keeps (and registers) only its shard of each
        (``ctx.shard``); ``sem_cache`` and ``sem_slot`` stay replicated.
        """
        d = self.cfg.dim
        rows = self.padded_entities(n_entities)
        dev = self.device
        p = {"entity": torch.randn((rows, d), generator=generator,
                                   device=dev) / math.sqrt(d)}
        p.update(self.init_geometry(generator, n_entities, n_relations))
        if self.cfg.semantic_dim > 0:
            if semantic_cache is not None:
                width = semantic_cache.dim
                covered = semantic_cache.n_rows >= n_entities
            else:
                width = None if semantic_table is None else semantic_table.shape[1]
                covered = True
            if width != self.cfg.semantic_dim or not covered:
                raise ValueError(
                    f"semantic_dim={self.cfg.semantic_dim} needs a semantic_table "
                    f"[{n_entities}, {self.cfg.semantic_dim}] or a semantic_cache "
                    f"of that width covering {n_entities} entities")
            if semantic_cache is not None:
                p["sem_cache"] = semantic_cache.buffer   # [budget, d_l] hot set
                p["sem_slot"] = semantic_cache.slot_map  # [E] id -> slot
            else:
                st = torch.as_tensor(semantic_table).to(dev, torch.float32)
                if st.shape[0] < rows:
                    st = torch.cat([st, st.new_zeros((rows - st.shape[0],
                                                      st.shape[1]))])
                p["sem_table"] = st
            dp = self.cfg.semantic_proj_dim
            p["sem_proj_w"] = glorot((self.cfg.semantic_dim, dp), generator, dev)
            p["sem_proj_b"] = torch.zeros((dp,), device=dev)
            p["fuse_w"] = glorot((d + dp, d), generator, dev)
            p["fuse_b"] = torch.zeros((d,), device=dev)
        shapes = {k: tuple(v.shape) for k, v in p.items()}
        if ctx is not None:
            p = {k: ctx.shard(k, v) for k, v in p.items()}
        return self._set_params(p, n_entities, shapes)

    # --- shared fused-entity path (Eq. 11 + 12) --------------------------------
    def semantic_rows(self, params: Params, ent_ids) -> torch.Tensor:
        """Gather(H_sem, I) — Eq. 11, in whichever layout the params carry:
        the resident ``sem_table`` or the hot-set cache via ``sem_slot``
        (ids must have been staged by the cache)."""
        h_sem, sem_ids = kops.semantic_source(params, ent_ids)
        return h_sem[ent_ids if sem_ids is None else sem_ids]

    def fuse_semantic(self, params: Params, h, z) -> torch.Tensor:
        """Eq. 12 on already-gathered rows in plain PyTorch (differentiable):
        h [.., d] structural, z [.., d_l] semantic -> fused [.., d], computed
        in fp32 (fp64 for fp64 rows, as ``gather_fuse_ref``)."""
        h2 = h.reshape(-1, h.shape[-1])
        out = kops.gather_fuse_ref(
            torch.arange(h2.shape[0], device=h.device), h2,
            z.reshape(-1, z.shape[-1]), params["sem_proj_w"],
            params["sem_proj_b"], params["fuse_w"], params["fuse_b"])
        return out.reshape(h.shape)

    def fused_entity_vec(self, params: Params, ent_ids) -> torch.Tensor:
        """x_i = sigma(W [h_str ⊕ F(h_sem)] + b) — Eq. 12, through the
        ``gather_fuse`` kernel (its plain version for CPU tensors).
        Differentiable in ``entity`` and the fusion weights: on the card
        autograd runs the ``gather_fuse_backward`` kernel.

        Params carrying ``entity_ids`` (sorted global ids) hold in ``entity``,
        and in a resident ``sem_table``, only those ids' rows, so ``ent_ids``
        are first translated to rows among them; the hot set stays indexed
        by global id through ``sem_slot``."""
        ids = torch.as_tensor(ent_ids, device=params["entity"].device)
        rows = ids
        if "entity_ids" in params:
            held = params["entity_ids"]
            rows = torch.searchsorted(held, ids.to(held.dtype))
        if self.cfg.semantic_dim == 0:
            return params["entity"][rows]
        out = kops.gather_fuse_params(params, ids.reshape(-1).contiguous(),
                                      rows=rows.reshape(-1).contiguous())
        return out.reshape(*ids.shape, out.shape[-1])

    def embed(self, params: Params, ent_ids) -> torch.Tensor:
        return self.entity_state(params, self.fused_entity_vec(params, ent_ids))

    def score_ids(self, params: Params, q, ent_ids) -> torch.Tensor:
        """gamma - d(q, e) for given candidate ids. q [B, sd], ids [B, M]."""
        ev = self.fused_entity_vec(params, ent_ids)           # [B, M, dim]
        return self.cfg.gamma - self.distance(params, q[:, None, :], ev)

    def _score(self, params: Params, q, ev) -> torch.Tensor:
        """gamma - d(q, e) for q [B, sd] against entity vectors ev [N, dim]:
        the scoring kernel where the geometry has one."""
        if self.score_mode:
            return kops.scoring(q, ev, gamma=self.cfg.gamma, mode=self.score_mode)
        return self.cfg.gamma - self.distance(params, q[:, None, :], ev[None, :, :])

    def score_all(self, params: Params, q, n_entities: Optional[int] = None,
                  row_offset: int = 0) -> torch.Tensor:
        """Logits against EVERY entity (vectorized logit formulation, Eq. 6).
        Table rows at or past the real entity count are masked to -1e30: the
        count is ``n_entities`` when given (a serving engine passes the count
        it retained with a pinned version's params), else the model's
        current ``n_entities``. With a resident semantic table every entity
        is fused first, in one ``gather_fuse`` launch. ``row_offset`` is the
        global id of the table's first row, where the params hold one
        rank's block of rows under a mesh."""
        if "sem_slot" in params:
            raise RuntimeError(
                "score_all needs every entity's semantic row, but these "
                "params carry the bounded hot-set cache; use "
                "score_all_chunked(params, q, store.read_rows) to stream "
                "over the on-disk store instead")
        ev = params["entity"]                                  # [E, dim]
        rows = ev.shape[0]
        if self.cfg.semantic_dim > 0:
            ev = self.fused_entity_vec(params, torch.arange(rows, device=ev.device))
        scores = self._score(params, q, ev)
        n_real = getattr(self, "n_entities", rows) if n_entities is None else n_entities
        if n_real < row_offset + rows:
            ids = torch.arange(row_offset, row_offset + rows, device=scores.device)
            scores = torch.where(ids[None, :] < n_real, scores,
                                 torch.full_like(scores, -1e30))
        return scores

    @torch.no_grad()
    def score_all_chunked(self, params: Params, q, sem_rows_fn,
                          chunk: int = 4096) -> np.ndarray:
        """Out-of-core twin of ``score_all`` for the semantic-store path:
        streams entity chunks — the structural slice plus ``sem_rows_fn(ids)``
        rows read from the store and copied to the device — fuses each with
        ``gather_fuse`` (local ``sem_ids`` into the chunk) and scores it; the
        full ``[E, d_l]`` table never exists anywhere. Returns host numpy
        [B, n_real]. ``sem_rows_fn`` is e.g. ``SemanticStore.read_rows``."""
        rows = params["entity"].shape[0]
        n_real = getattr(self, "n_entities", rows)
        return self.score_rows_chunked(params, q, sem_rows_fn, 0, n_real,
                                       chunk=chunk).cpu().numpy()

    @torch.no_grad()
    def score_rows_chunked(self, params: Params, q, sem_rows_fn, lo: int, hi: int,
                           chunk: int = 4096, row_offset: int = 0) -> torch.Tensor:
        """``score_all_chunked``'s scores against the global rows [lo, hi) as
        a device tensor [B, hi - lo]: chunks of ``chunk`` rows from ``lo``.
        ``row_offset`` is the global id of the params table's first row (one
        rank's block under a mesh)."""
        entity = params["entity"]
        dev = entity.device
        outs = []
        for a in range(lo, hi, chunk):
            b = min(a + chunk, hi)
            if self.cfg.semantic_dim > 0:
                z = torch.from_numpy(np.ascontiguousarray(
                    sem_rows_fn(np.arange(a, b)), dtype=np.float32)).to(dev)
                ev = kops.gather_fuse(
                    torch.arange(a - row_offset, b - row_offset, device=dev), entity, z,
                    params["sem_proj_w"], params["sem_proj_b"],
                    params["fuse_w"], params["fuse_b"],
                    sem_ids=torch.arange(b - a, device=dev))
            else:
                ev = entity[a - row_offset:b - row_offset]
            outs.append(self._score(params, q, ev))
        if not outs:   # a rank whose rows are all padding
            return torch.empty((q.shape[0], 0), dtype=torch.float32, device=dev)
        return torch.cat(outs, dim=1)


def _carried(v, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: floats become float32,
    integer arrays (the cache layout's int32 ``sem_slot`` index map) keep
    their dtype."""
    a = np.asarray(v)
    if not np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def params_from_numpy(model: QueryEncoder, np_params: Mapping[str, np.ndarray],
                      device=None, n_entities: Optional[int] = None, ctx=None
                      ) -> Dict[str, torch.Tensor]:
    """Load a dict of numpy arrays — the JAX package's ``init_params`` output
    as ``{k: np.asarray(v)}`` — into ``model`` under the same names, on
    ``device`` (the model's device by default). ``n_entities`` is the real
    entity count when the table is padded. Under a mesh ``ctx`` the model
    keeps only this rank's shard of each (``ctx.shard``), as
    ``init_params(ctx=)`` does. Returns the params mapping."""
    device = model.device if device is None else torch.device(device)
    tensors = {k: _carried(v, device) for k, v in np_params.items()}
    rows = tensors["entity"].shape[0]
    shapes = {k: tuple(v.shape) for k, v in tensors.items()}
    if ctx is not None:
        tensors = {k: ctx.shard(k, v) for k, v in tensors.items()}
    return model._set_params(tensors, rows if n_entities is None else n_entities, shapes)


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
    import repro_torch.models.fuzzqe  # noqa: F401
    import repro_torch.models.gqe  # noqa: F401
    import repro_torch.models.q2b  # noqa: F401
    import repro_torch.models.q2p  # noqa: F401


def make_model(name: str, cfg: Optional[ModelConfig] = None,
               device=None) -> QueryEncoder:
    """A model of family ``name`` on ``device`` (``cuda`` unless given)."""
    _load_builtin()
    return _REGISTRY[name](cfg or ModelConfig(), resolve_device(device))


def model_names():
    _load_builtin()
    return sorted(_REGISTRY)
