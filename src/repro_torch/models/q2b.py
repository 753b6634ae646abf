"""Query2Box (Ren et al., 2020): box embeddings (center ⊕ offset)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.base import QueryEncoder, maximum, mlp_apply, mlp_params, register_model


@register_model("q2b")
class Q2B(QueryEncoder):
    ALPHA = 0.02  # inside-distance downweight (paper default)

    @property
    def state_dim(self) -> int:
        return 2 * self.cfg.dim

    def init_geometry(self, generator, n_entities, n_relations):
        d, h = self.cfg.dim, self.cfg.dim * self.cfg.hidden_mult
        dev = self.device
        p = {
            "rel_center": torch.randn((n_relations, d), generator=generator,
                                      device=dev) / math.sqrt(d),
            "rel_offset": torch.randn((n_relations, d), generator=generator,
                                      device=dev) * 0.1,
        }
        p.update(mlp_params((2 * d, h, d), "att", generator, dev))   # center attention scorer
        p.update(mlp_params((2 * d, h, d), "off", generator, dev))   # offset DeepSets
        p.update(mlp_params((2 * d, h, 2 * d), "neg", generator, dev))
        return p

    def _split(self, s):
        d = self.cfg.dim
        return s[..., :d], s[..., d:]

    def entity_state(self, params, ent_vec):
        return torch.cat([ent_vec, torch.zeros_like(ent_vec)], dim=-1)

    def project(self, params, x, rel_ids):
        c, o = self._split(x)
        c = c + params["rel_center"][rel_ids]
        o = o + F.softplus(params["rel_offset"][rel_ids])
        return torch.cat([c, o], dim=-1)

    def intersect(self, params, X):
        C, O = self._split(X)                                   # [n, k, d]
        att = torch.softmax(mlp_apply(params, "att", X, 2), dim=1)
        c = (att * C).sum(dim=1)
        deep = torch.sigmoid(mlp_apply(params, "off", X, 2).mean(dim=1))
        o = O.amin(dim=1) * deep                                # shrink
        return torch.cat([c, o], dim=-1)

    def union(self, params, X):
        # Enclosing-box surrogate (native Q2B rewrites unions to DNF).
        C, O = self._split(X)
        c = C.mean(dim=1)
        o = ((C - c[:, None, :]).abs() + O).amax(dim=1)
        return torch.cat([c, o], dim=-1)

    def negate(self, params, x):
        return mlp_apply(params, "neg", x, 2)

    def distance(self, params, q, ent_vec):
        c, o = self._split(q)
        delta = (ent_vec - c).abs()
        d_out = maximum(delta - o, 0.0).sum(dim=-1)
        d_in = torch.minimum(delta, o).sum(dim=-1)
        return d_out + self.ALPHA * d_in
