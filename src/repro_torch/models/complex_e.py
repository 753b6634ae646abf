"""ComplEx (Trouillon et al., 2016) as a QueryEncoder — the Table 2 single-hop
model. Projection is the complex Hadamard rotation; the set operators are
simple elementwise surrogates (ComplEx is a 1p model; the surrogates just
keep every pattern runnable)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.base import QueryEncoder, register_model


@register_model("complex")
class ComplExE(QueryEncoder):
    score_mode = "dot"  # Re<q, conj(e)> == plain dot in this layout

    @property
    def state_dim(self) -> int:
        return self.cfg.dim  # dim/2 real + dim/2 imaginary

    def init_geometry(self, generator, n_entities, n_relations):
        return {"relation": torch.randn((n_relations, self.cfg.dim),
                                        generator=generator, device=self.device)
                / math.sqrt(self.cfg.dim)}

    def _split(self, s):
        d = self.cfg.dim // 2
        return s[..., :d], s[..., d:]

    def entity_state(self, params, ent_vec):
        return ent_vec

    def project(self, params, x, rel_ids):
        xr, xi = self._split(x)
        rr, ri = self._split(params["relation"][rel_ids])
        return torch.cat([xr * rr - xi * ri, xr * ri + xi * rr], dim=-1)

    def intersect(self, params, X):
        return X.amin(dim=1)

    def union(self, params, X):
        return X.amax(dim=1)

    def negate(self, params, x):
        return -x

    def distance(self, params, q, ent_vec):
        qr, qi = self._split(q)
        er, ei = self._split(ent_vec)
        return -(qr * er + qi * ei).sum(dim=-1)  # -Re<q, conj(e)>
