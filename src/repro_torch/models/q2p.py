"""Query2Particles (Bai et al., 2022): multi-particle query states with
attention-based particle selection for the set operators."""
from __future__ import annotations

import math

import torch

from repro_torch.models.base import QueryEncoder, mlp_apply, mlp_params, register_model


@register_model("q2p")
class Q2P(QueryEncoder):
    @property
    def np_(self) -> int:
        return self.cfg.n_particles

    @property
    def state_dim(self) -> int:
        return self.np_ * self.cfg.dim

    def init_geometry(self, generator, n_entities, n_relations):
        d, h = self.cfg.dim, self.cfg.dim * self.cfg.hidden_mult
        dev = self.device

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, device=dev) * scale

        p = {
            "relation": normal((n_relations, d), 1.0 / math.sqrt(d)),
            "particle_offsets": normal((self.np_, d), 0.1),
            "int_queries": normal((self.np_, d), 1.0 / math.sqrt(d)),
            "uni_queries": normal((self.np_, d), 1.0 / math.sqrt(d)),
        }
        p.update(mlp_params((2 * d, h, d), "proj", generator, dev))
        p.update(mlp_params((d, h, d), "neg", generator, dev))
        return p

    def _particles(self, s):
        return s.reshape(*s.shape[:-1], self.np_, self.cfg.dim)

    def _flat(self, P):
        return P.reshape(*P.shape[:-2], self.state_dim)

    def entity_state(self, params, ent_vec):
        return self._flat(ent_vec[..., None, :] + params["particle_offsets"])

    def project(self, params, x, rel_ids):
        P = self._particles(x)                                   # [n, p, d]
        r = params["relation"][rel_ids][..., None, :].expand(P.shape)
        Y = mlp_apply(params, "proj", torch.cat([P, r], dim=-1), 2)
        return self._flat(P + Y)                                 # residual move

    def _select(self, params, X, queries):
        # X: [n, k, sd] -> all particles [n, k*p, d]; attend with np learned
        # queries to re-select a fixed-size particle set.
        n, k, _ = X.shape
        allP = self._particles(X).reshape(n, k * self.np_, self.cfg.dim)
        logits = torch.einsum("pd,nmd->npm", queries, allP) / math.sqrt(self.cfg.dim)
        att = torch.softmax(logits, dim=-1)
        return self._flat(torch.einsum("npm,nmd->npd", att, allP))

    def intersect(self, params, X):
        return self._select(params, X, params["int_queries"])

    def union(self, params, X):
        return self._select(params, X, params["uni_queries"])

    def negate(self, params, x):
        return self._flat(mlp_apply(params, "neg", self._particles(x), 2))

    def distance(self, params, q, ent_vec):
        P = self._particles(q)                                    # [.., p, d]
        sims = torch.einsum("...pd,...d->...p", P, ent_vec)
        return -sims.amax(dim=-1) / math.sqrt(self.cfg.dim)
