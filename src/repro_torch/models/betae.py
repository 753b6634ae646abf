"""BetaE (Ren & Leskovec, 2020): Beta-distribution embeddings with closed-form
negation (reciprocal parameters) and attention-weighted intersection.

``distance`` takes ``betaln`` as ``lgamma(a) + lgamma(b) - lgamma(a + b)``
and ``torch.digamma``; over BetaE's clip range [0.05, 40] in fp32 these
differ from ``jax.scipy.special.betaln``/``digamma`` by up to 5.3e-5 and
7.6e-6, so ``distance`` and ``score_all`` agree with the JAX package only to
a looser tolerance than the other operators (stated in the port's tests).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.base import (QueryEncoder, clip, maximum, mlp_apply, mlp_params,
                                     register_model)

_EPS = 0.05
_MAXP = 40.0


def _clip(p):
    return clip(p, _EPS, _MAXP)


def betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


@register_model("betae")
class BetaE(QueryEncoder):
    @property
    def state_dim(self) -> int:
        return 2 * self.cfg.dim

    def init_geometry(self, generator, n_entities, n_relations):
        d, h = self.cfg.dim, self.cfg.dim * self.cfg.hidden_mult
        p = {"relation": torch.randn((n_relations, d), generator=generator,
                                     device=self.device) / math.sqrt(d)}
        p.update(mlp_params((3 * d, h, 2 * d), "proj", generator, self.device))
        p.update(mlp_params((2 * d, h, 1), "att", generator, self.device))
        p.update(mlp_params((2 * d, h, 1), "uatt", generator, self.device))
        return p

    def _split(self, s):
        d = self.cfg.dim
        return s[..., :d], s[..., d:]

    def entity_state(self, params, ent_vec):
        # Sufficient statistics from the joint embedding (Eq. 3): the entity
        # vector parameterizes (alpha, beta) via a smooth positive map.
        a = _clip(F.softplus(ent_vec * 2.0) + _EPS)
        b = _clip(F.softplus(-ent_vec * 2.0) + _EPS)
        return torch.cat([a, b], dim=-1)

    def project(self, params, x, rel_ids):
        r = params["relation"][rel_ids]
        y = mlp_apply(params, "proj", torch.cat([x, r], dim=-1), 2)
        return _clip(F.softplus(y) + _EPS)

    def _attn_combine(self, params, X, prefix):
        # cardinality-class fused kernel (one block per pool row, Eq. 8/9)
        return _clip(kops.intersect(
            X, params[f"{prefix}_w0"], params[f"{prefix}_b0"],
            params[f"{prefix}_w1"], params[f"{prefix}_b1"]))

    def intersect(self, params, X):
        return self._attn_combine(params, X, "att")

    def union(self, params, X):
        # Mixture surrogate (native BetaE rewrites unions to DNF).
        return self._attn_combine(params, X, "uatt")

    def negate(self, params, x):
        return _clip(1.0 / maximum(x, _EPS))

    def distance(self, params, q, ent_vec):
        ae, be = self._split(self.entity_state(params, ent_vec))
        aq, bq = self._split(q)
        aq, bq = _clip(aq), _clip(bq)
        # KL( Beta(ae,be) || Beta(aq,bq) ), summed over dims.
        kl = (
            betaln(aq, bq)
            - betaln(ae, be)
            + (ae - aq) * torch.digamma(ae)
            + (be - bq) * torch.digamma(be)
            + (aq - ae + bq - be) * torch.digamma(ae + be)
        )
        return kl.sum(dim=-1) / math.sqrt(self.cfg.dim)
