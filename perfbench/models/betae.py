"""BetaE (Ren & Leskovec, NeurIPS 2020) for the benchmark: the weights a run
serves, made from the seed on the device under the program's parameter
names; the plain reference that judges the served answers; and the FLOPs a
query needs.

The reference is written from BetaE's equations, in plain PyTorch, one
operator after another, with no pooling, no kernels and no caches. It
imports nothing of the program. Per query node:

* anchor:      (a, b) = clip(softplus(±2 x) + 0.05), x the entity vector,
               with semantic augmentation x = 2 sigmoid(W_f [h ⊕ (z W_p +
               b_p)] + b_f) - 1 (the paper's Eq. 11 + 12);
* projection:  clip(softplus(MLP([s ⊕ r])) + 0.05), a 3d -> h -> 2d MLP;
* intersection and its union surrogate: attention over the k inputs,
               softmax(MLP(s_i)) weights a sum of the s_i (2d -> h -> 1);
* negation:    clip(1 / max(s, 0.05));
* score:       gamma - KL(Beta(a_e, b_e) || Beta(a_q, b_q)) / sqrt(d),
               summed over the d dimensions, against every entity.

clip is to [0.05, 40]. ``precision`` is ``float64`` for the judge, or
``tf32`` for the control: float32 with every matrix product in TF32 (on
the CPU emulated by rounding each operand to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.sampler import EMBED, INTERSECT, NEGATE, PROJECT, TEMPLATES, UNION

EPS, MAXP = 0.05, 40.0


def _shapes(cfg: dict, n_entities: int, n_relations: int) -> Dict[str, tuple]:
    d, h = cfg["dim"], cfg["dim"] * cfg["hidden_mult"]
    s = {"entity": (n_entities, d), "relation": (n_relations, d),
         "proj_w0": (3 * d, h), "proj_b0": (h,), "proj_w1": (h, 2 * d), "proj_b1": (2 * d,)}
    for p in ("att", "uatt"):
        s.update({f"{p}_w0": (2 * d, h), f"{p}_b0": (h,), f"{p}_w1": (h, 1), f"{p}_b1": (1,)})
    if cfg["semantic_dim"]:
        dl, dp = cfg["semantic_dim"], cfg["semantic_proj_dim"]
        s.update({"sem_table": (n_entities, dl), "sem_proj_w": (dl, dp),
                  "sem_proj_b": (dp,), "fuse_w": (d + dp, d), "fuse_b": (d,)})
    return s


def _scale(name: str, shape: tuple) -> float:
    if name in ("entity", "relation", "sem_table"):
        return 1.0 / math.sqrt(shape[1])       # rows of about unit norm
    if len(shape) == 2:
        return math.sqrt(2.0 / (shape[0] + shape[1]))   # Glorot
    return 0.1                                 # biases


def make_weights(cfg: dict, n_entities: int, n_relations: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every tensor the model serves (H_sem included), fp32, drawn from
    ``seed`` in one call on ``device`` and cut into views."""
    shapes = _shapes(cfg, n_entities, n_relations)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(_scale(name, shape))
        at += n
    return out


# ----------------------------------------------------------------- reference

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, in fp32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Reference:
    """BetaE over ``weights`` in ``precision`` (``float64`` or ``tf32``)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision must be float64 or tf32, got {precision!r}")
        self.cfg = cfg
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.w = {k: v.to(self.dtype) for k, v in weights.items()}
        self.device = next(iter(weights.values())).device
        self.emulate = precision == "tf32" and self.device.type != "cuda"
        with self._mode():
            self.ent_vec = self._entity_vectors()
            a, b = self._split(self.entity_state(self.ent_vec))
            # The entity's side of the KL, once: ln B(a_e, b_e), psi(a_e),
            # psi(b_e), psi(a_e + b_e).
            self.ent = (a, b, self._betaln(a, b), torch.digamma(a), torch.digamma(b),
                        torch.digamma(a + b))

    @contextlib.contextmanager
    def _mode(self):
        if self.precision == "tf32" and self.device.type == "cuda":
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
        else:
            old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _mm(self, a, b):
        if self.emulate:
            return _tf32(a) @ _tf32(b)
        return a @ b

    @staticmethod
    def _clip(x):
        return x.clamp(EPS, MAXP)

    @staticmethod
    def _betaln(a, b):
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)

    def _split(self, s):
        d = self.cfg["dim"]
        return s[..., :d], s[..., d:]

    def _entity_vectors(self):
        w = self.w
        x = w["entity"]
        if self.cfg["semantic_dim"]:
            z = self._mm(w["sem_table"], w["sem_proj_w"]) + w["sem_proj_b"]
            x = torch.sigmoid(self._mm(torch.cat([x, z], -1), w["fuse_w"]) + w["fuse_b"]) * 2 - 1
        return x

    def entity_state(self, x):
        return torch.cat([self._clip(torch.nn.functional.softplus(2 * x) + EPS),
                          self._clip(torch.nn.functional.softplus(-2 * x) + EPS)], -1)

    def _mlp(self, x, prefix):
        w = self.w
        h = torch.relu(self._mm(x, w[f"{prefix}_w0"]) + w[f"{prefix}_b0"])
        return self._mm(h, w[f"{prefix}_w1"]) + w[f"{prefix}_b1"]

    def _attention(self, xs: List[torch.Tensor], prefix: str):
        X = torch.stack(xs, 1)                                 # [n, k, 2d]
        att = torch.softmax(self._mlp(X, prefix), dim=1)       # [n, k, 1]
        return self._clip((att * X).sum(1))

    def encode(self, pattern: str, anchors: np.ndarray, relations: np.ndarray):
        """Query states [n, 2d] of n queries of one pattern (anchors [n,
        n_anchors], relations [n, n_relations])."""
        a = torch.as_tensor(anchors, device=self.device)
        r = torch.as_tensor(relations, device=self.device)
        states, ai, ri = [], 0, 0
        with self._mode():
            for op, inputs in TEMPLATES[pattern]:
                if op == EMBED:
                    s = self.entity_state(self.ent_vec[a[:, ai]])
                    ai += 1
                elif op == PROJECT:
                    y = self._mlp(torch.cat([states[inputs[0]], self.w["relation"][r[:, ri]]], -1),
                                  "proj")
                    s = self._clip(torch.nn.functional.softplus(y) + EPS)
                    ri += 1
                elif op == NEGATE:
                    s = self._clip(1.0 / states[inputs[0]].clamp_min(EPS))
                elif op == INTERSECT:
                    s = self._attention([states[j] for j in inputs], "att")
                else:
                    assert op == UNION
                    s = self._attention([states[j] for j in inputs], "uatt")
                states.append(s)
        return states[-1]

    def scores(self, q: torch.Tensor, block: int = 4) -> torch.Tensor:
        """gamma - KL(entity || query) / sqrt(d) against every entity, [n, E],
        ``block`` queries at a time."""
        ae, be, lnb_e, pa, pb, ps = self.ent
        aq, bq = self._split(q)
        out = []
        for i in range(0, q.shape[0], block):
            a, b = aq[i:i + block, None, :], bq[i:i + block, None, :]
            kl = (self._betaln(a, b) - lnb_e + (ae - a) * pa + (be - b) * pb
                  + (a - ae + b - be) * ps)
            out.append(self.cfg["gamma"] - kl.sum(-1) / math.sqrt(self.cfg["dim"]))
        return torch.cat(out)


def reference_scores(ref: Reference, queries: Sequence) -> torch.Tensor:
    """All-entity scores [n, E] of ``queries`` (perfbench.sampler.Query), in
    their order, pattern by pattern."""
    out = [None] * len(queries)
    by_pattern: Dict[str, List[int]] = {}
    for i, q in enumerate(queries):
        by_pattern.setdefault(q.pattern, []).append(i)
    for pattern, idx in by_pattern.items():
        anchors = np.array([queries[i].anchors for i in idx], dtype=np.int64)
        rels = np.array([queries[i].relations for i in idx], dtype=np.int64)
        s = ref.scores(ref.encode(pattern, anchors, rels))
        for j, i in enumerate(idx):
            out[i] = s[j]
    return torch.stack(out)


# ---------------------------------------------------------------------- FLOPs

def query_flops(cfg: dict, pattern: str, n_entities: int) -> float:
    """FLOPs one query needs, counted from shapes (a multiply-add is two):
    its projections' and attentions' matrix products, the fusion of its
    anchors with semantic augmentation, and the KL's query-entity terms
    against every entity (2d multiply-adds an entity; what depends on the
    entity alone or the query alone is not counted per pair)."""
    d, h = cfg["dim"], cfg["dim"] * cfg["hidden_mult"]
    sd = 2 * d
    flops = 0.0
    for op, inputs in TEMPLATES[pattern]:
        if op == EMBED and cfg["semantic_dim"]:
            dl, dp = cfg["semantic_dim"], cfg["semantic_proj_dim"]
            flops += 2 * dl * dp + 2 * (d + dp) * d
        elif op == PROJECT:
            flops += 2 * (3 * d * h + h * sd)
        elif op in (INTERSECT, UNION):
            k = len(inputs)
            flops += k * (2 * sd * h + 2 * h) + 2 * k * sd
    return flops + 2 * sd * n_entities
