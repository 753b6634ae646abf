"""The benchmark's frozen copy of the port's synthetic knowledge graph.

``generate_synthetic_kg`` draws the same numpy random stream as
``repro_torch.data.kg.generate_synthetic_kg`` (and the JAX package's), so
one seed gives the same triples; ``tests/test_perfbench_frozen.py`` holds
it to the port. Only what the query sampler reads is kept: the deduped,
sorted triples, the (head, relation) index, the incoming CSR by tail and the
degrees. The graph never changes after it is built.

A graph is a dataset here: its seed is fixed in the configuration, and the
triples may be kept in a cache file (``load_or_generate``) so that a run
after the first one skips the generator.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np


class Graph:
    """Deduped triples sorted by (h, r, t), indexed for the sampler."""

    def __init__(self, n_entities: int, n_relations: int, triples: np.ndarray):
        tri = np.asarray(triples, dtype=np.int64)
        if tri.ndim != 2 or tri.shape[1] != 3:
            raise ValueError(f"triples must be [n, 3], got {tri.shape}")
        order = np.lexsort((tri[:, 2], tri[:, 1], tri[:, 0]))
        tri = tri[order]
        if len(tri):
            keep = np.concatenate([[True], np.any(tri[1:] != tri[:-1], axis=1)])
            tri = tri[keep]
        self.n_entities = int(n_entities)
        self.n_relations = int(n_relations)
        self.triples = np.ascontiguousarray(tri)
        self.hr = self.triples[:, 0] * self.n_relations + self.triples[:, 1]
        self.tails = np.ascontiguousarray(self.triples[:, 2])
        order = np.argsort(self.triples[:, 2], kind="stable")
        tails = self.triples[order, 2]
        self.in_indptr = np.searchsorted(tails, np.arange(self.n_entities + 1))
        self.in_rels = self.triples[order, 1]
        self.in_heads = self.triples[order, 0]
        deg = np.zeros(self.n_entities, dtype=np.int64)
        np.add.at(deg, self.triples[:, 0], 1)
        np.add.at(deg, self.triples[:, 2], 1)
        self.degree = deg
        self.entities_with_incoming = np.unique(self.triples[:, 2])

    def neighbors_of_set(self, heads: np.ndarray, r: int) -> np.ndarray:
        """Sorted union of the tails of ``heads`` under relation ``r``."""
        if len(heads) == 0:
            return np.empty((0,), dtype=np.int64)
        hr = np.asarray(heads, dtype=np.int64) * self.n_relations + r
        lo = np.searchsorted(self.hr, hr, side="left")
        hi = np.searchsorted(self.hr, hr, side="right")
        parts = [self.tails[a:b] for a, b in zip(lo, hi) if b > a]
        if not parts:
            return np.empty((0,), dtype=np.int64)
        return np.unique(np.concatenate(parts))


def generate_triples(n_entities: int, n_relations: int, n_triples: int,
                     seed: int = 0, hub_exponent: float = 0.8) -> np.ndarray:
    """Power-law triples: Zipf-like heads and tails, skewed relations,
    oversampled then deduped and cut to ``n_triples`` (the port's
    generator, step for step)."""
    rng = np.random.default_rng(seed)
    ent_w = (np.arange(1, n_entities + 1, dtype=np.float64)) ** (-hub_exponent)
    ent_p = ent_w / ent_w.sum()
    rel_w = (np.arange(1, n_relations + 1, dtype=np.float64)) ** (-0.5)
    rel_p = rel_w / rel_w.sum()
    m = int(n_triples * 1.3) + 16
    h = rng.choice(n_entities, size=m, p=ent_p)
    t = rng.choice(n_entities, size=m, p=ent_p)
    r = rng.choice(n_relations, size=m, p=rel_p)
    tri = Graph(n_entities, n_relations, np.stack([h, r, t], axis=1)).triples
    if len(tri) > n_triples:
        keep = rng.choice(len(tri), size=n_triples, replace=False)
        tri = tri[keep]
    return tri


def generate_synthetic_kg(n_entities: int, n_relations: int, n_triples: int,
                          seed: int = 0, hub_exponent: float = 0.8) -> Graph:
    return Graph(n_entities, n_relations,
                 generate_triples(n_entities, n_relations, n_triples, seed, hub_exponent))


def load_or_generate(spec: dict, cache_dir: Path | None) -> Graph:
    """The graph of a configuration's ``graph`` block. With ``cache_dir`` the
    triples are kept in a file named by a hash of the block and of this
    module's source, written once (to a temporary name, then renamed)."""
    args = (int(spec["n_entities"]), int(spec["n_relations"]), int(spec["n_triples"]),
            int(spec["seed"]), float(spec.get("hub_exponent", 0.8)))
    if cache_dir is None:
        return generate_synthetic_kg(*args)
    h = hashlib.sha256(json.dumps(args).encode())
    h.update(Path(__file__).read_bytes())
    path = Path(cache_dir) / f"graph_{h.hexdigest()[:16]}.npy"
    if path.is_file():
        return Graph(args[0], args[1], np.load(path))
    tri = generate_triples(*args)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.save(f, tri)
    os.replace(tmp, path)
    return Graph(args[0], args[1], tri)
