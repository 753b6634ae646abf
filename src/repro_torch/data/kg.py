"""Knowledge-graph storage, read side: triple store + CSR adjacency +
synthetic generators.

The container is offline, so the paper's six benchmark KGs (Table 4) are
synthetic graphs of the same family (power-law degrees):

  * ``full``    — the Table 4 entity, relation and training-triple counts
                  (FB15k: 14,951 entities, 1,345 relations, 483,142 triples);
                  the shape the GPU serving path runs at.
  * ``reduced`` — small stand-ins (``REDUCED_SCALE``) for CPU tests.

Same seed ⇒ same graph as the JAX package's ``data/kg.py``: the generator
draws the same numpy random stream, so samplers and compilers built on the
two graphs agree exactly.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KGStats:
    """Table 4 row."""

    name: str
    n_entities: int
    n_relations: int
    n_train: int
    n_valid: int
    n_test: int

    @property
    def n_total(self) -> int:
        return self.n_train + self.n_valid + self.n_test


# Exact statistics from Table 4 of the paper.
TABLE4: Dict[str, KGStats] = {
    "FB15k": KGStats("FB15k", 14_951, 1_345, 483_142, 50_000, 59_071),
    "FB15k-237": KGStats("FB15k-237", 14_505, 237, 272_115, 17_526, 20_438),
    "NELL995": KGStats("NELL995", 63_361, 200, 114_213, 14_324, 14_267),
    "FB400k": KGStats("FB400k", 409_829, 918, 1_075_837, 537_917, 537_917),
    "ogbl-wikikg2": KGStats("ogbl-wikikg2", 2_500_604, 535, 16_109_182, 429_456, 598_543),
    "ATLAS-Wiki-Triple-4M": KGStats(
        "ATLAS-Wiki-Triple-4M", 4_035_238, 512_064, 23_040_868, 2_880_108, 2_880_110
    ),
}


def _build_adjacency(triples: np.ndarray, n_relations: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup + sort by (h, r, t) and index by (h, r).

    Ordering/dedup uses ``np.lexsort`` over the COLUMNS — the composite key
    ``(h*R + r)*E + t`` would overflow int64 at ATLAS-Wiki-Triple-4M scale.
    The 2-term ``h*R + r`` index stays safe to E·R ≈ 9.2e18 and is checked.
    Returns ``(triples, hr, tails)``.
    """
    tri = np.asarray(triples, dtype=np.int64)
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(f"triples must be [n, 3], got {tri.shape}")
    order = np.lexsort((tri[:, 2], tri[:, 1], tri[:, 0]))
    tri = tri[order]
    if len(tri):
        keep = np.concatenate([[True], np.any(tri[1:] != tri[:-1], axis=1)])
        tri = tri[keep]
        if tri[:, 0].max() > (np.iinfo(np.int64).max - n_relations) // max(n_relations, 1):
            raise ValueError("h * n_relations + r overflows int64")
    tri = np.ascontiguousarray(tri)
    return tri, tri[:, 0] * n_relations + tri[:, 1], np.ascontiguousarray(tri[:, 2])


class KnowledgeGraph:
    """Immutable triple store with CSR adjacency for fast traversal.

    Adjacency is keyed by (head, relation) via a sorted (h * R + r) index so
    ``neighbors(h, r)`` is two binary searches — the access pattern the online
    sampler (App. F) hammers.
    """

    def __init__(self, n_entities: int, n_relations: int, triples: np.ndarray,
                 name: str = "kg"):
        self.name = name
        self.n_entities = int(n_entities)
        self.n_relations = int(n_relations)
        self.triples, self._hr, self._tails = _build_adjacency(
            triples, self.n_relations)

    def __len__(self) -> int:
        return self.triples.shape[0]

    def neighbors(self, h: int, r: int) -> np.ndarray:
        """All tails t with (h, r, t) in the graph."""
        hr = h * self.n_relations + r
        lo = np.searchsorted(self._hr, hr, side="left")
        hi = np.searchsorted(self._hr, hr, side="right")
        return self._tails[lo:hi]

    def neighbors_of_set(self, heads: np.ndarray, r: int) -> np.ndarray:
        """Union of tails over a set of heads for one relation (Project op)."""
        if len(heads) == 0:
            return np.empty((0,), dtype=np.int64)
        hr = np.asarray(heads, dtype=np.int64) * self.n_relations + r
        lo = np.searchsorted(self._hr, hr, side="left")
        hi = np.searchsorted(self._hr, hr, side="right")
        parts = [self._tails[a:b] for a, b in zip(lo, hi) if b > a]
        if not parts:
            return np.empty((0,), dtype=np.int64)
        return np.unique(np.concatenate(parts))

    def contains(self, rows: np.ndarray) -> np.ndarray:
        """Boolean membership per (h, r, t) row. Within one (h, r) span the
        tails are sorted, so each row is two binary searches on ``hr`` plus
        one on its span."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
        hr = rows[:, 0] * self.n_relations + rows[:, 1]
        lo = np.searchsorted(self._hr, hr, side="left")
        hi = np.searchsorted(self._hr, hr, side="right")
        out = np.zeros(len(rows), dtype=bool)
        for i in np.nonzero(hi > lo)[0]:
            span = self._tails[lo[i]:hi[i]]
            j = np.searchsorted(span, rows[i, 2])
            out[i] = j < len(span) and span[j] == rows[i, 2]
        return out

    @cached_property
    def degree(self) -> np.ndarray:
        deg = np.zeros(self.n_entities, dtype=np.int64)
        np.add.at(deg, self.triples[:, 0], 1)
        np.add.at(deg, self.triples[:, 2], 1)
        return deg

    @cached_property
    def incoming_by_tail(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR (indptr, relations, heads) grouped by tail — used by the online
        sampler's backward ground-truth instantiation (App. F)."""
        order = np.argsort(self.triples[:, 2], kind="stable")
        tails = self.triples[order, 2]
        indptr = np.searchsorted(tails, np.arange(self.n_entities + 1))
        return indptr, self.triples[order, 1], self.triples[order, 0]

    @cached_property
    def entities_with_incoming(self) -> np.ndarray:
        return np.unique(self.triples[:, 2])


def generate_synthetic_kg(
    n_entities: int,
    n_relations: int,
    n_triples: int,
    seed: int = 0,
    hub_exponent: float = 0.8,
    name: str = "synthetic",
) -> KnowledgeGraph:
    """Power-law synthetic KG (degree-weighted, matching App. C's sampling).

    Head/tail entities are drawn from a Zipf-like distribution so the graph
    has hub structure like FB15k/wikikg2; relation usage is also skewed.
    """
    rng = np.random.default_rng(seed)
    ent_w = (np.arange(1, n_entities + 1, dtype=np.float64)) ** (-hub_exponent)
    ent_p = ent_w / ent_w.sum()
    rel_w = (np.arange(1, n_relations + 1, dtype=np.float64)) ** (-0.5)
    rel_p = rel_w / rel_w.sum()
    # Oversample then dedup to hit ~n_triples unique triples.
    m = int(n_triples * 1.3) + 16
    h = rng.choice(n_entities, size=m, p=ent_p)
    t = rng.choice(n_entities, size=m, p=ent_p)
    r = rng.choice(n_relations, size=m, p=rel_p)
    tri = np.stack([h, r, t], axis=1)
    kg = KnowledgeGraph(n_entities, n_relations, tri, name=name)
    if len(kg) > n_triples:
        keep = rng.choice(len(kg), size=n_triples, replace=False)
        kg = KnowledgeGraph(n_entities, n_relations, kg.triples[keep], name=name)
    return kg


def split_kg(kg: KnowledgeGraph, valid_frac: float = 0.05, test_frac: float = 0.05, seed: int = 0):
    """Edge split into (train_kg, valid_edges, test_edges) — the Predictive
    Query Answering setting: G_train ⊂ G_full."""
    rng = np.random.default_rng(seed)
    n = len(kg)
    perm = rng.permutation(n)
    n_valid = int(n * valid_frac)
    n_test = int(n * test_frac)
    valid = kg.triples[perm[:n_valid]]
    test = kg.triples[perm[n_valid : n_valid + n_test]]
    train = kg.triples[perm[n_valid + n_test :]]
    train_kg = KnowledgeGraph(kg.n_entities, kg.n_relations, train, name=kg.name + "-train")
    return train_kg, valid, test


# Reduced stand-ins used on CPU (same family, ~1000x smaller).
REDUCED_SCALE: Dict[str, Tuple[int, int, int]] = {
    # name -> (entities, relations, triples)
    "FB15k": (600, 40, 8000),
    "FB15k-237": (580, 24, 5000),
    "NELL995": (900, 20, 2500),
    "FB400k": (2000, 60, 9000),
    "ogbl-wikikg2": (4000, 50, 24000),
    "ATLAS-Wiki-Triple-4M": (6000, 200, 34000),
}


def load_dataset(name: str, reduced: bool = True, seed: int = 0):
    """Returns (train_kg, full_kg, stats). ``reduced`` picks the small CPU
    stand-in (the JAX package's only mode); ``reduced=False`` generates the
    synthetic graph at the Table 4 entity, relation and training-triple
    counts."""
    stats = TABLE4[name]
    if reduced:
        e, r, t = REDUCED_SCALE[name]
    else:
        e, r, t = stats.n_entities, stats.n_relations, stats.n_train
    full = generate_synthetic_kg(e, r, t, seed=seed, name=name)
    train_kg, _, _ = split_kg(full, seed=seed)
    return train_kg, full, stats
