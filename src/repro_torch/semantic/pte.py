"""Pre-trained Text Encoder (PTE) substrate — §4.4.

The system runs offline, so Qwen3-Embedding is stood in by a small
deterministic transformer encoder over synthetic "descriptions" (token
sequences derived from an entity's id and graph neighborhood). The system
treats H_sem as an opaque [E, d_l] buffer either way, so every systems claim
(decoupled offline encode, unload, device-resident gather) is exercised for
real; only the linguistic content is synthetic.

Descriptions mention neighbor entities, so entities that co-occur in the
graph get nearby embeddings — the same reason real textual priors help on
sparse KGs.

The encoder runs on the GPU (``cuda`` unless given a device); tokenization,
the L2 normalisation and the one-hop neighbour smoothing run on the host in
numpy, in the JAX package's order, so the streaming store and the in-memory
table stay bit-identical to each other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.data.kg import KnowledgeGraph
from repro_torch.device import resolve_device

_DESC_LEN = 16
_VOCAB = 4096


@dataclasses.dataclass
class PTEConfig:
    name: str = "stub-qwen3-embedding-0.6b"
    d_l: int = 1024        # Qwen3-Embedding-0.6B output dim
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    seed: int = 1234


class StubPTE(nn.Module):
    """Frozen stub encoder with a real (small) transformer forward pass.

    Its parameters carry the JAX package's names (``tok``, ``pos``,
    ``out_w``, ``out_b``, ``l{i}_qkv``, ``l{i}_o``, ``l{i}_up``,
    ``l{i}_down``). They are drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` on ``device``, or taken from ``params`` (numpy arrays, e.g.
    the JAX stub's) when given."""

    def __init__(self, cfg: PTEConfig = PTEConfig(), device=None,
                 params: Optional[Mapping[str, np.ndarray]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        d, h = cfg.d_model, cfg.d_model * 4
        shapes = {"tok": (_VOCAB, d), "pos": (_DESC_LEN, d),
                  "out_w": (d, cfg.d_l), "out_b": (cfg.d_l,)}
        for i in range(cfg.n_layers):
            shapes.update({f"l{i}_qkv": (d, 3 * d), f"l{i}_o": (d, d),
                           f"l{i}_up": (d, h), f"l{i}_down": (h, d)})
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            s = 1.0 / math.sqrt(d)
            params = {k: (torch.zeros(shape, device=self.device) if k == "out_b"
                          else torch.randn(shape, generator=gen,
                                           device=self.device) * s)
                      for k, shape in shapes.items()}
        for k, shape in shapes.items():
            t = params[k]
            if not isinstance(t, torch.Tensor):
                t = torch.tensor(np.asarray(t, dtype=np.float32))
            t = t.to(self.device, torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"PTE param {k}: shape {tuple(t.shape)} != {shape}")
            self.register_parameter(k, nn.Parameter(t, requires_grad=False))
        self.unloaded = False

    # -- synthetic descriptions ------------------------------------------------
    @staticmethod
    def descriptions(kg: KnowledgeGraph, ent_ids: np.ndarray) -> np.ndarray:
        """Token sequence per entity: hashed id tokens + first neighbors, one
        numpy pass per neighbor position."""
        indptr, rels, tails = kg.relations_by_head
        ids = np.asarray(ent_ids, dtype=np.int64).ravel()
        toks = np.zeros((len(ids), _DESC_LEN), dtype=np.int32)
        toks[:, 0] = ids % _VOCAB
        # (e * K) % V == ((e % V) * (K % V)) % V — overflow-safe in int64.
        toks[:, 1] = (ids % _VOCAB) * (2654435761 % _VOCAB) % _VOCAB
        lo = indptr[ids]
        max_pairs = (_DESC_LEN - 2) // 2
        deg = np.minimum(indptr[ids + 1] - lo, max_pairs)
        for j in range(max_pairs):
            m = deg > j
            if not m.any():
                break
            src = lo[m] + j
            toks[m, 2 + 2 * j] = rels[src] % _VOCAB
            toks[m, 3 + 2 * j] = tails[src] % _VOCAB
        return toks

    # -- forward ---------------------------------------------------------------
    @torch.no_grad()
    def encode_tokens(self, tokens) -> torch.Tensor:
        """tokens [B, 16] (numpy or tensor) -> [B, d_l] fp32 on the PTE's
        device."""
        if self.unloaded:
            raise RuntimeError("PTE has been unloaded (decoupled phase ended)")
        p = dict(self.named_parameters())
        tokens = torch.as_tensor(np.asarray(tokens, dtype=np.int64)
                                 if isinstance(tokens, np.ndarray) else tokens,
                                 device=self.device)
        x = p["tok"][tokens] + p["pos"][None, :, :]
        d, nh = self.cfg.d_model, self.cfg.n_heads
        hd = d // nh
        for i in range(self.cfg.n_layers):
            q, k, v = torch.split(x @ p[f"l{i}_qkv"], d, dim=-1)

            def heads(t):
                return t.reshape(t.shape[0], t.shape[1], nh, hd).transpose(1, 2)

            q, k, v = heads(q), heads(k), heads(v)
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
            o = (att @ v).transpose(1, 2).reshape(x.shape)
            x = x + o @ p[f"l{i}_o"]
            # jax.nn.gelu's default is the tanh approximation.
            x = x + F.gelu(x @ p[f"l{i}_up"], approximate="tanh") @ p[f"l{i}_down"]
        pooled = x.mean(dim=1)
        return pooled @ p["out_w"] + p["out_b"]

    def encode_entities(self, kg: KnowledgeGraph, ent_ids: np.ndarray) -> torch.Tensor:
        """[len(ent_ids), d_l] encodings of the entities' descriptions."""
        return self.encode_tokens(self.descriptions(kg, ent_ids))

    def unload(self) -> None:
        """§4.4: 'once H_sem is generated, the PTE is unloaded from memory'."""
        for name in list(self._parameters):
            del self._parameters[name]
        self.unloaded = True


def encode_normalized_batches(kg: KnowledgeGraph, pte: StubPTE,
                              batch_size: int = 256):
    """Yield L2-normalized encoder outputs (host fp32) in fixed global batch
    boundaries ``range(0, E, batch_size)``. Shared by the in-memory
    ``precompute_semantic_table`` and the streaming
    ``semantic/store.py::precompute_semantic_table_to_store``, so the encoder
    sees identical shapes and the two stay bit-identical; normalization is
    per-row, hence batch-local."""
    ids = np.arange(kg.n_entities)
    for lo in range(0, kg.n_entities, batch_size):
        chunk = ids[lo: lo + batch_size]
        block = pte.encode_tokens(StubPTE.descriptions(kg, chunk)).cpu().numpy()
        block /= np.linalg.norm(block, axis=1, keepdims=True) + 1e-6
        yield block


def precompute_semantic_table(
    kg: KnowledgeGraph,
    pte: Optional[StubPTE] = None,
    batch_size: int = 256,
    unload: bool = True,
    smooth: float = 0.5,
) -> np.ndarray:
    """Offline pre-computation phase (Eq. 10): encode every entity, L2
    normalize, then one hop of neighbor smoothing. Returns host numpy
    [E, d_l] fp32.

    This is the full-resident path (small graphs). At scale, use
    ``semantic/store.py::precompute_semantic_table_to_store``, which streams
    the same computation shard by shard to disk and gives bit-identical fp32
    rows."""
    pte = pte or StubPTE()
    table = np.concatenate(
        list(encode_normalized_batches(kg, pte, batch_size)), axis=0)
    if smooth > 0:
        nb = np.zeros_like(table)
        cnt = np.ones((kg.n_entities, 1))
        np.add.at(nb, kg.triples[:, 0], table[kg.triples[:, 2]])
        np.add.at(cnt, kg.triples[:, 0], 1.0)
        np.add.at(nb, kg.triples[:, 2], table[kg.triples[:, 0]])
        np.add.at(cnt, kg.triples[:, 2], 1.0)
        table = table + smooth * nb / cnt
        table /= np.linalg.norm(table, axis=1, keepdims=True) + 1e-6
    if unload:
        pte.unload()
    return table.astype(np.float32)
