"""The LM zoo's programs over a mesh, written rank-local: what the JAX
package leaves to XLA's SPMD partitioner (``jit`` with ``in_shardings``, the
``seq_shard`` constraint, ``shard_map`` in ``lm/moe.py``), done by hand on one
rank's shards.

A ``MeshPlan`` holds one step's view of its mesh (a ``ProcessMesh``, or a
``VirtualMesh`` for the dry run): the profile (``fsdp`` when ``model`` is
among the dp axes, else ``2d``), the axes the global batch is split over
(``sharding.batch_spec``) and this rank's rows of it, and each parameter's
spec (``sharding.profile_spec`` on the full shapes of ``abstract_params``).
Parameters arrive as the rank's shards; ``layer`` turns a layer's shards
into the tensors it computes with:

* every axis a weight is split over is all-gathered before use (FSDP), save
  ``model`` where the layer is computed split over it (tensor parallelism,
  ``2d`` only): attention heads (``wq``/``bq``/``wo``, and ``wk``/``wv``/
  ``bk``/``bv`` where the KV heads divide; otherwise each rank takes the
  whole KV weights and the KV heads its query heads need), the MLP's and
  the experts' F (``tp``) or experts (``ep``), the vocabulary of ``embed``
  and ``lm_head``;
* a layer whose weights the rules split off whole heads (a ``model`` axis
  that divides h·hd but not h, as whisper's 20 heads on 16 ways; Mamba2's
  ``in_proj``/``out_proj``/``conv_w`` and SSM vectors, whose split cuts a
  concatenation) gets them whole and is computed replicated over ``model``.

The collectives are autograd functions with Megatron's semantics: a
replicated value entering a region computed split over ``model`` passes
``copy_in`` (identity; the backward sums its partial gradients), a partial
result leaves by ``row_sum`` (all-reduce; the backward passes the replicated
gradient), so every replicated tensor carries the same gradient on every
member of ``model``. The backward issues its collectives in the order autograd
runs their nodes, which follows the order they were made in: every rank
builds them in one order (no iteration over a set). A gathered weight's backward sums its gradient over the
batch axes (one all-reduce) and keeps the rank's block; the train step
all-reduces the gradients of the shards that were used as they are
(``MeshPlan.gathered`` names the others).

``seq_shard`` (``2d``, S divisible by ``model``): the residual stream holds
S/m of the sequence between repetitions; a repetition all-gathers it first,
and its last residual sum becomes a reduce-scatter along S where the last
sublayer is split over ``model``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import batch_spec, cache_spec, profile_spec

MODEL = ("model",)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _blocks_in_order(mesh, pieces, axes):
    """``all_gather``'s pieces (ascending rank order) in block order."""
    order = [mesh.index(axes, r) for r in mesh.members(axes)]
    return [pieces[j] for j in np.argsort(order, kind="stable")]


# ------------------------------------------------------------ collectives
class _RowSum(torch.autograd.Function):
    """Partial sums over ``axes`` -> their total on every member (forward
    all-reduce); the backward passes the replicated gradient through."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyIn(torch.autograd.Function):
    """A replicated value into a region computed split over ``axes``: the
    identity forward; the backward sums the members' partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes), None, None


class _GatherDim(torch.autograd.Function):
    """Each member's block along ``dim`` -> the whole tensor on every
    member; the backward keeps this rank's block of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return torch.cat(_blocks_in_order(mesh, mesh.all_gather(x, axes), axes), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None, None


class _SplitDim(torch.autograd.Function):
    """A replicated tensor -> this rank's block along ``dim``; the backward
    all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = x.shape[dim] // mesh.ways(axes)
        return x.narrow(dim, mesh.index(axes) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        m, axes = ctx.mesh, ctx.axes
        return torch.cat(_blocks_in_order(m, m.all_gather(g.contiguous(), axes), axes),
                         dim=ctx.dim), None, None, None


class _ScatterDim(torch.autograd.Function):
    """Partial sums -> this rank's block of their total along ``dim``
    (reduce-scatter); the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(x.contiguous(), axes, dim)

    @staticmethod
    def backward(ctx, g):
        m, axes = ctx.mesh, ctx.axes
        return torch.cat(_blocks_in_order(m, m.all_gather(g.contiguous(), axes), axes),
                         dim=ctx.dim), None, None, None


def _assemble(mesh, local: torch.Tensor, dims) -> torch.Tensor:
    """The tensor whose blocks along ``dims`` ([(dim, axes)], each block
    indexed major-to-minor over its axes) the members hold, from one
    all-gather over the union of the axes. The pieces come in ascending rank
    order, which is row-major over the union in mesh order: stacked, each
    axis goes beside its dim, major to minor."""
    union = tuple(a for a in mesh.axis_names if any(a in ax for _, ax in dims))
    grid = mesh.all_gather_tensor(local, union).reshape(
        [mesh.shape[a] for a in union] + list(local.shape))
    by_dim = dict(dims)
    perm, shape = [], []
    for d, n in enumerate(local.shape):
        axes = by_dim.get(d, ())
        perm += [union.index(a) for a in axes] + [len(union) + d]
        shape.append(n * mesh.ways(axes))
    return grid.permute(perm).reshape(shape)


class _GatherWeight(torch.autograd.Function):
    """A parameter's shard -> the tensor its layer computes with, gathered
    along ``dims``. The backward sums the gradient over the batch axes (one
    all-reduce of the gathered tensor) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, local, plan, dims):
        ctx.plan, ctx.dims, ctx.shape = plan, dims, tuple(local.shape)
        return _assemble(plan.mesh, local, dims)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = g.contiguous()
        if plan.batch_axes:
            g = plan.mesh.all_reduce(g.clone(), plan.batch_axes)
        for d, ax in ctx.dims:
            n = ctx.shape[d]
            g = g.narrow(d, plan.mesh.index(ax) * n, n)
        return g.contiguous(), None, None


# ------------------------------------------------------------------ layout
@dataclasses.dataclass(frozen=True)
class Heads:
    """An attention sublayer split over ``model``: this rank's ``h`` query
    heads, and the ``kv`` KV heads they attend with, from ``kv0`` of all KV
    heads; ``kv_split`` when the KV weights hold just those."""

    h: int
    kv: int
    kv0: int
    kv_split: bool


@dataclasses.dataclass(frozen=True)
class Layout:
    attn: Optional[Heads] = None     # self-attention, split over model
    xattn: Optional[Heads] = None    # cross-attention, split over model
    ffn: bool = False                # the MLP or experts split over model


@functools.lru_cache(maxsize=None)
def _full_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    from repro_torch.lm.model import abstract_params

    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = tuple(v.shape)

    walk(abstract_params(cfg), "")
    return out


class MeshPlan:
    """One rank's program over ``mesh`` for a global batch of ``batch``
    rows (module docstring). ``dp_axes`` are the profile's data-parallel
    axes (``sharding.dp_axes(mesh, profile)``)."""

    def __init__(self, cfg, mesh, dp_axes: Sequence[str], batch: int):
        self.cfg, self.mesh = cfg, mesh
        self.dp = tuple(a for a in dp_axes if a in mesh.axis_names)
        self.profile = "fsdp" if "model" in self.dp else "2d"
        self.m = mesh.shape.get("model", 1) if self.profile == "2d" else 1
        self.batch = batch
        axes = _axes(batch_spec((batch,), mesh, self.profile)[0])
        self.batch_axes = tuple(a for a in axes if mesh.shape[a] > 1)
        self.rows = batch // mesh.ways(self.batch_axes)
        self.row0 = mesh.index(self.batch_axes) * self.rows
        self.shapes = _full_shapes(cfg)
        self.gathered: set = set()
        self._specs: Dict[str, tuple] = {}

    # ----------------------------------------------------------- batch
    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch-like tensor."""
        return t if not self.batch_axes else t.narrow(0, self.row0, self.rows)

    def reduce_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch axes (a copy)."""
        t = t.clone()
        return self.mesh.all_reduce(t, self.batch_axes) if self.batch_axes else t

    # ------------------------------------------------------------ specs
    def spec(self, path: str) -> tuple:
        if path not in self._specs:
            self._specs[path] = profile_spec(path.rsplit("/", 1)[-1], self.shapes[path],
                                             self.mesh, self.profile, self.cfg.moe_mode)
        return self._specs[path]

    def _split_over_model(self, path: str, dim: int) -> bool:
        spec = self.spec(path)
        return -len(spec) <= dim < len(spec) and "model" in _axes(spec[dim])

    def weight(self, path: str, local: torch.Tensor, keep_model: bool = False,
               stacked: bool = True) -> torch.Tensor:
        """The tensor a layer computes with from this rank's shard ``local``
        of ``path`` (one repetition's slice where ``stacked``): gathered over
        every axis its spec splits it over, ``model`` kept where
        ``keep_model``."""
        spec = self.spec(path)
        if not spec:
            return local
        if stacked:
            if _axes(spec[0]):
                raise ValueError(f"{path}: the rules split its stacking dim ({spec}); a "
                                 f"repetition's slice would not be whole")
            spec = spec[1:]
        dims = []
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes or self.mesh.ways(axes) == 1 or (keep_model and axes == MODEL):
                continue
            dims.append((d, axes))
        if not dims:
            return local
        self.gathered.add(path)
        return _GatherWeight.apply(local, self, tuple(dims))

    # ------------------------------------------------------------ layout
    def heads(self, path: str, pre: str) -> Optional[Heads]:
        cfg, m = self.cfg, self.m
        h, kv = cfg.n_heads, cfg.n_kv_heads
        if m == 1 or h % m or not self._split_over_model(f"{path}/{pre}wq", -1):
            return None
        h_loc, n_rep = h // m, h // kv
        r = self.mesh.index(MODEL)
        if kv % m == 0 and self._split_over_model(f"{path}/{pre}wk", -1):
            return Heads(h_loc, kv // m, r * (kv // m), True)
        if h_loc % n_rep == 0:
            return Heads(h_loc, h_loc // n_rep, r * h_loc // n_rep, False)
        if n_rep % h_loc == 0:
            return Heads(h_loc, 1, r * h_loc // n_rep, False)
        return None

    def ffn_split(self, path: str, kind: str) -> bool:
        if self.m == 1 or kind == "none":
            return False
        if kind == "dense":
            return self._split_over_model(f"{path}/w_up", -1)
        if self.cfg.moe_mode == "ep":
            return self._split_over_model(f"{path}/moe_gate", 1)
        return self._split_over_model(f"{path}/moe_up", -1)

    def layer(self, lp: Dict, path: str, mixer: str, ffn: str, cross: bool):
        """(the tensors one repetition of a layer computes with, its
        ``Layout``) from its shards ``lp``."""
        layout = Layout(self.heads(path, "") if mixer == "attn" else None,
                        self.heads(path, "x") if cross else None,
                        self.ffn_split(path, ffn))
        keep, shared = set(), set()
        for hl, pre in ((layout.attn, ""), (layout.xattn, "x")):
            if hl is None:
                continue
            keep |= {pre + "wq", pre + "bq", pre + "wo"}
            kvw = {pre + "wk", pre + "wv", pre + "bk", pre + "bv"}
            if hl.kv_split:
                keep |= kvw
            else:
                shared |= kvw
            if not pre:
                shared |= {"qnorm", "knorm"}
        if layout.ffn:
            keep |= {"w_gate", "w_up", "b_up", "w_down", "moe_gate", "moe_up", "moe_down"}
        w = {k: self.weight(f"{path}/{k}", v, keep_model=k in keep) for k, v in lp.items()}
        # Replicated tensors used in a region split over model: each rank's
        # gradient of them is a partial sum. In one order on every rank: the
        # backward reduces them in the order their nodes were made.
        for k in sorted(shared & set(w)):
            w[k] = self.copy_in(w[k])
        return w, layout

    # ------------------------------------------------- model-axis ops
    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.mesh, MODEL)

    def row_sum(self, x: torch.Tensor) -> torch.Tensor:
        return _RowSum.apply(x, self.mesh, MODEL)

    def all_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[B, S, kv/m, hd] blocks of KV heads -> all of them (for a cache)."""
        return _GatherDim.apply(t, self.mesh, MODEL, 2)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return _GatherDim.apply(logits, self.mesh, MODEL, logits.dim() - 1)

    def seq_split(self, s: int) -> bool:
        """Whether the residual stream of length ``s`` is split over model
        between repetitions (``seq_shard``)."""
        return bool(self.cfg.seq_shard) and self.m > 1 and s % self.m == 0

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherDim.apply(x, self.mesh, MODEL, 1)

    def split_seq(self, x: torch.Tensor) -> torch.Tensor:
        return _SplitDim.apply(x, self.mesh, MODEL, 1)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        return _ScatterDim.apply(x, self.mesh, MODEL, 1)

    def residual(self, x, y, split: bool, last: bool, bias=None) -> torch.Tensor:
        """``x + y`` (plus ``bias``, added after the sum over model) where
        ``y`` is a partial sum over model when ``split``; where ``last`` (the
        repetition's last sum under ``seq_shard``) this rank's S block of
        it, the model sum becoming a reduce-scatter."""
        if split and last and bias is None:
            return self.split_seq(x) + self.scatter_seq(y)
        if split:
            y = self.row_sum(y)
        if bias is not None:
            y = y + bias
        x = x + y
        return self.split_seq(x) if last else x

    # ----------------------------------------------------- vocab split
    def vocab_rows(self, path: str) -> Optional[Tuple[int, int]]:
        """(first row, rows) of this rank's vocabulary block of ``embed``
        (dim 0) or ``lm_head`` (dim 1) where it is split over model."""
        dim = 0 if path == "embed" else 1
        if self.m == 1 or not self._split_over_model(path, dim):
            return None
        n = self.shapes[path][dim] // self.m
        return self.mesh.index(MODEL) * n, n

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows of the embedding: a masked lookup in this rank's
        vocabulary block, summed over model, where the vocabulary is split
        (each row has one owner, so the sum is exact)."""
        block = self.vocab_rows("embed")
        w = self.weight("embed", table, keep_model=block is not None, stacked=False)
        if block is None:
            return w[tokens]
        lo, n = block
        t = tokens.long() - lo
        mine = (t >= 0) & (t < n)
        rows = torch.where(mine[..., None], w[t.clamp(0, n - 1)], w.new_zeros(()))
        return self.row_sum(rows)

    def head_weight(self, params) -> Tuple[torch.Tensor, Optional[Tuple[int, int]]]:
        """The [D, V or V/m] output projection this rank computes logits
        with, and its vocabulary block (None when whole)."""
        if self.cfg.tie_embeddings:
            block = self.vocab_rows("embed")
            w = self.weight("embed", params["embed"], keep_model=block is not None,
                            stacked=False)
            return w.T, block
        block = self.vocab_rows("lm_head")
        return self.weight("lm_head", params["lm_head"], keep_model=block is not None,
                           stacked=False), block

    def vocab_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over model of each member's ``x`` (no gradient)."""
        return torch.stack(self.mesh.all_gather(x.detach().contiguous(), MODEL)).amax(0)

    # ---------------------------------------------------------- caches
    def _cache_shape(self, name: str, local: torch.Tensor) -> Tuple[int, ...]:
        """The global [B, ...] shape of one repetition's cache leaf ``name``
        whose ``cache_spec`` shard is ``local``: the config's, and for a KV
        cache the length whose shard has ``local``'s."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        if name in ("xk", "xv"):
            return (self.batch, cfg.encoder_seq, cfg.n_kv_heads, hd)
        if name == "conv":
            return (self.batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
        if name == "ssm":
            return (self.batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        for w in (self.mesh.ways(("data", "model")), self.m, 1):
            shape = (self.batch, local.shape[1] * w, cfg.n_kv_heads, hd)
            if self._cache_local(shape) == tuple(local.shape):
                return shape
        raise ValueError(f"no {name} cache shards to {tuple(local.shape)} on {self.mesh.shape}")

    def _cache_dims(self, shape) -> list:
        """[(dim, axes)] of a repetition's cache leaf of global ``shape``
        that ``cache_spec`` splits, the batch dim apart."""
        spec = cache_spec((1,) + tuple(shape), self.mesh)[2:]
        return [(d + 1, _axes(e)) for d, e in enumerate(spec)
                if _axes(e) and self.mesh.ways(_axes(e)) > 1]

    def _cache_local(self, shape) -> Tuple[int, ...]:
        out = [self.rows] + list(shape[1:])
        for d, axes in self._cache_dims(shape):
            out[d] //= self.mesh.ways(axes)
        return tuple(out)

    def cache_in(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """One repetition's cache leaf whole (but for the batch rows) from
        its ``cache_spec`` shard (``2d``; under ``fsdp`` a cache is the
        rank's rows, whole)."""
        if self.profile == "fsdp":
            return local
        dims = self._cache_dims(self._cache_shape(name, local))
        return _assemble(self.mesh, local, tuple(dims)) if dims else local

    def cache_out(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's ``cache_spec`` shard of a cache leaf computed whole
        (but for the batch rows)."""
        if self.profile == "fsdp":
            return full
        out = full
        for d, axes in self._cache_dims((self.batch,) + tuple(full.shape[1:])):
            n = full.shape[d] // self.mesh.ways(axes)
            out = out.narrow(d, self.mesh.index(axes) * n, n)
        return out if out is full else out.contiguous()
