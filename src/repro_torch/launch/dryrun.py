"""Dry run: one rank's step of every (architecture × shape × mesh) cell of
the LM zoo, and of the paper's own training step at ogbl-wikikg2 scale, on
the meta device under a virtual production mesh: no buffer is allocated and
no card is needed. The JAX package lowers and compiles each cell on 512
emulated XLA devices (``src/repro/launch/dryrun.py``); the port has no
compiler to ask, so it runs the rank's program itself and counts:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the matrix products),
  plus the hand-written kernels' reckoned FLOPs (``kernels/reckon.py``);
* bytes accessed: the input and output bytes of every aten op (views move
  nothing), plus the kernels' reckoned bytes. This is eager traffic, an
  upper bound on what a fused program moves;
* memory: the live bytes of the storages the step makes (a view does not
  count twice), beside its arguments (the rank's shards and batch rows):
  ``argument_bytes``, ``output_bytes``, ``temp_bytes``, ``alias_bytes``
  (parameters and moments updated in place) and ``peak_bytes``, with the
  reference's identity peak = argument + temp + output − alias;
* collectives: the ``VirtualMesh``'s log, priced by
  ``launch.roofline.collective_stats``.

The roofline terms use an H100 SXM's published peaks at 700 W
(``launch/roofline.py``): every time in a record is reckoned from them, not
measured. Eager execution sees every repetition, so ``cost_exact`` is the
count of the whole program; under ``analyze`` the reference's k = 2 / k = 3
extrapolation (``_exact_cost``) runs beside it as a cross-check
(``cost_extrapolated``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out results/
  python -m repro_torch.launch.dryrun --ngdb [--sparse]   # the paper's own model
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed.context import ExecutionContext
from repro_torch.distributed.sharding import dp_axes
from repro_torch.kernels import reckon
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import collective_stats, model_flops, roofline_terms
from repro_torch.lm.config import LMConfig
from repro_torch.lm.model import abstract_params, block_pattern
from repro_torch.lm.parallel import MeshPlan
from repro_torch.lm.shapes import SHAPES, ShapeCell, cell_supported, input_specs
from repro_torch.lm.steps import (lm_adam_init, make_decode_step, make_prefill_step,
                                  make_train_step)

_FACTORIES = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
              torch.ops.aten.new_empty_strided.default}


@functools.lru_cache(maxsize=None)
def _moves_bytes(func) -> bool:
    """False for a factory of uninitialised memory and a view (its result
    aliases an input without writing it)."""
    return func not in _FACTORIES and not any(
        r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_tensors(values):
    """The tensors among an op's arguments or results (lists one deep)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Bytes every aten op reads and writes, and the live bytes (with their
    peak) of the storages made under the mode; ``known`` storages (the
    step's arguments) are not counted."""

    def __init__(self, known):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet(known)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        if _moves_bytes(func):
            ins = _op_tensors(tuple(args) + tuple(kwargs.values()))
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


def measure(fn, args, argument_bytes: int, mesh) -> Dict:
    """Run ``fn(*args)`` (meta tensors) under the counters; the record's
    cost, memory and collective parts. ``argument_bytes``: the rank's share
    of the arguments (a global batch counts its rows only)."""
    known = {t.untyped_storage() for t in _tensors(args)}
    kernels = collections.defaultdict(lambda: [0, 0.0, 0.0])

    def hook(name, flops, nbytes):
        k = kernels[name]
        k[0] += 1
        k[1] += flops
        k[2] += nbytes

    saved, reckon.HOOK = reckon.HOOK, hook
    n_log = len(mesh.log)
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as fc, _Traffic(known) as tr:
            out = fn(*args)
        trace_s = time.perf_counter() - t0
        flops = fc.get_total_flops() + sum(k[1] for k in kernels.values())
        nbytes = tr.bytes + sum(k[2] for k in kernels.values())
        outs = {t.untyped_storage() for t in _tensors(out)}
        output = sum(st.nbytes() for st in outs)
        alias = sum(st.nbytes() for st in outs if st in known)
        peak = argument_bytes + tr.peak
    finally:
        reckon.HOOK = saved
    coll = collective_stats(mesh.log[n_log:], mesh.size)
    return {
        "trace_s": round(trace_s, 3),
        "flops": float(flops), "bytes_accessed": float(nbytes),
        "memory": {"argument_bytes": int(argument_bytes), "output_bytes": int(output),
                   "temp_bytes": int(peak - argument_bytes - output + alias),
                   "alias_bytes": int(alias), "peak_bytes": int(peak)},
        "collectives": coll,
        "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]} for k, v in kernels.items()},
    }


# ------------------------------------------------------------- LM cells
def _cache_shards(plan: MeshPlan, tree):
    """Each stacked global cache leaf's shard on this rank: its batch rows,
    each repetition cut as ``MeshPlan.cache_out`` cuts a decode's."""
    def shard(t):
        rows = t.narrow(1, plan.row0, plan.rows)
        return torch.stack([plan.cache_out(rows[r]) for r in range(t.shape[0])])

    return {k: _cache_shards(plan, v) if isinstance(v, dict) else shard(v)
            for k, v in tree.items()}


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _trace(cfg: LMConfig, shape, mesh, profile: str = "2d") -> Dict:
    """One rank's step of the cell (a name or a ``ShapeCell``) on meta
    tensors, measured."""
    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    dp = dp_axes(mesh, profile)
    ctx = ExecutionContext.from_mesh(mesh, profile=profile, moe_mode=cfg.moe_mode)
    params = ctx.shard_tree(abstract_params(cfg))
    specs = input_specs(cfg, shape)
    plan = MeshPlan(cfg, mesh, dp, cell.global_batch)
    share = plan.rows / cell.global_batch
    if cell.kind == "decode":
        caches = _cache_shards(plan, specs["caches"])
        fn = make_decode_step(cfg, mesh, dp)
        args = (params, caches, specs["tokens"], specs["cache_len"])
        arg_bytes = _tree_bytes((params, caches)) + share * _nbytes(specs["tokens"])
    else:
        batch = specs["batch"]
        arg_bytes = _tree_bytes(params) + share * _tree_bytes(batch)
        if cell.kind == "train":
            opt = lm_adam_init(params)
            fn = make_train_step(cfg, mesh, dp)
            args = (params, opt, batch)
            arg_bytes += _tree_bytes(opt)
        else:
            fn = make_prefill_step(cfg, mesh, dp)
            args = (params, batch)
    return measure(fn, args, int(arg_bytes), mesh)


def _exact_cost(cfg: LMConfig, shape: str, multi_pod: bool, profile: str = "2d") -> Dict:
    """The reference's extrapolation (``src/repro/launch/dryrun.py``
    ``_exact_cost``): the cell's count at k and k+1 repetitions of the block
    pattern (k = 2, or 1 for SSM/hybrid blocks of 8 or more layers),
    extended linearly over the n_rep identical blocks. ``exact_cost_mode``
    is left as the cell has it: it unrolls the reference's scans, and the
    port's k programs are the whole program's at k repetitions."""
    pat = len(block_pattern(cfg))
    n_rep = cfg.n_layers // pat
    ks = (1, 2) if (cfg.ssm_state > 0 and pat >= 8) else (2, 3)
    samples = []
    for k in ks:
        over = {"n_layers": pat * k}
        if cfg.encoder_layers:
            over["encoder_layers"] = k
        mesh = make_production_mesh(multi_pod=multi_pod)
        r = _trace(dataclasses.replace(cfg, **over), shape, mesh, profile)
        c = r["collectives"]
        samples.append((r["flops"], r["bytes_accessed"], c.wire_bytes, c.by_type, c.counts,
                        c.by_tier))
    (f1, b1, w1, t1, c1, r1), (f2, b2, w2, t2, c2, r2) = samples

    def ext(a, b):
        return a + (n_rep - ks[0]) * max(b - a, 0.0)

    return {
        "flops": ext(f1, f2),
        "bytes_accessed": ext(b1, b2),
        "wire_bytes": ext(w1, w2),
        "collective_by_type": {k: ext(t1.get(k, 0.0), t2.get(k, 0.0)) for k in set(t1) | set(t2)},
        "collective_counts": {k: int(ext(c1.get(k, 0), c2.get(k, 0))) for k in set(c1) | set(c2)},
        "collective_by_tier": {k: ext(r1.get(k, 0.0), r2.get(k, 0.0)) for k in set(r1) | set(r2)},
        "blocks_extrapolated": n_rep,
    }


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16(pod,data,model)" if multi_pod else "16x16(data,model)"


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             cfg: Optional[LMConfig] = None, override=None,
             analyze: bool = True, profile: str = "2d", mesh=None) -> Dict:
    """Run one cell; returns its record (the reference's keys; ``trace_s``
    in place of ``lower_s``/``compile_s``). ``shape`` is a cell's name or a
    ``ShapeCell``; ``mesh`` replaces the production mesh (a ``VirtualMesh``
    of any shape, e.g. 1×1)."""
    cfg = cfg or get_arch(arch)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    rec: Dict = {"arch": arch, "shape": cell.name, "mesh": _mesh_name(multi_pod),
                 "kind": cell.kind}
    skip = cell_supported(cfg, cell.name)
    if skip:
        rec["skipped"] = skip
        return rec
    rec["profile"] = profile
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        rec["mesh"] = "x".join(str(v) for v in mesh.shape.values()) + \
            "(" + ",".join(mesh.axis_names) + ")"
    n_dev = mesh.size
    r = _trace(cfg, shape, mesh, profile)
    coll = r["collectives"]
    rec["trace_s"] = r["trace_s"]
    rec["memory"] = r["memory"]
    rec["cost_raw"] = {"flops": r["flops"], "bytes accessed": r["bytes_accessed"]}
    rec["collectives_raw"] = coll.as_dict()
    rec["cost_exact"] = {
        "flops": r["flops"], "bytes_accessed": r["bytes_accessed"],
        "wire_bytes": coll.wire_bytes, "collective_by_type": coll.by_type,
        "collective_counts": coll.counts, "collective_by_tier": coll.by_tier,
        "blocks_extrapolated": 0,
    }
    if analyze:
        try:
            rec["cost_extrapolated"] = _exact_cost(cfg, shape, multi_pod, profile) \
                if mesh.size in (256, 512) else None
        except Exception:
            rec["cost_extrapolated"] = {"error": traceback.format_exc(limit=10)}
    rec["roofline"] = roofline_terms(r["flops"], r["bytes_accessed"], coll.by_tier)
    mf = model_flops(cfg, cell, cell.kind)
    rec["model_flops_global"] = mf
    rec["model_flops_per_device"] = mf / n_dev
    if r["flops"]:
        rec["useful_flops_ratio"] = (mf / n_dev) / r["flops"]
    return rec


# ---------------------------------------------------------------- NGDB cell
def _fetch_rows(ctx, local: torch.Tensor, axes, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a table split by rows over ``axes``: each rank
    contributes the rows it holds (zeros elsewhere) to one all-gather, and a
    row is its owner's (the sum of one owner's row and zeros)."""
    if not axes:
        return local[ids]
    n = local.shape[0]
    me = ctx.mesh.index(axes)
    mine = (ids // n) == me
    rows = torch.where(mine[:, None], local[(ids - me * n).clamp(0, n - 1)],
                       local.new_zeros(()))
    return torch.stack(ctx.mesh.all_gather(rows, axes)).sum(0)


def run_ngdb_cell(multi_pod: bool = False, dataset: str = "ogbl-wikikg2",
                  model_name: str = "betae", batch: int = 512,
                  n_neg: int = 64, dim: int = 400,
                  entity_pad: int = 4096, sparse_updates: bool = False) -> Dict:
    """The paper's own training step at production scale, as the reference's
    dry run has it: entity and semantic tables sharded over the mesh (2d
    rules), one operator-level batch of mixed patterns (uniform over the 14),
    the vectorized loss, Adam. Dense, it is the port's own distributed step
    (``NGDBTrainer.prepared_step``: every parameter gathered, the local loss, the
    gradients reduced over the batch axes and cut to the shards, Adam on
    the shards); with ``sparse_updates`` the reference's row-local step: the
    batch's touched entity rows fetched from their owners, the loss
    differentiated by those rows alone, row-local Adam, the rows written
    back to the shard (on meta every fetched row is written: on data a rank
    writes the rows it owns)."""
    from repro_torch.core.patterns import TEMPLATES, QueryInstance
    from repro_torch.data.kg import TABLE4, KnowledgeGraph
    from repro_torch.data.pipeline import rank_slice
    from repro_torch.models.base import ModelConfig, make_model
    from repro_torch.training.loop import NGDBTrainer, TrainConfig
    from repro_torch.training.loss import negative_sampling_loss
    from repro_torch.training.optim import AdamConfig

    stats = TABLE4[dataset]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    rec = {"arch": f"ngdb-{model_name}-{dataset}", "shape": f"train_b{batch}",
           "mesh": "2x16x16" if multi_pod else "16x16", "kind": "train",
           "entity_pad": entity_pad, "sparse_updates": sparse_updates}
    ctx = ExecutionContext.from_mesh(mesh)
    model = make_model(model_name, ModelConfig(dim=dim, semantic_dim=1024,
                                               entity_pad=entity_pad), device="meta")
    rows = model.padded_entities(stats.n_entities)
    # The trainer as a user builds it, on meta: its parameters and moments
    # are the rank's shards. The step reads no triple of the graph, so one
    # stands in for the dataset's.
    kg = KnowledgeGraph(stats.n_entities, stats.n_relations, np.array([[0, 0, 1]]))
    adam = AdamConfig(lr=1e-4)
    tr = NGDBTrainer(model, kg, TrainConfig(batch_size=batch, n_negatives=n_neg, b_max=512,
                                            adam=adam),
                     semantic_table=torch.empty((rows, 1024), device="meta"), ctx=ctx)
    params, opt, ex = tr.params, tr.opt_state, tr.executor
    # One representative mixed batch (uniform over the 14 patterns).
    rng = np.random.default_rng(0)
    pats = list(TEMPLATES)
    queries = []
    for i in range(batch):
        t = TEMPLATES[pats[i % len(pats)]]
        queries.append(QueryInstance(pats[i % len(pats)],
                                     rng.integers(0, stats.n_entities, t.n_anchors),
                                     rng.integers(0, stats.n_relations, t.n_relations)))
    pos = rng.integers(0, stats.n_entities, batch)
    neg = rng.integers(0, stats.n_entities, (batch, n_neg))
    _, lq, lpos, lneg, global_order = rank_slice(ctx, queries, pos, neg)
    t0 = time.perf_counter()
    prepared = ex.prepare(lq)
    rec["plan_s"] = round(time.perf_counter() - t0, 3)
    steps, ans = prepared.device_args("meta")
    pos_t = torch.from_numpy(lpos[prepared.order]).to("meta")
    neg_t = torch.from_numpy(lneg[prepared.order]).to("meta")

    if not sparse_updates:
        def step(params, opt_state):  # the trainer's own, on its params and moments
            return (params, opt_state) + tr.prepared_step(prepared, steps, ans, pos_t, neg_t,
                                                          batch, global_order)

        args = (params, opt)
    else:
        shapes = model.full_shapes
        u_rows = batch * 3 + batch * (1 + n_neg)  # anchors + pos + negs (padded)
        ids = torch.empty((u_rows,), dtype=torch.long, device="meta")
        pos_l = torch.empty_like(pos_t)
        neg_l = torch.empty_like(neg_t)
        ent_axes = ctx.row_axes("entity", shapes["entity"])
        sem_axes = ctx.row_axes("sem_table", shapes["sem_table"])
        n_local = len(prepared.order)

        def step(params, opt_state):
            others = {k: ctx.gather(k, v, shapes[k]) for k, v in params.items()
                      if k not in ("entity", "sem_table")}
            ent_rows = _fetch_rows(ctx, params["entity"], ent_axes, ids)
            sem_rows = _fetch_rows(ctx, params["sem_table"], sem_axes, ids)
            m_rows = _fetch_rows(ctx, opt_state["m"]["entity"], ent_axes, ids)
            v_rows = _fetch_rows(ctx, opt_state["v"]["entity"], ent_axes, ids)
            leaf = ent_rows.detach().requires_grad_(True)
            with torch.enable_grad():
                p_local = {**others, "entity": leaf, "sem_table": sem_rows}
                q = ex.encode_fn(prepared)(p_local, steps, ans)
                loss, _ = negative_sampling_loss(model, p_local, q, pos_l, neg_l)
                loss = loss * (n_local / batch)
                (g_rows,) = torch.autograd.grad(loss, [leaf])
            g_rows = ctx.reduce_batch(g_rows, batch)
            # row-local Adam (global bias correction; standard for sparse KGE)
            with torch.no_grad():
                st = opt_state["step"] + 1
                b1t = 1.0 - adam.b1 ** st.float()
                b2t = 1.0 - adam.b2 ** st.float()
                m_rows = adam.b1 * m_rows + (1 - adam.b1) * g_rows
                v_rows = adam.b2 * v_rows + (1 - adam.b2) * torch.square(g_rows)
                new_rows = ent_rows - adam.lr * (m_rows / b1t) / (torch.sqrt(v_rows / b2t)
                                                                  + adam.eps)
                n = params["entity"].shape[0]
                local_ids = (ids - ctx.mesh.index(ent_axes) * n).clamp(0, n - 1)
                for t, r in ((params["entity"], new_rows), (opt_state["m"]["entity"], m_rows),
                             (opt_state["v"]["entity"], v_rows)):
                    t.index_copy_(0, local_ids, r)
                opt_state["step"] = st
            return params, opt_state, ctx.reduce_batch(loss.detach(), batch)

        args = (params, opt)
    r = measure(step, args, _tree_bytes(args), mesh)
    rec["trace_s"] = r["trace_s"]
    rec["memory"] = r["memory"]
    rec["cost"] = {"flops": r["flops"], "bytes accessed": r["bytes_accessed"]}
    rec["collectives"] = r["collectives"].as_dict()
    rec["kernels"] = r["kernels"]
    rec["roofline"] = roofline_terms(r["flops"], r["bytes_accessed"], r["collectives"].by_tier)
    rec["schedule_stats"] = prepared.sched.stats
    rec["n_devices"] = n_dev
    return rec


def _run(arch: str, shape: Optional[str], multi_pod: bool, analyze: bool,
         sparse: bool) -> Dict:
    """One cell's record (an ``error`` record where it raised)."""
    try:
        if arch == "ngdb":
            return run_ngdb_cell(multi_pod=multi_pod, sparse_updates=sparse)
        return run_cell(arch, shape, multi_pod=multi_pod, analyze=analyze)
    except Exception:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "error": traceback.format_exc(limit=20)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ngdb", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="--ngdb with row-sparse entity updates")
    ap.add_argument("--no-analyze", action="store_true",
                    help="skip the k=2/k=3 extrapolation (the whole program only)")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)

    if args.ngdb:
        cells = [("ngdb", None)]
    elif args.all:
        cells = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all, or --ngdb")
        cells = [(args.arch, args.shape)]
    run_args = [(a, s, args.multi_pod, not args.no_analyze, args.sparse) for a, s in cells]
    if args.jobs > 1 and len(cells) > 1:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"), max_tasks_per_child=1)
        with pool:
            records = pool.map(_run, *zip(*run_args))
            for rec in records:
                _emit(rec, args)
    else:
        for a in run_args:
            _emit(_run(*a), args)


def _emit(rec: Dict, args) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"{rec['arch']}_{rec.get('shape')}_{'mp' if args.multi_pod else 'sp'}"
        if rec.get("sparse_updates"):
            tag += "_sparse"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            f.write(line)


if __name__ == "__main__":
    main()
