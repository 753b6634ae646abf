"""End-to-end NGDB training loop: online sampling → operator-level scheduling
→ pooled execution under autograd → vectorized loss → Adam, with adaptive
sampling, prefetch pipelining and fault-tolerant checkpointing.

Two execution modes, as in the JAX package's trainer:

* **sync** (``pipeline=False``, the ablation baseline): each step runs
  sampling → Algorithm-1 scheduling → the device step → the loss readback in
  sequence, so the host idles while the card runs and the card idles while
  the host schedules. With ``prefetch > 0`` and neither ``batches`` nor
  adaptive sampling, raw batches come from a ``BatchPrefetcher``'s sampling
  threads; otherwise they are sampled inline.
* **pipelined** (``pipeline=True``, pooled executor only; ``query_level``
  falls back to sync, as the reference does): a background scheduler thread
  (``data/pipeline.py::PreparedBatchPrefetcher``) draws the negatives,
  stages the hot set, compiles the plan and copies step *k+1*'s inputs to the
  card on its own side stream while the main thread launches step *k*'s
  kernels. The main thread takes no host sync from taking an item to the end
  of Adam: a step's loss is read back only when the step leaves a window of
  ``max_inflight`` dispatched steps (``_retire``), and adaptive sampling
  (run in the scheduler thread) sees a π at most that many steps stale. Every
  loss and parameter is bitwise the sync mode's on the same batches: the
  scheduler thread draws the negatives in batch order from the trainer's
  sampler, and every kernel runs on the main thread's stream in the same
  order. Parameters are updated in place, so a checkpoint boundary inside
  the window is snapshot by ``clone()`` right after that step's Adam.

Two executors:

* ``pooled`` — the paper's operator-level batching: one pooled encode of the
  whole batch (CSE-shared rows included), one loss, one Adam step;
* ``query_level`` — the baseline: one encode, loss and gradient per pattern
  group, the gradients weighted by group size and divided by B before one
  Adam step.

PyTorch runs eagerly, so there is no step program to compile or cache; the
executor keeps its signature-keyed encode closures, and a cold signature's
first dispatch is counted under ``dispatch``. On CUDA, BetaE's intersection
and union go through the ``intersect`` kernel and its hand-written backward
(``kernels/intersect.py``).

Semantic augmentation (§4.4, Eq. 11+12): with ``semantic_table=`` (H_sem
resident on the device) or ``semantic_cache=`` (a bounded hot set of a
``SemanticStore``), a model with ``semantic_dim > 0`` fuses every entity it
gathers through ``gather_fuse`` — on CUDA the kernel, and its hand-written
backward (``kernels/gather_fuse.py``). H_sem is frozen. Under a cache, each
step first stages the rows it gathers (``cache.plan`` of
``batch_entity_ids``, then ``apply_to``): sync mode outside the step's
timing window, pipelined mode planned on the scheduler thread and applied on
the main stream right before the step's dispatch.

Telemetry: the registry group ``trainer`` holds ``steps``, ``inflight`` and
``phase_seconds{phase=pipeline_wait|sem_apply|dispatch|retire}``;
``step_phases`` keeps each retired step's phases, the scheduler thread's and
the main thread's, in seconds, with each thread's CPU time for the step
(``scheduler_cpu_s``, ``dispatch_cpu_s``): both threads share one GIL. The
main thread's trace lane is "main dispatch", with the spans ``sample``,
``sem_prefetch``, ``schedule``, ``dispatch`` and ``retire`` (sync) or
``pipeline_wait``, ``sem_apply``, ``dispatch`` and ``retire`` (pipelined).
With ``metrics_path`` every retired step also writes one JSONL record
(``kind: "step"``) with the JAX package's keys: the step, its loss and
queries/s, the phases in seconds and, pipelined, ``wait_s`` (the bubble,
``pipeline_wait_s`` in ``step_phases``), ``bubble_frac`` and ``wall_s``. A
cold signature is counted under ``dispatch``, so no ``compile`` span or
``compile_s`` key appears. ``history`` keeps its shape.

``materialized_rows > 0`` attaches a ``MaterializedSubqueryCache`` of that
many rows to the pooled executor's encode path (``evaluate`` and any other
``executor.encode`` caller); training steps never read it, and its version
bumps after every Adam step, sync or pipelined, and on every write to the
graph. The pipelined scheduler thread probes it (``PreparedWorkItem.
mat_hits``).

``incremental_finetune`` is the live graph's embedding maintenance: a few
Adam steps of 1p loss on the written triples, on a copy of the params; under
a mesh sharded as a training step is, through the same helpers
(``gather_params``, ``loss_and_grads``, ``sharded_update``).

Under a mesh ``ctx`` (``distributed/context.py``) the trainer is ZeRO-3 by
hand: each rank keeps only its shard of each parameter and of both Adam
moments; a step gathers the sharded parameters into full tensors, runs the
encode and the loss on this rank's rows of the global batch (its own plan),
sums the gradients over the batch axes, keeps its shard of each and runs
Adam on the shards. Every rank samples the same global batch and draws the
same negatives from the same seed; the local loss is the local mean times
local/global rows (exactly 1.0 at one rank), the logged loss the sum over
the batch axes, and the per-query losses are gathered into the global
batch's canonical order on every rank, for adaptive sampling, whose π must
not diverge between ranks. Every collective runs on the main thread, in one
order on every rank (the pipelined scheduler thread issues none).
Single-device runs the same step: the context's gather, shard and batch
reduction are identities there and local/global is exactly 1.0.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import PooledExecutor, QueryLevelExecutor
from repro_torch.core.matcache import MaterializedSubqueryCache
from repro_torch.core.patterns import TEMPLATES, QueryInstance
from repro_torch.data.pipeline import (BatchPrefetcher, PreparedBatchPrefetcher,
                                       batch_entity_ids, rank_slice)
from repro_torch.distributed.context import ExecutionContext
from repro_torch.obs.registry import get_registry
from repro_torch.obs.sink import MetricsSink
from repro_torch.obs.trace import TRACER
from repro_torch.sampling.adaptive import AdaptiveDistribution, pattern_losses_from_batch
from repro_torch.sampling.online import OnlineSampler, SampledQuery
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.loss import negative_sampling_loss
from repro_torch.training.optim import AdamConfig, adam_init, adam_update, global_norm


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 512           # queries (Table 5)
    n_negatives: int = 64
    b_max: int = 512
    adam: AdamConfig = dataclasses.field(default_factory=AdamConfig)
    patterns: Tuple[str, ...] = tuple(TEMPLATES)
    adaptive: bool = False
    executor: str = "pooled"        # pooled | query_level
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 200
    seed: int = 0
    prefetch: int = 2               # producer/consumer queue depth (0 = sync
    #                                 sampling inline)
    pipeline: bool = False          # overlap host scheduling w/ device steps
    max_inflight: int = 2           # pipelined: bounded dispatch window
    compile_cache_size: int = 128   # LRU capacity of the encode closures
    gil_switch_interval: float = 2e-3  # pipelined: bound GIL handoff latency
    cse: bool = True                # cross-query subexpression sharing
    #                                 (False = --no-cse ablation baseline)
    materialized_rows: int = 0      # >0: attach a MaterializedSubqueryCache
    #                                 of that many rows to the pooled
    #                                 executor's eval/encode path (training
    #                                 steps never consume cached rows)
    metrics_path: Optional[str] = None  # JSONL step records (None = off)


# step_phases keys that the JSONL step record leaves out.
_PORT_ONLY_PHASES = ("scheduler_cpu_s", "dispatch_cpu_s", "t_retired")


def gather_params(ctx, model, params) -> Dict[str, torch.Tensor]:
    """Every parameter whole, by sorted name: under a mesh gathered from this
    rank's shards at ``model.full_shapes`` (collective); single-device the
    tensors themselves."""
    shapes = model.full_shapes
    return {k: ctx.gather(k, params[k], shapes[k]) for k in sorted(params)}


def loss_and_grads(model, encode, params, steps, ans, pos: torch.Tensor,
                   neg: torch.Tensor, scale: float = 1.0):
    """(loss, per-query loss, {name: gradient}) of one prepared batch
    (``encode`` its closure, ``pos``/``neg`` in its plan's order on the
    device) at ``params``, the loss (and so every gradient) times ``scale``
    where it is not 1. Frozen names get (1,) zero tokens, and a parameter
    the batch does not reach a zero gradient, as the reference's
    ``value_and_grad`` gives."""
    frozen_names = set(model.frozen_param_names())
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if k not in frozen_names}
    p = {**leaves, **{k: v for k, v in params.items() if k in frozen_names}}
    with torch.enable_grad():
        q = encode(p, steps, ans)
        loss, per_q = negative_sampling_loss(model, p, q, pos, neg)
        if scale != 1.0:
            loss = loss * scale
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {k: torch.zeros_like(v) if g is None else g
           for (k, v), g in zip(leaves.items(), grads)}
    dev = next(iter(params.values())).device
    out.update({k: torch.zeros((1,), dtype=torch.float32, device=dev)
                for k in params if k in frozen_names})
    return loss.detach(), per_q.detach(), out


def sharded_update(ctx, grads: Dict[str, torch.Tensor], n: int, opt_state, params,
                   cfg: AdamConfig) -> None:
    """Adam, in place, on one step's whole gradients: summed over the axes a
    batch of ``n`` is split over (one flat all-reduce of the trainable
    names; none single-device), clipped by their global norm, and cut to
    this rank's shards (the whole tensors single-device) of ``params`` and
    ``opt_state``."""
    if ctx.batch_axes(n):
        names = [k for k in sorted(grads) if k not in cfg.frozen]
        flat = ctx.reduce_batch(torch.cat([grads[k].reshape(-1) for k in names]), n)
        sizes = [grads[k].numel() for k in names]
        grads = {**grads, **{k: g.view(grads[k].shape) for k, g in
                             zip(names, torch.split(flat, sizes))}}
    if cfg.clip_norm > 0:
        # adam_update's own clip, on the whole gradients rather than the
        # shards.
        g_norm = global_norm(grads)
        clip = torch.clamp(cfg.clip_norm / (g_norm + 1e-9), max=1.0)
        grads = {k: g * clip for k, g in grads.items()}
        cfg = dataclasses.replace(cfg, clip_norm=0.0)
    adam_update({k: ctx.shard(k, g) for k, g in grads.items()}, opt_state, params, cfg)


def incremental_finetune(model, params, triples, *, steps: int = 4,
                         lr: float = 1e-3, n_negatives: int = 8,
                         seed: int = 0, b_max: int = 64, executor=None, ctx=None):
    """Incremental embedding maintenance for a live KG write: a few Adam
    steps of 1p link-prediction loss on exactly the written triples.
    Returns ``(new_params, losses)``.

    A pure function of (params, triples, hyperparameters, seed): the
    negatives come from ``np.random.default_rng(seed)`` exactly as the JAX
    package draws them, and the batch is canonicalized by the same plan
    compiler as training. The caller's tensors are left bitwise unchanged —
    they are typically the serving engine's LIVE weights, read concurrently
    by the batcher thread — because the in-place Adam runs on clones: the
    returned dict holds new tensors for every trainable name and shares the
    frozen ones. Launches go on the calling thread's current stream.

    Under a mesh ``ctx`` ``params`` are this rank's shards and the call is
    collective, a step sharded as ``NGDBTrainer(ctx=)`` shards one: every
    rank draws the same negatives, gathers the parameters, takes the loss on
    its rows of the burst (``rank_slice``) times local/global rows, and runs
    ``sharded_update`` on its shards of fresh moments; the losses returned
    are summed over the batch axes. At one rank it is bitwise the
    single-device fine-tune."""
    ctx = ctx or ExecutionContext.single_device()
    triples = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
    if len(triples) == 0:
        return params, []
    dev = params["entity"].device
    executor = executor or PooledExecutor(model, b_max=b_max, device=dev)
    queries = [QueryInstance("1p", np.array([h]), np.array([r]))
               for h, r, _ in triples]
    pos = np.ascontiguousarray(triples[:, 2])
    rng = np.random.default_rng(seed)
    n_ent = model.n_entities
    neg = rng.integers(0, n_ent, size=(len(pos), n_negatives))
    clash = neg == pos[:, None]
    while clash.any():
        neg[clash] = rng.integers(0, n_ent, size=int(clash.sum()))
        clash = neg == pos[:, None]
    n = len(queries)
    _, lq, lpos, lneg, _ = rank_slice(ctx, queries, pos, neg)
    prepared = executor.prepare(lq)
    steps_in, ans = prepared.device_args(dev)
    encode = executor.encode_fn(prepared)
    pos_t = torch.from_numpy(lpos[prepared.order]).to(dev)
    neg_t = torch.from_numpy(lneg[prepared.order]).to(dev)
    adam_cfg = AdamConfig(lr=lr)
    frozen_names = set(model.frozen_param_names())
    new = {k: (v if k in frozen_names else v.detach().clone())
           for k, v in params.items()}
    opt_state = adam_init(new, adam_cfg, ctx=ctx)
    losses: List[float] = []
    for _ in range(steps):
        full = gather_params(ctx, model, new)
        loss, _, grads = loss_and_grads(model, encode, full, steps_in, ans, pos_t, neg_t,
                                        len(prepared.order) / n)
        del full
        sharded_update(ctx, grads, n, opt_state, new, adam_cfg)
        if ctx.is_sharded:
            loss = ctx.reduce_batch(loss.clone(), n)
        losses.append(float(loss))
    return new, losses


class NGDBTrainer:
    """Trainer on the model's device (module docstring: sync and pipelined
    modes). Parameters are drawn from a
    ``torch.Generator`` seeded with ``cfg.seed``; ``params`` and
    ``opt_state`` are updated in place each step. ``semantic_table`` or
    ``semantic_cache`` carry H_sem for a model with ``semantic_dim > 0``
    (``QueryEncoder.init_params``). Under a mesh ``ctx`` (module docstring)
    ``params`` and ``opt_state`` hold this rank's shards, the model must sit
    on ``ctx.device``, and ``full_params()`` gathers the whole set. The
    updates are in place: a ``ctx`` with ``donate_params=False`` is
    refused."""

    def __init__(self, model, kg, cfg: TrainConfig, semantic_table=None,
                 semantic_cache=None, ctx=None):
        self.ctx = ctx or ExecutionContext.single_device()
        if not self.ctx.donate_params:
            raise ValueError("NGDBTrainer updates parameters and moments in place; "
                             "donate_params=False is not supported")
        if self.ctx.is_sharded and model.device != self.ctx.device:
            raise ValueError(f"the model is on {model.device}, the mesh rank's device "
                             f"is {self.ctx.device}")
        if cfg.executor not in ("pooled", "query_level"):
            raise ValueError(f"executor must be 'pooled' or 'query_level', "
                             f"got {cfg.executor!r}")
        self.model = model
        self.kg = kg
        self.cfg = cfg
        self.device = model.device
        # Materialized rows are an inference-side cache: training steps never
        # read them, but executor.encode() on the eval path does, and they
        # are invalidated on every param update and graph write.
        self.mat_cache = None
        if cfg.materialized_rows > 0 and cfg.executor == "pooled":
            self.mat_cache = MaterializedSubqueryCache(cfg.materialized_rows)
            self.mat_cache.watch_kg(kg)
        if cfg.executor == "pooled":
            self.executor = PooledExecutor(model, b_max=cfg.b_max, cse=cfg.cse,
                                           cache_size=cfg.compile_cache_size,
                                           device=self.device,
                                           mat_cache=self.mat_cache, ctx=self.ctx)
        else:
            self.executor = QueryLevelExecutor(model, b_max=cfg.b_max, device=self.device,
                                               ctx=self.ctx)
        # Out of core, the params carry the cache's bounded hot set and its
        # id -> slot map instead of H_sem; every step stages its rows first.
        self.sem_cache = semantic_cache
        # Meta tensors (the dry run) draw nothing: no generator lives there.
        gen = (None if self.device.type == "meta"
               else torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.params = model.init_params(gen, kg.n_entities, kg.n_relations,
                                        semantic_table=semantic_table,
                                        semantic_cache=semantic_cache, ctx=self.ctx)
        self.opt_state = adam_init(self.params, cfg.adam, ctx=self.ctx)
        self.sampler = OnlineSampler(kg, patterns=cfg.patterns, seed=cfg.seed)
        self.adaptive = AdaptiveDistribution(cfg.patterns) if cfg.adaptive else None
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, every=cfg.checkpoint_every)
                     if cfg.checkpoint_dir else None)
        self.step = 0
        self.last_per_q: Optional[np.ndarray] = None  # the last retired step's
        #                                 per-query losses (under a mesh in the
        #                                 global batch's canonical order)
        self.history: List[Dict] = []
        self.step_phases: List[Dict[str, float]] = []
        self._obs = get_registry().group("trainer")
        self._steps_done = self._obs.counter("steps")
        self._phase_s = {
            name: self._obs.counter("phase_seconds", phase=name)
            for name in ("pipeline_wait", "sem_apply", "dispatch", "retire")}
        self._inflight_gauge = self._obs.gauge("inflight")
        self.metrics_sink = MetricsSink(cfg.metrics_path)

    def load_params(self, arrays) -> None:
        """Replace the parameters with ``arrays`` ({name: numpy array}, e.g.
        another trainer's) and start the optimizer afresh. Under a semantic
        cache, the hot set and slot map are copied into the cache's own
        tensors (the ones staging writes), and its residency is reset, so
        the next step restages its rows from the store."""
        from repro_torch.models.base import params_from_numpy

        n = self.kg.n_entities
        self.params = params_from_numpy(self.model, arrays, device=self.device,
                                        n_entities=n)
        shapes = self.model.full_shapes
        if self.sem_cache is not None:
            cache = self.sem_cache
            with torch.no_grad():
                cache.buffer.copy_(self.params["sem_cache"])
                cache.slot_map.copy_(self.params["sem_slot"])
            self.params = {**self.params, "sem_cache": cache.buffer,
                           "sem_slot": cache.slot_map}
            cache.reset()
        self.params = {k: self.ctx.shard(k, v) for k, v in self.params.items()}
        self.params = self.model._set_params(self.params, n, shapes)
        self.opt_state = adam_init(self.params, self.cfg.adam, ctx=self.ctx)

    # ------------------------------------------------------------------ fns
    def loss_and_grads(self, prepared, pos: np.ndarray, neg: np.ndarray, params=None):
        """(loss, per-query loss, {name: gradient}) of one prepared batch, its
        ``pos``/``neg`` already in the plan's order, at ``params`` (the
        trainer's by default; under a mesh pass ``full_params()``). Frozen
        names get (1,) zero tokens, and a parameter the batch does not reach
        a zero gradient, as the reference's ``value_and_grad`` gives."""
        dev = self.device
        steps, ans = prepared.device_args(dev)
        return self._loss_and_grads(prepared, steps, ans, torch.from_numpy(pos).to(dev),
                                    torch.from_numpy(neg).to(dev), params)

    def _loss_and_grads(self, prepared, steps, ans, pos: torch.Tensor, neg: torch.Tensor,
                        params=None, scale: float = 1.0):
        """``loss_and_grads`` on inputs already on the device; the loss (and
        so every gradient) times ``scale`` where it is not 1."""
        return loss_and_grads(self.model, self.executor.encode_fn(prepared),
                              self.params if params is None else params, steps, ans,
                              pos, neg, scale)

    # ------------------------------------------------------------------ mesh
    def full_params(self) -> Dict[str, torch.Tensor]:
        """The whole parameter set: under a mesh gathered from every rank's
        shards (collective: call it on every rank, in the same place);
        single-device the params' own tensors. ``evaluate`` runs on it."""
        return gather_params(self.ctx, self.model, self.params)

    def _full_tree(self, params, opt_state) -> Dict:
        """A checkpoint's tree ({"params", "opt"}) of whole tensors: under a
        mesh gathered from the shards (collective), the moments of frozen
        names being (1,) tokens."""
        shapes = self._full_shapes()
        gather = self.ctx.gather
        full = {k: gather(k, params[k], shapes["params"][k]) for k in sorted(params)}
        moments = {part: {k: gather(k, opt_state[part][k], shapes["opt"][part][k])
                          for k in sorted(opt_state[part])} for part in ("m", "v")}
        return {"params": full, "opt": {**moments, "step": opt_state["step"]}}

    def _full_shapes(self) -> Dict:
        """The whole shape of every leaf of a checkpoint's tree, in its
        structure (the moments of frozen names are (1,) tokens)."""
        shapes = self.model.full_shapes
        frozen = set(self.cfg.adam.frozen)
        moments = {k: (1,) if k in frozen else shapes[k] for k in self.opt_state["m"]}
        return {"params": {k: shapes[k] for k in self.params},
                "opt": {"m": moments, "v": moments, "step": tuple(self.opt_state["step"].shape)}}

    def _save(self, step: int, params, opt_state, metadata=None, force=False) -> None:
        """Checkpoint at ``step`` if due (collective under a mesh: every rank
        gathers, rank 0 writes)."""
        if self.ckpt.due(step, force):
            self.ckpt.maybe_save(step, self._full_tree(params, opt_state), metadata=metadata,
                                 force=force, ctx=self.ctx)

    def _update(self, grads: Dict[str, torch.Tensor], n: int) -> None:
        """Adam, in place, on one step's gradients (``sharded_update``)."""
        sharded_update(self.ctx, grads, n, self.opt_state, self.params, self.cfg.adam)

    def _global(self, loss: torch.Tensor, per_q: torch.Tensor, local_order, n: int,
                global_order) -> Tuple[torch.Tensor, torch.Tensor]:
        """Under a mesh, the step's loss summed over the batch axes and its
        per-query losses (``per_q[j]`` belongs to local row
        ``local_order[j]``) gathered into the global batch's canonical order
        ``global_order``: the same on every rank. Collective. Single-device
        both pass through."""
        if not self.ctx.is_sharded:
            return loss, per_q
        loss = self.ctx.reduce_batch(loss.clone(), n)
        inv = np.empty_like(local_order)
        inv[local_order] = np.arange(len(local_order))
        rows = self.ctx.gather_rows(per_q[torch.from_numpy(inv).to(per_q.device)], n)
        return loss, rows[torch.from_numpy(global_order).to(per_q.device)]

    def prepared_step(self, prepared, steps, ans, pos, neg, n: int, global_order):
        """One pooled step of this rank's plan (of the whole batch of ``n``
        single-device): gather, local loss and gradients (times local/global
        rows), update; returns the global loss and per-query losses as
        device tensors. ``train_step``, the pipelined dispatch and the dry run
        (``launch/dryrun.py``, on meta tensors) call it."""
        full = self.full_params()
        loss, per_q, grads = self._loss_and_grads(prepared, steps, ans, pos, neg, full,
                                                  len(prepared.order) / n)
        del full
        self._update(grads, n)
        return self._global(loss, per_q, prepared.order, n, global_order)

    # ----------------------------------------------------------------- steps
    def train_step(self, batch: Optional[List[SampledQuery]] = None) -> Dict[str, float]:
        if batch is None:
            dist = self.adaptive.distribution() if self.adaptive else None
            with TRACER.span("sample", n=self.cfg.batch_size):
                batch = self.sampler.sample_batch(self.cfg.batch_size, dist)
        queries, pos, neg = self.sampler.to_training_arrays(batch, self.cfg.n_negatives)
        phases: Dict[str, float] = {}
        if self.sem_cache is not None:
            # Sync staging, before the step and outside its timing window.
            # Under a mesh every rank stages the whole global batch's ids.
            tp = time.perf_counter()
            with TRACER.span("sem_prefetch"):
                stage = self.sem_cache.plan(batch_entity_ids(queries, pos, neg))
            if stage is not None:
                self.sem_cache.apply_to(self.params, stage)
            phases["sem_prefetch_s"] = time.perf_counter() - tp
        n = len(queries)
        _, lq, lpos, lneg, global_order = rank_slice(self.ctx, queries, pos, neg)
        t0 = time.perf_counter()
        if isinstance(self.executor, PooledExecutor):
            with TRACER.span("schedule", n=len(lq)):
                prepared = self.executor.prepare(lq)
            phases["schedule_s"] = time.perf_counter() - t0
            td = time.perf_counter()
            with TRACER.span("dispatch"):
                dev = self.device
                steps, ans = prepared.device_args(dev)
                loss, per_q = self.prepared_step(
                    prepared, steps, ans, torch.from_numpy(lpos[prepared.order]).to(dev),
                    torch.from_numpy(lneg[prepared.order]).to(dev), n, global_order)
            phases["dispatch_s"] = time.perf_counter() - td
            self._phase_s["dispatch"].inc(phases["dispatch_s"])
            patterns = prepared.patterns
        else:  # query-level baseline: one fragmented pass per pattern group
            loss, per_q, patterns = self._query_level_step(lq, lpos, lneg, n, global_order)
        if global_order is not None:
            patterns = [queries[i].pattern for i in global_order]
        if self.mat_cache is not None:
            # The params were just updated in place: rows encoded under the
            # old values must never be served.
            self.mat_cache.bump_version("param_update")
        tr = time.perf_counter()
        with TRACER.span("retire"):
            loss = float(loss)
        phases["retire_s"] = time.perf_counter() - tr
        self._phase_s["retire"].inc(phases["retire_s"])
        self.last_per_q = per_q.cpu().numpy()
        if self.adaptive:
            self.adaptive.update(pattern_losses_from_batch(patterns, self.last_per_q))
        self._steps_done.inc()
        self.step += 1
        rec = {
            "step": self.step,
            "loss": loss,
            "queries_per_sec": len(queries) / max(time.perf_counter() - t0, 1e-9),
        }
        self.history.append(rec)
        if self.metrics_sink.enabled:
            # A record of its own, not extra keys on rec: history keeps its
            # shape.
            self.metrics_sink.write({"kind": "step", "mode": "sync", **rec, **phases})
        if self.ckpt:
            self._save(self.step, self.params, self.opt_state, metadata={"loss": loss})
        return rec

    def _query_level_step(self, queries, pos, neg, n_global: int, global_order=None):
        """Baseline: independent fragmented micro-steps per pattern, their
        gradients weighted by group size, summed, divided by B, then one
        Adam step. The loss is the group losses' size-weighted mean. Under a
        mesh the groups are this rank's rows' (of a global batch of
        ``n_global``), at the gathered parameters, and the loss and
        gradients are scaled by local/global rows before the update."""
        params = self.full_params()
        groups, idx = self.executor.prepare_groups(queries)
        losses, sizes, per_q_all, patterns, order = [], [], [], [], []
        grads_acc = None
        for pat, sub in groups.items():
            rows = np.asarray(idx[pat])
            prepared = self.executor.prepare(sub)
            loss, per_q, grads = self.loss_and_grads(
                prepared, pos[rows][prepared.order], neg[rows][prepared.order], params)
            w = len(rows)
            if grads_acc is None:
                grads_acc = {k: g * w for k, g in grads.items()}
            else:
                grads_acc = {k: grads_acc[k] + grads[k] * w for k in grads_acc}
            losses.append(loss)
            sizes.append(w)
            per_q_all.append(per_q)
            patterns.extend([pat] * w)
            order.append(rows[prepared.order])
        del params
        n = sum(sizes)
        grads_acc = {k: g / n for k, g in grads_acc.items()}
        total = sum(float(l) * w for l, w in zip(torch.stack(losses).cpu(), sizes))
        per_q = torch.cat(per_q_all)
        scale = n / n_global
        if scale != 1.0:
            grads_acc = {k: g * scale for k, g in grads_acc.items()}
        self._update(grads_acc, n_global)
        loss = torch.tensor(total / n * scale, dtype=torch.float64, device=self.device)
        loss, per_q = self._global(loss, per_q, np.concatenate(order), n_global,
                                   global_order)
        return loss, per_q, patterns

    # ------------------------------------------------------------------ loop
    def train(self, n_steps: int, log_every: int = 50, prefetcher=None,
              batches=None) -> List[Dict]:
        """Run ``n_steps``. ``batches`` pins the workload — a fixed batch
        list (cycled) or a zero-arg callable yielding batches — so tests can
        feed two trainers (or sync and pipelined mode) the SAME batches;
        otherwise batches come from ``prefetcher`` (a caller's
        ``BatchPrefetcher``, drawn from and left open, as in the reference)
        or from the online sampler. A pipelined run ignores ``prefetcher``."""
        if self.cfg.pipeline and isinstance(self.executor, PooledExecutor):
            return self._train_pipelined(n_steps, log_every, batches=batches)
        TRACER.set_lane("main dispatch")
        own = None
        # Under a mesh every rank samples inline from its seeded sampler:
        # the workers' own streams would differ between ranks.
        if (prefetcher is None and batches is None and self.cfg.prefetch > 0
                and not self.adaptive and not self.ctx.is_sharded):
            own = prefetcher = BatchPrefetcher(self.sampler, self.cfg.batch_size,
                                               depth=self.cfg.prefetch)
        try:
            for i in range(n_steps):
                if callable(batches):
                    batch = batches()
                elif batches is not None:
                    batch = batches[i % len(batches)]
                else:
                    batch = prefetcher.next() if prefetcher else None
                rec = self.train_step(batch)
                if log_every and (i + 1) % log_every == 0:
                    self._log(rec)
        finally:
            if own is not None:
                own.close()
        if self.ckpt:
            self._save(self.step, self.params, self.opt_state, force=True)
        return self.history

    def _log(self, rec: Dict) -> None:
        """The loss line (rank 0 alone under a mesh)."""
        if self.ctx.rank == 0:
            print(f"step {rec['step']:6d} loss {rec['loss']:.4f} "
                  f"q/s {rec['queries_per_sec']:.0f}")

    # ------------------------------------------------------------- pipelined
    def _prefetcher(self, batches=None) -> PreparedBatchPrefetcher:
        """The scheduler thread of a pipelined run, fed by ``batches`` (as in
        ``train``), by adaptive sampling with the latest π, or by sampling
        workers (under a mesh: by the trainer's seeded sampler, on the
        scheduler thread, so that every rank samples the same batches)."""
        batch_fn = None
        if callable(batches):
            batch_fn = batches
        elif batches is not None:
            it = itertools.cycle(batches)
            batch_fn = lambda: next(it)  # noqa: E731 — one scheduler thread
        elif self.adaptive:
            # Adaptive needs the latest distribution at sample time; sample
            # in the scheduler thread with a (≤ max_inflight steps) stale π.
            batch_fn = lambda: self.sampler.sample_batch(  # noqa: E731
                self.cfg.batch_size, self.adaptive.distribution())
        elif self.ctx.is_sharded:
            batch_fn = lambda: self.sampler.sample_batch(self.cfg.batch_size)  # noqa: E731
        return PreparedBatchPrefetcher(
            self.sampler, self.executor, self.cfg.batch_size, self.cfg.n_negatives,
            depth=max(self.cfg.prefetch, 1), batch_fn=batch_fn,
            sem_cache=self.sem_cache, mat_cache=self.mat_cache, ctx=self.ctx)

    def _dispatch(self, item) -> tuple:
        """Launch one prepared step on the main thread's current stream: wait
        for its copies, apply its hot-set stage, then the encode, loss,
        backward and Adam. No host sync: returns the loss and per-query loss
        as device tensors, read back by ``_retire``. Under a mesh the step's
        collectives run here, after ``ready()`` has ordered the side
        stream's copies before them (NCCL waits on the current stream), and
        the two tensors are the global loss and per-query losses."""
        item.ready()
        if item.sem_stage is not None:
            ta = time.perf_counter()
            with TRACER.span("sem_apply"):
                self.sem_cache.apply_to(self.params, item.sem_stage)
            item.phases["sem_apply_s"] = time.perf_counter() - ta
            self._phase_s["sem_apply"].inc(item.phases["sem_apply_s"])
        td, cd = time.perf_counter(), time.thread_time()
        with TRACER.span("dispatch"):
            loss, per_q = self.prepared_step(item.prepared, item.steps, item.ans, item.pos,
                                             item.neg, item.n_queries, item.global_order)
        if self.mat_cache is not None:
            # Adam updated the params in place: the scheduler thread's probes
            # pinned to the old version stop matching.
            self.mat_cache.bump_version("param_update")
        item.phases["dispatch_s"] = time.perf_counter() - td
        item.phases["dispatch_cpu_s"] = time.thread_time() - cd
        self._phase_s["dispatch"].inc(item.phases["dispatch_s"])
        return loss, per_q

    def _snapshot(self) -> tuple:
        """Copies of the params and the optimizer state, enqueued on the
        current stream, so they hold this point's values whatever later
        steps update in place."""
        opt = {"m": {k: v.clone() for k, v in self.opt_state["m"].items()},
               "v": {k: v.clone() for k, v in self.opt_state["v"].items()},
               "step": self.opt_state["step"].clone()}
        return {k: v.clone() for k, v in self.params.items()}, opt

    def _retire(self, pending, t_last: float, log_every: int) -> float:
        """Read one in-flight step's loss back (the only host sync of a
        pipelined step: it waits for that step alone) and fold it into the
        history. ``pending`` carries a snapshot of the params and optimizer
        state right after the retired step when it lands on a checkpoint
        boundary, since ``self.params`` may already hold later steps."""
        loss, per_q, patterns, n_queries, snap, phases = pending
        tr = time.perf_counter()
        with TRACER.span("retire"):
            loss = float(loss)
            per_q = per_q.cpu().numpy()
        now = time.perf_counter()
        phases["retire_s"] = now - tr
        phases["t_retired"] = now
        self._phase_s["retire"].inc(phases["retire_s"])
        self.last_per_q = per_q
        if self.adaptive:
            self.adaptive.update(pattern_losses_from_batch(patterns, per_q))
        self.step += 1
        self._steps_done.inc()
        rec = {"step": self.step, "loss": loss,
               "queries_per_sec": n_queries / max(now - t_last, 1e-9)}
        self.history.append(rec)
        self.step_phases.append(phases)
        if self.metrics_sink.enabled:
            # The bubble: the main thread's wait for the scheduler thread over
            # the step's wall time. The record carries the JAX package's keys
            # (the wait as ``wait_s``), not the threads' CPU times.
            wall = max(now - t_last, 1e-9)
            self.metrics_sink.write({
                "kind": "step", "mode": "pipelined", **rec,
                **{("wait_s" if k == "pipeline_wait_s" else k): v
                   for k, v in phases.items() if k not in _PORT_ONLY_PHASES},
                "bubble_frac": min(phases.get("pipeline_wait_s", 0.0) / wall, 1.0),
                "wall_s": wall,
            })
        if log_every and self.step % log_every == 0:
            self._log(rec)
        if self.ckpt and snap is not None:
            self._save(self.step, *snap, metadata={"loss": loss})
        return now

    def _train_pipelined(self, n_steps: int, log_every: int, batches=None) -> List[Dict]:
        """Dataflow mode (module docstring): the scheduler thread builds
        device-ready work items, the main thread dispatches them and retires
        finished steps from a window of ``max_inflight``. An error on the
        scheduler thread surfaces here. On exit the cache's residency is
        reconciled, since items the scheduler thread prepared ahead hold
        stages that were planned and never applied."""
        pf = self._prefetcher(batches)
        # The main thread takes the GIL back after every launch that released
        # it; the default 5 ms switch interval would make each take wait on
        # the scheduler thread. Restored on exit.
        old_switch = sys.getswitchinterval()
        if self.cfg.gil_switch_interval:
            sys.setswitchinterval(self.cfg.gil_switch_interval)
        inflight: deque = deque()
        window = max(self.cfg.max_inflight, 1)
        t_last = time.perf_counter()
        TRACER.set_lane("main dispatch")
        try:
            for _ in range(n_steps):
                tw = time.perf_counter()
                with TRACER.span("pipeline_wait"):
                    item = pf.next()   # a wait here is the pipeline's bubble
                item.phases["pipeline_wait_s"] = time.perf_counter() - tw
                self._phase_s["pipeline_wait"].inc(item.phases["pipeline_wait_s"])
                loss, per_q = self._dispatch(item)
                step_no = self.step + len(inflight) + 1
                snap = None
                if self.ckpt and self.ckpt.every > 0 and step_no % self.ckpt.every == 0:
                    snap = self._snapshot()
                inflight.append((loss, per_q, item.patterns, item.n_queries, snap,
                                 item.phases))
                self._inflight_gauge.set(len(inflight))
                while len(inflight) >= window:
                    t_last = self._retire(inflight.popleft(), t_last, log_every)
                    self._inflight_gauge.set(len(inflight))
            while inflight:
                t_last = self._retire(inflight.popleft(), t_last, log_every)
                self._inflight_gauge.set(len(inflight))
        finally:
            sys.setswitchinterval(old_switch)
            pf.close()
            if self.sem_cache is not None:
                self.sem_cache.reconcile()
        if self.ckpt:
            self._save(self.step, self.params, self.opt_state, force=True)
        return self.history

    # ---------------------------------------------------------------- resume
    def resume(self) -> bool:
        """Restore the newest valid checkpoint into the parameters and
        optimizer state (in place). False when there is none. Under a
        semantic cache its residency is reset: the restored hot set does not
        match the metadata, so the next step restages its rows. Under a mesh
        every rank reads the whole arrays and keeps this mesh's shard of
        each, whatever mesh wrote them."""
        if not self.ckpt:
            return False
        restored = self.ckpt.restore(template={"params": self.params, "opt": self.opt_state},
                                     ctx=self.ctx, shapes=self._full_shapes(),
                                     n_entities=self.kg.n_entities)
        if restored is None:
            return False
        self.step, tree, _ = restored
        with torch.no_grad():
            for k, v in tree["params"].items():
                self.params[k].copy_(v)
            for part in ("m", "v"):
                for k, v in tree["opt"][part].items():
                    self.opt_state[part][k].copy_(v)
        self.opt_state["step"] = tree["opt"]["step"]
        if self.sem_cache is not None:
            self.sem_cache.reset()
        return True
