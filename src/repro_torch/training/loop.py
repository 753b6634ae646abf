"""End-to-end NGDB training loop: online sampling → operator-level scheduling
→ pooled execution under autograd → vectorized loss → Adam, with adaptive
sampling and fault-tolerant checkpointing.

This is the reference trainer's **sync** mode (``pipeline=False``): each step
runs sampling → Algorithm-1 scheduling → the device step → the loss readback
in sequence. Batches are sampled inline on the calling thread, as the
reference does with ``prefetch=0``; ``prefetch`` is kept as a field and not
read. Two executors:

* ``pooled`` — the paper's operator-level batching: one pooled encode of the
  whole batch (CSE-shared rows included), one loss, one Adam step;
* ``query_level`` — the baseline: one encode, loss and gradient per pattern
  group, the gradients weighted by group size and divided by B before one
  Adam step.

PyTorch runs eagerly, so there is no step program to compile or cache; the
executor keeps its signature-keyed encode closures. On CUDA, BetaE's
intersection and union go through the ``intersect`` kernel and its
hand-written backward (``kernels/intersect.py``).

Semantic augmentation (§4.4, Eq. 11+12): with ``semantic_table=`` (H_sem
resident on the device) or ``semantic_cache=`` (a bounded hot set of a
``SemanticStore``), a model with ``semantic_dim > 0`` fuses every entity it
gathers through ``gather_fuse`` — on CUDA the kernel, and its hand-written
backward (``kernels/gather_fuse.py``). H_sem is frozen. Under a cache, each
step first stages the rows it gathers (``cache.plan`` of
``batch_entity_ids``, then ``apply_to``), outside the step's timing window,
as the reference's sync mode does.

Later slices bring the rest of the reference trainer; each raises
``NotImplementedError`` here: ``pipeline=True`` (slice 4),
``materialized_rows > 0`` (slice 5), ``metrics_path`` (slice 6) and a mesh
``ctx`` (slice 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import PooledExecutor, QueryLevelExecutor
from repro_torch.core.patterns import TEMPLATES
from repro_torch.data.pipeline import batch_entity_ids
from repro_torch.sampling.adaptive import AdaptiveDistribution, pattern_losses_from_batch
from repro_torch.sampling.online import OnlineSampler, SampledQuery
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.loss import negative_sampling_loss
from repro_torch.training.optim import AdamConfig, adam_init, adam_update


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
    prefetch: int = 2               # kept for the reference's surface; the
    #                                 port samples inline (slice 4 pipelines)
    pipeline: bool = False          # slice 4
    max_inflight: int = 2           # pipelined only (slice 4)
    compile_cache_size: int = 128   # LRU capacity of the encode closures
    gil_switch_interval: float = 2e-3  # pipelined only (slice 4)
    cse: bool = True                # cross-query subexpression sharing
    #                                 (False = --no-cse ablation baseline)
    materialized_rows: int = 0      # slice 5
    metrics_path: Optional[str] = None  # slice 6


def _later(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet: it comes with {where}")


class NGDBTrainer:
    """Sync-mode trainer on the model's device. Parameters are drawn from a
    ``torch.Generator`` seeded with ``cfg.seed``; ``params`` and
    ``opt_state`` are updated in place each step. ``semantic_table`` or
    ``semantic_cache`` carry H_sem for a model with ``semantic_dim > 0``
    (``QueryEncoder.init_params``)."""

    def __init__(self, model, kg, cfg: TrainConfig, semantic_table=None,
                 semantic_cache=None, ctx=None):
        if cfg.pipeline:
            _later("pipeline=True", "slice 4 (pipelined training)")
        if cfg.materialized_rows > 0:
            _later("materialized_rows > 0", "slice 5 (caches)")
        if cfg.metrics_path is not None:
            _later("metrics_path", "slice 6 (telemetry)")
        if ctx is not None:
            _later("a mesh ctx", "slice 9 (distribution)")
        if cfg.executor not in ("pooled", "query_level"):
            raise ValueError(f"executor must be 'pooled' or 'query_level', "
                             f"got {cfg.executor!r}")
        self.model = model
        self.kg = kg
        self.cfg = cfg
        self.device = model.device
        if cfg.executor == "pooled":
            self.executor = PooledExecutor(model, b_max=cfg.b_max, cse=cfg.cse,
                                           cache_size=cfg.compile_cache_size,
                                           device=self.device)
        else:
            self.executor = QueryLevelExecutor(model, b_max=cfg.b_max, device=self.device)
        # Out of core, the params carry the cache's bounded hot set and its
        # id -> slot map instead of H_sem; every step stages its rows first.
        self.sem_cache = semantic_cache
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = model.init_params(gen, kg.n_entities, kg.n_relations,
                                        semantic_table=semantic_table,
                                        semantic_cache=semantic_cache)
        self.opt_state = adam_init(self.params, cfg.adam)
        self.sampler = OnlineSampler(kg, patterns=cfg.patterns, seed=cfg.seed)
        self.adaptive = AdaptiveDistribution(cfg.patterns) if cfg.adaptive else None
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, every=cfg.checkpoint_every)
                     if cfg.checkpoint_dir else None)
        self.step = 0
        self.history: List[Dict] = []

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
        if self.sem_cache is not None:
            cache = self.sem_cache
            with torch.no_grad():
                cache.buffer.copy_(self.params["sem_cache"])
                cache.slot_map.copy_(self.params["sem_slot"])
            self.params = self.model._set_params(
                {**self.params, "sem_cache": cache.buffer, "sem_slot": cache.slot_map}, n)
            cache.reset()
        self.opt_state = adam_init(self.params, self.cfg.adam)

    # ------------------------------------------------------------------ fns
    def _split_frozen(self, params):
        """(trainable, frozen) views of the params dict. Frozen buffers are
        closed over by the loss, so no gradient is made for them."""
        frozen_names = set(self.model.frozen_param_names())
        trainable = {k: v for k, v in params.items() if k not in frozen_names}
        frozen = {k: v for k, v in params.items() if k in frozen_names}
        return trainable, frozen

    def loss_and_grads(self, prepared, pos: np.ndarray, neg: np.ndarray):
        """(loss, per-query loss, {name: gradient}) of one prepared batch, its
        ``pos``/``neg`` already in the plan's order. Frozen names get (1,)
        zero tokens, and a parameter the batch does not reach a zero
        gradient, as the reference's ``value_and_grad`` gives."""
        dev = self.device
        trainable, frozen = self._split_frozen(self.params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
        p = {**leaves, **frozen}
        steps, ans = prepared.device_args(dev)
        with torch.enable_grad():
            q = self.executor.encode_fn(prepared)(p, steps, ans)
            loss, per_q = negative_sampling_loss(
                self.model, p, q, torch.from_numpy(pos).to(dev),
                torch.from_numpy(neg).to(dev))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        out = {k: torch.zeros_like(v) if g is None else g
               for (k, v), g in zip(leaves.items(), grads)}
        out.update({k: torch.zeros((1,), dtype=torch.float32, device=dev) for k in frozen})
        return loss.detach(), per_q.detach(), out

    # ----------------------------------------------------------------- steps
    def train_step(self, batch: Optional[List[SampledQuery]] = None) -> Dict[str, float]:
        if batch is None:
            dist = self.adaptive.distribution() if self.adaptive else None
            batch = self.sampler.sample_batch(self.cfg.batch_size, dist)
        queries, pos, neg = self.sampler.to_training_arrays(batch, self.cfg.n_negatives)
        if self.sem_cache is not None:
            # Sync staging, before the step and outside its timing window.
            stage = self.sem_cache.plan(batch_entity_ids(queries, pos, neg))
            if stage is not None:
                self.sem_cache.apply_to(self.params, stage)
        t0 = time.perf_counter()
        if isinstance(self.executor, PooledExecutor):
            prepared = self.executor.prepare(queries)
            loss, per_q, grads = self.loss_and_grads(
                prepared, pos[prepared.order], neg[prepared.order])
            adam_update(grads, self.opt_state, self.params, self.cfg.adam)
            loss = float(loss)
            patterns = prepared.patterns
        else:  # query-level baseline: one fragmented pass per pattern group
            loss, per_q, patterns = self._query_level_step(queries, pos, neg)
        if self.adaptive:
            self.adaptive.update(pattern_losses_from_batch(patterns, per_q.cpu().numpy()))
        self.step += 1
        rec = {
            "step": self.step,
            "loss": loss,
            "queries_per_sec": len(queries) / max(time.perf_counter() - t0, 1e-9),
        }
        self.history.append(rec)
        if self.ckpt:
            self.ckpt.maybe_save(self.step, {"params": self.params, "opt": self.opt_state},
                                 metadata={"loss": loss})
        return rec

    def _query_level_step(self, queries, pos, neg):
        """Baseline: independent fragmented micro-steps per pattern, their
        gradients weighted by group size, summed, divided by B, then one
        Adam step. The loss is the group losses' size-weighted mean."""
        groups, idx = self.executor.prepare_groups(queries)
        losses, sizes, per_q_all, patterns = [], [], [], []
        grads_acc = None
        for pat, sub in groups.items():
            rows = np.asarray(idx[pat])
            prepared = self.executor.prepare(sub)
            loss, per_q, grads = self.loss_and_grads(
                prepared, pos[rows][prepared.order], neg[rows][prepared.order])
            w = len(rows)
            if grads_acc is None:
                grads_acc = {k: g * w for k, g in grads.items()}
            else:
                grads_acc = {k: grads_acc[k] + grads[k] * w for k in grads_acc}
            losses.append(loss)
            sizes.append(w)
            per_q_all.append(per_q)
            patterns.extend([pat] * w)
        n = sum(sizes)
        grads_acc = {k: g / n for k, g in grads_acc.items()}
        adam_update(grads_acc, self.opt_state, self.params, self.cfg.adam)
        total = sum(float(l) * w for l, w in zip(torch.stack(losses).cpu(), sizes))
        return total / n, torch.cat(per_q_all), patterns

    # ------------------------------------------------------------------ loop
    def train(self, n_steps: int, log_every: int = 50, batches=None) -> List[Dict]:
        """Run ``n_steps``. ``batches`` pins the workload — a fixed batch
        list (cycled) or a zero-arg callable yielding batches — so tests can
        feed two trainers the SAME batches; otherwise batches come from the
        online sampler."""
        for i in range(n_steps):
            if callable(batches):
                batch = batches()
            elif batches is not None:
                batch = batches[i % len(batches)]
            else:
                batch = None
            rec = self.train_step(batch)
            if log_every and (i + 1) % log_every == 0:
                print(f"step {rec['step']:6d} loss {rec['loss']:.4f} "
                      f"q/s {rec['queries_per_sec']:.0f}")
        if self.ckpt:
            self.ckpt.maybe_save(self.step, {"params": self.params, "opt": self.opt_state},
                                 force=True)
        return self.history

    # ---------------------------------------------------------------- resume
    def resume(self) -> bool:
        """Restore the newest valid checkpoint into the parameters and
        optimizer state (in place). False when there is none. Under a
        semantic cache its residency is reset: the restored hot set does not
        match the metadata, so the next step restages its rows."""
        if not self.ckpt:
            return False
        restored = self.ckpt.restore(template={"params": self.params, "opt": self.opt_state})
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
