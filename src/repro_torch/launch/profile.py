"""Where one serving micro-batch, and one training step, spend their time on
the GPU.

For all six families at full width on FB15k's Table 4 shape, and for
GQE with H_sem (d_l 1024, built by the stub PTE into a temporary store) in
its resident and out-of-core layouts, serves warm micro-batches of 16 (the
engine's ``max_batch``) through ``serve_batch``'s phases (hot-set staging,
pooled encode, all-entity scoring, host top-k) and prints, per model:

* the wall time of each phase (host clock, ``torch.cuda.synchronize()`` at
  each phase boundary), median over 10 batches;
* the card's busy time per batch (sum of kernel and copy times from a
  ``torch.profiler`` trace of the same batches) and its share of the wall
  time — how far the host holds the card back;
* the kernels that take the most device time;
* out of core, what the chunked scorer's host side costs alone: reading
  every row from the store, and copying them to the card from pageable
  memory.

Then, for BetaE and GQE at ``ModelConfig()`` with ``TrainConfig()``'s
defaults (batch 512, 64 negatives, all 14 patterns), pooled and query-level,
and for GQE with H_sem (the same store) resident, pooled and query-level,
and behind a hot set of the reference launcher's budget, pooled: a training
step's wall time (median over warm steps, each ending in the loss readback)
and its phases (negatives, hot-set staging, plan, device step), the card's
busy time per step from a trace of the same steps, and the kernels that
take the most device time; for semantic training also the device ms a step
of the ``gather_fuse`` backward's own kernels (``fuse_bwd_*``).

For BetaE and GQE pooled, and GQE with H_sem behind the hot set, the same
training with ``TrainConfig(pipeline=True)`` follows each sync row: the
wall a step (median of the intervals between retires), the scheduler
thread's phases (raw batch, negatives, hot-set staging, plan, copies to the
card) and the main thread's (waiting for an item, applying the hot-set
stage, dispatching the step, reading its loss back), medians, each thread's
CPU time a step (the two share one GIL), and the card's busy time per step
from a trace of more pipelined steps.

``--pipeline-ab`` runs only the sync against pipelined comparison of those
three cells: alternating pairs of fresh trainers on the same batches in one
process, steps/s of each run.

    PYTHONPATH=src python -m repro_torch.launch.profile [--pipeline-ab]
"""
from __future__ import annotations

import json
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import PooledExecutor
from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, make_model
from repro_torch.semantic import (SemanticCache, StubPTE,
                                  precompute_semantic_table_to_store,
                                  training_budget_rows)
from repro_torch.serving import make_workload, scorer_for, topk_desc

FAMILIES = ("betae", "gqe", "complex", "q2b", "q2p", "fuzzqe")
BATCH = 16     # queries per micro-batch
REPS = 10      # batches timed, then traced
TOP = 12       # kernels listed by device time


def _device_us(evt) -> float:
    # ``self_device_time_total`` (PyTorch >= 2.4) was ``self_cuda_time_total``.
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _on_device(evt) -> bool:
    """Kernels and copies; operator events on the CPU also carry the device
    time of the kernels they launched, which must not count twice."""
    return evt.device_type != torch.autograd.DeviceType.CPU


def profile_family(family: str, kg, device, store=None,
                   layout: str = "") -> dict:
    """One model's warm micro-batches. With ``store``, GQE carries H_sem
    ``resident`` on the card or ``out-of-core`` behind a 2,048-row hot set."""
    gen = torch.Generator(device=device).manual_seed(1)
    E, R = kg.n_entities, kg.n_relations
    cache = None
    if store is None:
        model = make_model(family, ModelConfig(), device=device)
        params = model.init_params(gen, E, R)
    else:
        model = make_model(family, ModelConfig(semantic_dim=store.dim),
                           device=device)
        if layout == "resident":
            table = np.concatenate([rows for _, rows in store.iter_shards()])
            params = model.init_params(gen, E, R, semantic_table=table)
        else:
            cache = SemanticCache(store, budget_rows=2048, device=device)
            params = model.init_params(gen, E, R, semantic_cache=cache)
        family = f"{family}+semantic [{layout}]"
    executor = PooledExecutor(model, b_max=256, device=device)
    scorer = scorer_for(model)
    batches = [make_workload(kg, BATCH, seed=100 + i) for i in range(REPS)]

    def serve(queries, phases=None):
        t0 = time.perf_counter()
        if cache is not None:
            stage = cache.plan(np.concatenate([q.anchors for q in queries]))
            if stage is not None:
                cache.apply_to(params, stage)
            torch.cuda.synchronize()
        ts = time.perf_counter()
        states = executor.encode(params, queries)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if cache is not None:
            scores = model.score_all_chunked(params, states, store.read_rows)
        else:
            scores = scorer(params, states).cpu().numpy()
        t2 = time.perf_counter()
        topk_desc(scores, 10)
        t3 = time.perf_counter()
        if phases is not None:
            phases.append((ts - t0, t1 - ts, t2 - t1, t3 - t2))

    for q in batches:   # warm: plans, closures, kernel library, allocator
        serve(q)
    phases = []
    for q in batches:
        serve(q, phases)
    walls = [sum(p) * 1e3 for p in phases]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for q in batches:
            serve(q)
    events = [e for e in prof.key_averages() if _on_device(e)]
    device_ms = sum(_device_us(e) for e in events) / 1e3 / len(batches)
    wall_ms = statistics.median(walls)
    print(f"{family} on {torch.cuda.get_device_name(device)}: "
          f"{BATCH} queries per batch, {len(batches)} batches")
    for name, i in (("stage", 0), ("encode", 1), ("score", 2), ("top-k (host)", 3)):
        print(f"  {name:13s} wall {statistics.median(p[i] for p in phases) * 1e3:8.3f} ms")
    out = {}
    if cache is not None:
        reads, copies = [], []
        for _ in range(REPS):
            t0 = time.perf_counter()
            rows = store.read_rows(np.arange(E))
            t1 = time.perf_counter()
            torch.from_numpy(rows).to(device)
            torch.cuda.synchronize()
            copies.append(time.perf_counter() - t1)
            reads.append(t1 - t0)
        out = {"store_read_ms": statistics.median(reads) * 1e3,
               "h2d_copy_ms": statistics.median(copies) * 1e3,
               "h2d_bytes": rows.nbytes}
        print(f"  of the score phase: store read of all {E} rows "
              f"{out['store_read_ms']:.3f} ms, host->device copy of "
              f"{rows.nbytes / 1e6:.1f} MB (pageable) {out['h2d_copy_ms']:.3f} ms")
    print(f"  device busy {device_ms:.3f} ms of {wall_ms:.3f} ms wall per batch "
          f"({device_ms / wall_ms:.1%})")
    for e in sorted(events, key=_device_us, reverse=True)[:TOP]:
        if _device_us(e) > 0:
            print(f"    {_device_us(e) / 1e3 / len(batches):8.4f} ms/batch "
                  f"{e.count // len(batches):5d} calls/batch  {e.key[:80]}")
    return {"model": family, "batch": BATCH, "wall_ms_per_batch": wall_ms,
            "device_ms_per_batch": device_ms, "device_busy": device_ms / wall_ms,
            **out}


def _top_kernels(events, per: int) -> None:
    for e in sorted(events, key=_device_us, reverse=True)[:TOP]:
        if _device_us(e) > 0:
            print(f"    {_device_us(e) / 1e3 / per:8.4f} ms/step "
                  f"{e.count // per:5d} calls/step  {e.key[:80]}")


def profile_training(family: str, mode: str, kg, device, store=None,
                     layout: str = "") -> dict:
    """Warm sync training steps of ``family`` with the ``mode`` executor,
    split into the trainer's phases: negatives (``to_training_arrays`` on
    the host), hot-set staging (``plan`` and ``apply_to``, out of core only),
    the plan (``prepare`` on the host: canonicalize, CSE, Max-Fillness;
    every batch is fresh, so no plan is reused) and the device step (encode,
    loss, backward, Adam, the loss readback). With ``store``, the model
    carries H_sem ``resident`` or behind a ``hot set`` of the reference
    launcher's budget."""
    from repro_torch.data import batch_entity_ids
    from repro_torch.sampling import OnlineSampler
    from repro_torch.training import NGDBTrainer, TrainConfig
    from repro_torch.training.optim import adam_update

    cfg = TrainConfig(executor=mode)
    sem, cache, mcfg, label = {}, None, ModelConfig(), family
    if store is not None:
        mcfg = ModelConfig(semantic_dim=store.dim)
        if layout == "resident":
            sem = {"semantic_table": np.concatenate([r for _, r in store.iter_shards()])}
        else:
            budget = training_budget_rows(kg.n_entities, cfg.batch_size, cfg.n_negatives)
            cache = SemanticCache(store, budget_rows=budget, device=device)
            sem = {"semantic_cache": cache}
        label = f"{family}+semantic [{layout}]"
    trainer = NGDBTrainer(make_model(family, mcfg, device=device), kg, cfg, **sem)
    sampler = OnlineSampler(kg, patterns=cfg.patterns, seed=11)
    batches = [sampler.sample_batch(cfg.batch_size) for _ in range(2 * REPS + 3)]
    ex = trainer.executor
    for b in batches[:3]:   # warm: closures, kernel library, allocator
        trainer.train_step(b)
    phases = []
    for b in batches[3:3 + REPS]:
        t0 = time.perf_counter()
        queries, pos, neg = trainer.sampler.to_training_arrays(b, cfg.n_negatives)
        ts = time.perf_counter()
        if cache is not None:
            stage = cache.plan(batch_entity_ids(queries, pos, neg))
            if stage is not None:
                cache.apply_to(trainer.params, stage)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if mode == "pooled":
            plan = ex.prepare(queries)
            t2 = time.perf_counter()
            loss, _, grads = trainer.loss_and_grads(plan, pos[plan.order], neg[plan.order])
            adam_update(grads, trainer.opt_state, trainer.params, cfg.adam)
            float(loss)
        else:
            for group in ex.prepare_groups(queries)[0].values():
                ex.prepare(group)
            t2 = time.perf_counter()
            trainer._query_level_step(queries, pos, neg, len(queries))   # plans cached
        t3 = time.perf_counter()
        phases.append((ts - t0, t2 - t1, t3 - t2, t1 - ts))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    traced = batches[3 + REPS:]
    with torch.profiler.profile(activities=acts) as prof:
        for b in traced:
            trainer.train_step(b)
    events = [e for e in prof.key_averages() if _on_device(e)]
    device_ms = sum(_device_us(e) for e in events) / 1e3 / len(traced)
    # The gather_fuse backward's own launches (csrc/gather_fuse_backward.cu),
    # without the id sort and the zeroed dh_str its wrapper adds.
    fuse_bwd_ms = sum(_device_us(e) for e in events
                      if "fuse_bwd_" in e.key) / 1e3 / len(traced)
    med = [statistics.median(p[i] for p in phases) * 1e3 for i in range(4)]
    wall_ms = statistics.median(sum(p) for p in phases) * 1e3
    print(f"train {label} [{mode}] on {torch.cuda.get_device_name(device)}: "
          f"{cfg.batch_size} queries per step, {REPS} steps; wall {wall_ms:.3f} ms/step: "
          f"negatives {med[0]:.3f}, staging {med[3]:.3f}, plan {med[1]:.3f}, device step "
          f"{med[2]:.3f} (medians); device busy {device_ms:.3f} ms/step "
          f"({device_ms / wall_ms:.1%}, traced train_step)"
          + (f"; gather_fuse backward kernels {fuse_bwd_ms:.3f} ms/step" if fuse_bwd_ms else ""))
    _top_kernels(events, len(traced))
    return {"train": label, "executor": mode, "batch": cfg.batch_size,
            "wall_ms_per_step": wall_ms, "negatives_ms": med[0], "staging_ms": med[3],
            "plan_ms": med[1], "device_step_ms": med[2], "device_ms_per_step": device_ms,
            "device_busy": device_ms / wall_ms, "gather_fuse_backward_ms_per_step": fuse_bwd_ms}


PIPE_SCHEDULER = ("sample", "negatives", "sem_prefetch", "schedule", "transfer")
PIPE_MAIN = ("pipeline_wait", "sem_apply", "dispatch", "retire")
# Each thread's CPU time a step; means, since the thread clock may tick in ms.
PIPE_CPU = ("scheduler_cpu", "dispatch_cpu")
PAIRS = 10     # sync/pipelined pairs of --pipeline-ab, in alternating order


def profile_pipelined(family: str, kg, device, store=None, layout: str = "") -> dict:
    """Warm pipelined training steps of ``family`` (pooled), split into the
    scheduler thread's phases and the main thread's, and the card's busy
    time per step from a trace of ``REPS`` more steps. With ``store``, GQE
    carries H_sem behind a hot set of the reference launcher's budget."""
    from repro_torch.sampling import OnlineSampler
    from repro_torch.training import NGDBTrainer, TrainConfig

    cfg = TrainConfig(pipeline=True)
    sem, mcfg, label = {}, ModelConfig(), family
    if store is not None:
        mcfg = ModelConfig(semantic_dim=store.dim)
        budget = training_budget_rows(kg.n_entities, cfg.batch_size, cfg.n_negatives)
        sem = {"semantic_cache": SemanticCache(store, budget_rows=budget, device=device)}
        label = f"{family}+semantic [{layout}]"
    trainer = NGDBTrainer(make_model(family, mcfg, device=device), kg, cfg, **sem)
    sampler = OnlineSampler(kg, patterns=cfg.patterns, seed=11)
    batches = [sampler.sample_batch(cfg.batch_size) for _ in range(2 * REPS + 3)]
    # Three warm steps (closures, kernel library, allocator), then REPS timed.
    trainer.train(3 + REPS, log_every=0, batches=batches[:3 + REPS])
    timed = trainer.step_phases[3:]
    walls = np.diff([p["t_retired"] for p in trainer.step_phases[2:]]) * 1e3
    med = {k: statistics.median(p.get(k + "_s", 0.0) for p in timed) * 1e3
           for k in PIPE_SCHEDULER + PIPE_MAIN}
    med.update({k: statistics.fmean(p[k + "_s"] for p in timed) * 1e3 for k in PIPE_CPU})
    wall_ms = float(statistics.median(walls))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train(REPS, log_every=0, batches=batches[3 + REPS:])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _on_device(e)]
    device_ms = sum(_device_us(e) for e in events) / 1e3 / REPS
    print(f"train {label} [pooled, pipelined] on {torch.cuda.get_device_name(device)}: "
          f"{cfg.batch_size} queries per step, {REPS} steps; wall {wall_ms:.3f} ms/step "
          f"(median between retires); scheduler thread "
          + ", ".join(f"{k} {med[k]:.3f}" for k in PIPE_SCHEDULER)
          + "; main thread " + ", ".join(f"{k} {med[k]:.3f}" for k in PIPE_MAIN)
          + " (medians, ms); CPU time a step (means, ms) "
          + ", ".join(f"{k} {med[k]:.3f}" for k in PIPE_CPU)
          + f"; device busy {device_ms:.3f} ms/step "
          f"({device_ms / wall_ms:.1%}, traced pipelined steps)")
    _top_kernels(events, REPS)
    return {"train": label, "executor": "pooled", "pipeline": True, "batch": cfg.batch_size,
            "wall_ms_per_step": wall_ms, **{f"{k}_ms": med[k] for k in med},
            "device_ms_per_step": device_ms, "device_busy": device_ms / wall_ms}


def _trainer(family: str, kg, device, pipeline: bool, store=None):
    from repro_torch.training import NGDBTrainer, TrainConfig

    cfg = TrainConfig(pipeline=pipeline)
    if store is None:
        return NGDBTrainer(make_model(family, ModelConfig(), device=device), kg, cfg)
    budget = training_budget_rows(kg.n_entities, cfg.batch_size, cfg.n_negatives)
    return NGDBTrainer(make_model(family, ModelConfig(semantic_dim=store.dim), device=device),
                       kg, cfg, semantic_cache=SemanticCache(store, budget, device=device))


def compare_pipelined(family: str, kg, device, store=None, pairs: int = PAIRS) -> dict:
    """Sync against pipelined steps/s in one process: ``pairs`` pairs of
    fresh trainers on the same 22 fresh batches, the order alternating
    (sync first in even pairs). Each run is timed as ``chip_smoke.py``
    phase 5c times it: sync over 20 steps after 2 warm-up steps, pipelined
    from the retire of step 2 to that of step 22 in one ``train`` call.
    With ``store``, GQE carries H_sem behind a hot set of the reference
    launcher's budget."""
    from repro_torch.sampling import OnlineSampler
    from repro_torch.training import TrainConfig

    cfg = TrainConfig()
    sampler = OnlineSampler(kg, patterns=cfg.patterns, seed=13)
    batches = [sampler.sample_batch(cfg.batch_size) for _ in range(22)]
    rates = {False: [], True: []}
    for i in range(pairs):
        for pipeline in ((False, True) if i % 2 == 0 else (True, False)):
            tr = _trainer(family, kg, device, pipeline, store)
            if pipeline:
                tr.train(22, log_every=0, batches=batches)
                wall = tr.step_phases[-1]["t_retired"] - tr.step_phases[1]["t_retired"]
            else:
                tr.train(2, log_every=0, batches=batches[:2])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train(20, log_every=0, batches=batches[2:])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rates[pipeline].append(20 / wall)
            del tr
            torch.cuda.empty_cache()
    ratio = [p / s for s, p in zip(rates[False], rates[True])]
    q = np.percentile(rates[False], [25, 75])
    label = family if store is None else f"{family}+semantic [hot set]"
    print(f"train {label} [pooled] sync vs pipelined on {torch.cuda.get_device_name(device)}, "
          f"{pairs} pairs (steps/s): sync " + " ".join(f"{r:.2f}" for r in rates[False])
          + " | pipelined " + " ".join(f"{r:.2f}" for r in rates[True])
          + f" | medians {statistics.median(rates[False]):.2f} / "
          f"{statistics.median(rates[True]):.2f}, ratio median {statistics.median(ratio):.3f}, "
          f"pipelined faster in {sum(r > 1 for r in ratio)} of {pairs} pairs, sync "
          f"interquartile {q[0]:.2f}-{q[1]:.2f}")
    return {"train": label, "pairs": pairs, "sync_steps_per_s": rates[False],
            "pipelined_steps_per_s": rates[True], "ratio_median": statistics.median(ratio)}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pipeline-ab", action="store_true",
                    help="only sync against pipelined training, in alternating pairs")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    kg, _, _ = load_dataset("FB15k", reduced=False, seed=0)
    if args.pipeline_ab:
        for family in ("betae", "gqe"):
            print(json.dumps(compare_pipelined(family, kg, device)))
        directory = tempfile.mkdtemp(prefix="profile_semstore_")
        try:
            store = precompute_semantic_table_to_store(kg, directory, StubPTE(device=device))
            print(json.dumps(compare_pipelined("gqe", kg, device, store)))
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        return
    for family in ("betae", "gqe"):
        for mode in ("pooled", "query_level"):
            print(json.dumps(profile_training(family, mode, kg, device)))
            torch.cuda.empty_cache()
            if mode == "pooled":
                print(json.dumps(profile_pipelined(family, kg, device)))
                torch.cuda.empty_cache()
    for family in FAMILIES:
        print(json.dumps(profile_family(family, kg, device)))
        torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="profile_semstore_")
    try:
        store = precompute_semantic_table_to_store(kg, directory,
                                                   StubPTE(device=device))
        for layout in ("resident", "out-of-core"):
            print(json.dumps(profile_family("gqe", kg, device, store, layout)))
            torch.cuda.empty_cache()
        for layout, mode in (("resident", "pooled"), ("resident", "query_level"),
                             ("hot set", "pooled")):
            print(json.dumps(profile_training("gqe", mode, kg, device, store, layout)))
            torch.cuda.empty_cache()
        print(json.dumps(profile_pipelined("gqe", kg, device, store, "hot set")))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(directory, ignore_errors=True)


if __name__ == "__main__":
    main()
