"""NGDB serving driver — a thin CLI over the continuous-batching engine.

Generates a deterministic mixed-pattern request stream and drives the
``ServingEngine`` closed-loop (``--concurrency`` requests in flight),
reporting QPS, p50/p95/p99 latency, batch shape statistics and steady-state
retrace counts. By default it serves at full model width (``dim=400``) on
the synthetic graph with the dataset's Table 4 shape, on the GPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --model betae \\
        --dataset FB15k --requests 256

``--semantic-store DIR`` serves out-of-core (§4.4): H_sem stays in the
sharded store at DIR (built there first with the stub PTE if DIR holds no
store), anchors stage into a bounded device hot set
(``--semantic-budget-rows``) on the batcher thread, and all-entity scoring
streams the store in chunks through the ``gather_fuse`` kernel:

    PYTHONPATH=src python -m repro_torch.launch.serve --model gqe \
        --semantic-store /path/to/store

``serve_batch`` is the one-shot OFFLINE baseline the engine is verified
against: it shares the engine's encode closures and cached scorer, so the two
paths produce identical results on identical micro-batch compositions.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import PooledExecutor
from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, make_model, model_names
from repro_torch.serving import (ServingConfig, ServingEngine, make_workload,
                                 run_closed_loop, scorer_for, topk_desc)

__all__ = ["serve_batch", "topk_desc", "main"]  # topk_desc re-exported


def serve_batch(model, params, executor, queries, top_k: int = 10,
                device=None, score_all_fn=None, sem_cache=None):
    """One-shot synchronous batch serving on ``device`` (``cuda`` unless
    given) — the offline baseline the engine is verified against. Encoding
    goes through the executor's per-signature closures and scoring through
    the model's cached scorer (``scorer_for``) or ``score_all_fn``. With a
    ``sem_cache`` the anchors stage into the hot set first, which needs a
    chunked ``score_all_fn``. Returns ``(results, params)``."""
    device = resolve_device(device)
    if executor.device != device:
        raise ValueError(f"executor runs on {executor.device}, not {device}")
    if sem_cache is not None:
        if score_all_fn is None:
            # Hot-set params cannot dense-score (score_all refuses the
            # bounded buffer); fail before doing any staging work.
            raise ValueError(
                "serve_batch with sem_cache needs score_all_fn (e.g. "
                "lambda p, q: model.score_all_chunked(p, q, store.read_rows))")
        stage = sem_cache.plan(np.concatenate([q.anchors for q in queries]))
        if stage is not None:
            params = sem_cache.apply_to(params, stage)
    states = executor.encode(params, queries)
    scores = (score_all_fn or scorer_for(model))(params, states)
    if isinstance(scores, torch.Tensor):
        scores = scores.cpu().numpy()
    idx = topk_desc(scores, top_k)
    return [
        {"pattern": q.pattern,
         "anchors": q.anchors.tolist(),
         "relations": q.relations.tolist(),
         "top_entities": idx[i].tolist(),
         "scores": scores[i, idx[i]].round(3).tolist()}
        for i, q in enumerate(queries)
    ], params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="FB15k")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the small CPU stand-in graph instead of the "
                         "dataset's Table 4 shape")
    ap.add_argument("--model", default="betae", choices=model_names())
    ap.add_argument("--dim", type=int, default=ModelConfig.dim)
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: cuda; no fallback)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the graph and the random weights")
    ap.add_argument("--requests", type=int, default=256,
                    help="total requests in the generated workload")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--concurrency", type=int, default=32,
                    help="closed-loop in-flight window")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="engine micro-batch size-flush threshold")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="engine age-flush: max wait of the oldest pending "
                         "request before a partial batch dispatches")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="bounded admission queue (backpressure limit)")
    ap.add_argument("--no-cse", action="store_true",
                    help="ablation: disable cross-query subexpression "
                         "sharing in the plan compiler")
    ap.add_argument("--semantic-store", default=None, metavar="DIR",
                    help="serve out-of-core: H_sem stays in the store at DIR "
                         "(built there with the stub PTE if DIR holds none); "
                         "the device holds only the hot-set cache")
    ap.add_argument("--semantic-budget-rows", type=int, default=2048)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    kg, _, _ = load_dataset(args.dataset, reduced=args.reduced, seed=args.seed)
    print(f"graph: {kg.name} {kg.n_entities} entities, {kg.n_relations} "
          f"relations, {len(kg)} training triples; device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    store, cache = None, None
    if args.semantic_store:
        from repro_torch.semantic import (SemanticCache, SemanticStore,
                                          StubPTE,
                                          precompute_semantic_table_to_store)

        if os.path.isfile(os.path.join(args.semantic_store, "meta.json")):
            store = SemanticStore(args.semantic_store)
        else:
            t0 = time.time()
            store = precompute_semantic_table_to_store(
                kg, args.semantic_store, StubPTE(device=device))
            print(f"semantic store: built in {time.time() - t0:.1f}s")
        if store.n_rows != kg.n_entities:
            raise ValueError(f"the store at {args.semantic_store} holds "
                             f"{store.n_rows} rows, the graph "
                             f"{kg.n_entities} entities")
        cache = SemanticCache(store, budget_rows=min(args.semantic_budget_rows,
                                                     kg.n_entities),
                              device=device)
        print(f"semantic store: {store.n_rows}x{store.dim} {store.quant}, "
              f"{cache.device_resident_sem_bytes/1e6:.2f} MB device-resident")
    model = make_model(args.model, ModelConfig(
        dim=args.dim, semantic_dim=store.dim if store else 0), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, kg.n_entities, kg.n_relations,
                               semantic_cache=cache)
    executor = PooledExecutor(model, b_max=256, cse=not args.no_cse,
                              device=device)
    cfg = ServingConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        queue_depth=args.queue_depth, top_k=args.top_k)
    with ServingEngine(model, params, executor=executor, cfg=cfg,
                       device=device, sem_cache=cache,
                       sem_rows_fn=store.read_rows if store else None) as engine:
        workload = make_workload(kg, args.requests, seed=7)
        # Warmup pass builds every signature the replay will form; the timed
        # pass then reports steady-state numbers (and its retrace count).
        t0 = time.time()
        run_closed_loop(engine, workload, concurrency=args.max_batch)
        print(f"warmup: {args.requests} requests in {time.time()-t0:.1f}s "
              f"({engine.retraces()} cold cache misses)")
        engine.reset_counters()
        report = run_closed_loop(engine, workload,
                                 concurrency=args.concurrency)
        st = engine.stats()
        print(report.describe())
        print(f"engine: {st['batches']} micro-batches "
              f"(mean size {st['mean_batch_size']:.1f}, flushes "
              f"{st['flushes']}, padded rows {st['padded_row_frac']:.1%}), "
              f"{st['retraces']} steady-state retraces")
        sh = st["sharing"]
        print(f"plan compiler: CSE {'off' if args.no_cse else 'on'} — "
              f"{sh['pooled_rows_saved']} pooled rows saved "
              f"({sh['saved_frac']:.1%}), "
              f"{st['coalesced']} duplicate requests coalesced")
        print(f"first: {json.dumps(report.results[0])[:140]}...")
        if cache is not None:
            cs = cache.stats()
            print(f"semantic cache: hit rate {cs['hit_rate']:.2%}, "
                  f"{cs['rows_staged']} rows staged from store")


if __name__ == "__main__":
    main()
