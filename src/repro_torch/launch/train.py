"""NGDB-Zoo training CLI on the GPU.

Runs the full loop — online sampling, operator-level scheduling, pooled
execution under autograd, vectorized loss, Adam — with checkpoint/auto-resume
and optional semantic augmentation and adaptive sampling, then evaluates
filtered MRR. By default it trains on the synthetic graph with the dataset's
Table 4 shape, on ``cuda`` (no fallback: ``--device cpu`` asks for the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --dataset FB15k \\
        --model betae --steps 200 --batch-size 128 --dim 64 --ckpt-dir ckpt

``--semantic-store DIR`` keeps H_sem on disk (a sharded store, built at DIR
with the stub PTE on first use and reused after) with a bounded hot set on
the device, staged on the scheduler thread with ``--pipeline``:

    PYTHONPATH=src python -m repro_torch.launch.train --model gqe \\
        --semantic-store sem --semantic-budget-rows 2048 --pipeline

``--trace PATH`` writes a Chrome-trace-event (Perfetto) timeline of the run
and ``--metrics PATH`` one JSONL record a step plus a final registry
snapshot; read both with ``python -m repro_torch.obs.report``.

The options are the JAX package's launcher's, with ``--device`` and
``--reduced`` (the small CPU stand-in graph, which is the JAX package's only
graph) added. ``--mesh``/``--profile`` come with slice 9 and
``--autotune``/``--autotune-cache`` with slice 7; each raises
``NotImplementedError`` here.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, make_model, model_names
from repro_torch.obs import TRACER, get_registry
from repro_torch.sampling import OnlineSampler
from repro_torch.semantic import (PTEConfig, SemanticCache, SemanticStore,
                                  SemanticStoreError, StubPTE,
                                  precompute_semantic_table,
                                  precompute_semantic_table_to_store)
from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig, evaluate


def open_or_build_store(directory: str, kg, d_l: int, quant: str, device,
                        shard_rows: int = 65536) -> SemanticStore:
    """Reuse a complete store if one is already on disk (matching shape and
    quant layout); otherwise stream the offline precompute into it."""
    try:
        store = SemanticStore(directory)
        if (store.n_rows, store.dim, store.quant) == (kg.n_entities, d_l, quant):
            print(f"semantic store: reusing {directory} "
                  f"({store.n_rows}x{store.dim} {store.quant}, "
                  f"{store.disk_nbytes/1e6:.1f} MB on disk)")
            return store
        print("semantic store: shape/quant mismatch — rebuilding")
    except SemanticStoreError as e:
        print(f"semantic store: {e}")
    t0 = time.time()
    pte = StubPTE(PTEConfig(d_l=d_l, n_layers=2, d_model=128), device=device)
    store = precompute_semantic_table_to_store(
        kg, directory, pte, quant=quant, shard_rows=shard_rows)
    print(f"semantic store: built {store.n_rows}x{store.dim} {quant} at "
          f"{directory} in {time.time()-t0:.1f}s "
          f"({store.disk_nbytes/1e6:.1f} MB, PTE unloaded)")
    return store


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--dataset", default="FB15k")
    ap.add_argument("--reduced", action="store_true",
                    help="train on the small CPU stand-in graph instead of the "
                         "dataset's Table 4 shape")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: cuda; no fallback)")
    ap.add_argument("--model", default="betae", choices=model_names())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--negatives", type=int, default=32)
    ap.add_argument("--semantic", action="store_true")
    ap.add_argument("--semantic-dim", type=int, default=256)
    ap.add_argument("--semantic-store", default=None, metavar="DIR",
                    help="out-of-core H_sem: sharded store on disk + a "
                         "bounded device-resident hot-set cache (implies "
                         "--semantic); built at DIR on first use")
    ap.add_argument("--semantic-budget-rows", type=int, default=0,
                    help="device hot-set row budget for --semantic-store "
                         "(0 = auto: 4x the per-batch working set)")
    ap.add_argument("--semantic-quant", default="fp32", choices=["fp32", "int8"],
                    help="on-disk layout: fp32 is bit-identical to "
                         "full-resident training; int8 is 4x smaller with "
                         "per-row scales")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--executor", default="pooled", choices=["pooled", "query_level"])
    ap.add_argument("--no-cse", action="store_true",
                    help="ablation: disable the plan compiler's cross-query "
                         "subexpression sharing")
    ap.add_argument("--materialized-rows", type=int, default=0,
                    help="attach a MaterializedSubqueryCache of N encoded "
                         "rows to the pooled executor's eval/encode path "
                         "(version-stamped: invalidated on every param "
                         "update and KG write; 0 = off)")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined mode: a scheduler thread prepares step "
                         "k+1 (negatives, plan, copies on a side stream) "
                         "while the card runs step k; with --semantic-store "
                         "it also stages the hot set there")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="pipelined dispatch window (2 = double-buffered)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="mesh-shard the run (slice 9; raises here)")
    ap.add_argument("--profile", default=None, choices=["2d", "fsdp"],
                    help="sharding profile for --mesh (slice 9; raises here)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--live-writes", type=int, default=0, metavar="N",
                    help="after training, commit N fresh triple bursts into "
                         "the graph and incrementally fine-tune the written "
                         "neighbourhoods from the trained params")
    ap.add_argument("--eval-queries", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event/Perfetto JSON timeline "
                         "of the run (lanes: main dispatch, pipeline "
                         "scheduler, sampling workers; spans: sample/schedule"
                         "/transfer/sem_prefetch/store_io/pipeline_wait/"
                         "sem_apply/dispatch/retire). Load at ui.perfetto.dev")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write per-step phase durations + bubble fraction "
                         "as JSONL, with a final registry snapshot record; "
                         "summarize with python -m repro_torch.obs.report")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="persisted kernel-tile autotune cache (slice 7; "
                         "raises here)")
    ap.add_argument("--autotune", action="store_true",
                    help="run the tile sweep before training (slice 7; "
                         "raises here)")
    args = ap.parse_args(argv)
    if args.mesh is not None or args.profile is not None:
        raise NotImplementedError("--mesh/--profile are not ported yet: they come "
                                  "with slice 9 (distribution)")
    if args.autotune or args.autotune_cache is not None:
        raise NotImplementedError("--autotune/--autotune-cache are not ported yet: "
                                  "they come with slice 7 (autotuning)")
    if args.semantic_store:
        args.semantic = True
    device = resolve_device(args.device)
    if args.trace:
        TRACER.enable()
        TRACER.set_lane("main dispatch")

    kg, full_kg, _ = load_dataset(args.dataset, reduced=args.reduced)
    print(f"dataset={args.dataset} ({'reduced stand-in' if args.reduced else 'Table 4 shape'}): "
          f"{kg.n_entities} entities, {kg.n_relations} relations, {len(kg)} train "
          f"triples; device {device}")

    table, store, cache = None, None, None
    sem_dim = 0
    if args.semantic_store:
        sem_dim = args.semantic_dim
        store = open_or_build_store(args.semantic_store, kg, sem_dim,
                                    args.semantic_quant, device)
        # Working set of one step: anchors (<=3/query) + positive + negatives.
        per_batch = args.batch_size * (4 + args.negatives)
        budget = args.semantic_budget_rows or min(kg.n_entities, 4 * per_batch)
        budget = max(budget, min(kg.n_entities, per_batch))
        cache = SemanticCache(store, budget_rows=budget, device=device)
        print(f"semantic cache: {budget} device rows "
              f"({cache.device_resident_sem_bytes/1e6:.2f} MB device-resident "
              f"vs {kg.n_entities * sem_dim * 4/1e6:.2f} MB full-resident)")
    elif args.semantic:
        t0 = time.time()
        pte = StubPTE(PTEConfig(d_l=args.semantic_dim, n_layers=2, d_model=128),
                      device=device)
        table = precompute_semantic_table(kg, pte)
        sem_dim = args.semantic_dim
        print(f"semantic precompute: {table.shape} in {time.time()-t0:.1f}s; "
              f"PTE unloaded")

    model = make_model(args.model, ModelConfig(dim=args.dim, gamma=12.0,
                                               semantic_dim=sem_dim),
                       device=device)
    cfg = TrainConfig(
        batch_size=args.batch_size, n_negatives=args.negatives,
        adam=AdamConfig(lr=args.lr), adaptive=args.adaptive,
        executor=args.executor, checkpoint_dir=args.ckpt_dir,
        pipeline=args.pipeline, max_inflight=args.max_inflight,
        cse=not args.no_cse, materialized_rows=args.materialized_rows,
        metrics_path=args.metrics,
    )
    trainer = NGDBTrainer(model, kg, cfg, semantic_table=table,
                          semantic_cache=cache)
    if trainer.resume():
        print(f"resumed from checkpoint at step {trainer.step}")

    t0 = time.time()
    trainer.train(args.steps, log_every=args.log_every)
    dt = time.time() - t0
    if args.metrics and trainer.metrics_sink.enabled:
        trainer.metrics_sink.write({"kind": "snapshot",
                                    "metrics": get_registry().snapshot()})
        trainer.metrics_sink.close()
    if args.trace:
        TRACER.write(args.trace)
        TRACER.disable()
        print(f"trace: wrote {args.trace} (load at ui.perfetto.dev)")
    qps = args.steps * args.batch_size / dt
    # Pipelined mode needs the pooled executor; train() runs the sync loop
    # otherwise — report what actually ran.
    mode = "pipelined" if (args.pipeline and args.executor == "pooled") else "sync"
    if args.pipeline and mode == "sync":
        print("note: --pipeline requires --executor pooled; ran the sync path")
    print(f"trained {args.steps} steps [{mode}] in {dt:.1f}s ({qps:.0f} queries/sec)")
    cs = trainer.executor.cache_stats()
    print("executor caches: " + ", ".join(
        f"{name} {c['size']} entries, hit rate {c['hit_rate']:.2%} "
        f"({c['misses']} misses)" for name, c in cs.items()))
    sh = trainer.executor.sharing_stats()
    # Report the executor's ACTUAL mode: the query-level baseline pins CSE
    # off whatever the flag says.
    cse_on = getattr(trainer.executor, "cse", False)
    print(f"plan compiler: CSE {'on' if cse_on else 'off'}"
          f"{' (query-level baseline)' if args.executor != 'pooled' else ''}"
          f" — {sh['pooled_rows_saved']} pooled rows saved "
          f"({sh['saved_frac']:.1%} of {sh['nodes_before']})")
    pc = sh.get("plan_cache")
    if pc is not None:
        print(f"plan cache: {pc['size']} canonical plans, "
              f"hit rate {pc['hit_rate']:.2%} "
              f"({pc['canonicalize_calls']} canonicalizations, "
              f"{pc['misses']} rebuilds)")
    mc = sh.get("materialized")
    if mc is not None:
        print(f"materialized rows: hit rate {mc['hit_rate']:.2%}, "
              f"{mc['live']} live rows, {mc['invalidations']} invalidations "
              f"({mc['stale_drops']} stale inserts dropped)")
    if cache is not None:
        cs = cache.stats()
        print(f"semantic cache: hit rate {cs['hit_rate']:.2%}, "
              f"{cs['evictions']} evictions, "
              f"{cs['device_resident_sem_bytes']/1e6:.2f} MB device-resident, "
              f"prefetch overlap {cs['prefetch_overlap_frac']:.2%} "
              f"({cs['sync_stages']} synchronous mid-step reads)")

    if args.live_writes > 0:
        if cache is not None:
            print("live-write smoke skipped: hot-set (sem_cache) params do "
                  "not support live maintenance")
        else:
            from repro_torch.training import incremental_finetune

            wrng = np.random.default_rng(29)
            v0 = kg.graph_version
            for i in range(args.live_writes):
                cand = np.stack([wrng.integers(0, kg.n_entities, 16),
                                 wrng.integers(0, kg.n_relations, 16),
                                 wrng.integers(0, kg.n_entities, 16)], axis=1)
                fresh = kg.insert_triples(cand[~kg.contains(cand)][:4])
                if not len(fresh):
                    continue
                trainer.params, losses = incremental_finetune(
                    model, trainer.params, fresh, lr=args.lr,
                    seed=kg.graph_version, executor=trainer.executor)
                print(f"live write {i}: v{kg.graph_version} "
                      f"{len(fresh)} fresh triples, fine-tune loss "
                      f"{losses[0]:.4f} -> {losses[-1]:.4f}")
            print(f"live-write smoke: graph version {v0} -> "
                  f"{kg.graph_version}, {len(kg)} triples")

    eval_qs = [b.query for b in OnlineSampler(kg, seed=123).sample_batch(args.eval_queries)]
    score_all_fn = None
    if cache is not None:
        # Encoding eval queries gathers their anchors through the cache;
        # stage them once up front. Scoring streams H_sem from the store.
        anchors = np.unique(np.concatenate([q.anchors for q in eval_qs]))
        try:
            stage = cache.plan(anchors)
        except RuntimeError as e:
            print(f"eval skipped: {e}")
            return
        if stage is not None:
            trainer.params = cache.apply_to(trainer.params, stage)
        score_all_fn = lambda p, q: model.score_all_chunked(p, q, store.read_rows)  # noqa: E731
    metrics = evaluate(model, trainer.params, trainer.executor, full_kg,
                       eval_qs, train_kg=kg, score_all_fn=score_all_fn)
    print("eval:", json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
