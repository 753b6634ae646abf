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

The serving tier's options, as the JAX package's launcher has them:

* ``--materialize N`` — a materialized-subquery cache of N rows;
* ``--max-staleness V`` — attach the live graph and admit version-pinned
  requests up to V versions behind;
* ``--live-writes N`` — N write bursts through ``LiveNGDB`` during the timed
  replay (graph commit + background incremental fine-tune);
* ``--replicas N`` / ``--tenants`` / ``--priority-mix`` — N engines behind a
  rendezvous-affinity ``Router`` with per-tenant priority admission;
* ``--qps`` (open loop), ``--client-threads`` and ``--latency-window``.

    PYTHONPATH=src python -m repro_torch.launch.serve --model gqe \
        --materialize 2048 --live-writes 8 --max-staleness 4
    PYTHONPATH=src python -m repro_torch.launch.serve --model gqe \
        --replicas 2 --tenants gold:high,bronze:low --priority-mix gold=0.25,bronze=0.75

``--trace PATH`` writes a Chrome-trace-event (Perfetto) timeline of the timed
replay, and ``--metrics PATH`` a final registry snapshot as JSONL; read both
with ``python -m repro_torch.obs.report``. Unlike the JAX package's launcher,
which traces the single-engine path only, the replica tier traces its timed
pass too (the tenants' lanes, each replica's batcher, ``route`` spans).
``--autotune-cache`` comes with slice 7 and ``--mesh`` with slice 9.

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
from repro_torch.obs import TRACER, MetricsSink, get_registry
from repro_torch.serving import (ServingConfig, ServingEngine, make_workload,
                                 run_closed_loop, run_open_loop, scorer_for,
                                 topk_desc)

__all__ = ["serve_batch", "topk_desc", "main"]  # topk_desc re-exported


def serve_batch(model, params, executor, queries, top_k: int = 10,
                device=None, score_all_fn=None, sem_cache=None,
                n_entities=None):
    """One-shot synchronous batch serving on ``device`` (``cuda`` unless
    given) — the offline baseline the engine is verified against. Encoding
    goes through the executor's per-signature closures and scoring through
    the model's cached scorer (``scorer_for``) or ``score_all_fn``. With a
    ``sem_cache`` the anchors stage into the hot set first, which needs a
    chunked ``score_all_fn``. ``n_entities`` overrides the model's entity
    count for the score mask (a retained version's count, from
    ``ServingEngine.params_at``). Returns ``(results, params)``."""
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
    if score_all_fn is None:
        scores = scorer_for(model)(params, states, n_entities)
    else:
        scores = score_all_fn(params, states)
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


def _parse_tenants(tenants_spec, mix_spec):
    """``--tenants "gold:high,bronze:low[:quota]"`` and
    ``--priority-mix "gold=0.25,bronze=0.75"`` -> (specs, weights).
    With no ``--tenants``, everything rides the router's default tenant."""
    from repro_torch.serving import TenantSpec

    if not tenants_spec:
        return [], {}
    specs = []
    for part in tenants_spec.split(","):
        bits = part.strip().split(":")
        if len(bits) not in (2, 3):
            raise ValueError(f"tenant spec {part!r}: want name:priority"
                             f"[:max_inflight]")
        quota = int(bits[2]) if len(bits) == 3 else 0
        specs.append(TenantSpec(bits[0], bits[1], quota))
    weights = {s.name: 1.0 for s in specs}
    if mix_spec:
        weights = {}
        for part in mix_spec.split(","):
            name, w = part.split("=")
            weights[name.strip()] = float(w)
        unknown = set(weights) - {s.name for s in specs}
        if unknown:
            raise ValueError(f"--priority-mix names unknown tenants "
                             f"{sorted(unknown)}")
    total = sum(weights.values())
    return specs, {n: w / total for n, w in weights.items()}


def _serve_tier(args, kg, model, params, device) -> None:
    """Multi-replica serving tier: rendezvous plan-cache-affinity routing
    over ``--replicas`` engines with per-tenant priority admission and typed
    low-priority sheds."""
    from repro_torch.serving import (ReplicaPool, Router, TenantLoad,
                                     run_tenant_mix)

    specs, weights = _parse_tenants(args.tenants, args.priority_mix)
    cfg = ServingConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        queue_depth=args.queue_depth, top_k=args.top_k,
                        latency_window=args.latency_window)
    pool = ReplicaPool(model, params, n_replicas=args.replicas, cfg=cfg,
                       mat_budget_rows=args.materialize, device=device)
    router = Router(pool, tenants=specs)
    workload = make_workload(kg, args.requests, seed=7)
    # Warmup builds every signature each home replica will see (placement
    # is deterministic, so the timed pass replays onto warm caches).
    t0 = time.time()
    for f in router.submit_many(workload):
        f.result(timeout=120.0)
    print(f"warmup: {args.requests} requests over {args.replicas} replicas "
          f"in {time.time()-t0:.1f}s")
    pool.reset_counters()
    if args.trace:
        TRACER.enable()
        TRACER.set_lane("loadgen main")
    if specs:
        loads = []
        start = 0
        for s in specs:  # contiguous weighted shares, submission-paced
            n = max(1, int(round(weights[s.name] * len(workload))))
            qs = (workload[start:start + n]
                  or workload[: max(1, len(workload) // len(specs))])
            start += len(qs)
            loads.append(TenantLoad(s.name, qs, qps=args.qps * weights[s.name]))
        reports = run_tenant_mix(router, loads)
        for name in sorted(reports):
            print(reports[name].describe())
    else:
        print(run_open_loop(router, workload, qps=args.qps).describe())
    if args.trace:
        _write_trace(args.trace)
    st = router.stats()
    for rid, rs in sorted(st["pool"]["per_replica"].items()):
        mc = rs.get("mat_cache")
        mat = f", mat hit rate {mc['hit_rate']:.2%}" if mc else ""
        print(f"replica {rid}: {rs['submitted']} requests, "
              f"{rs['batches']} micro-batches, "
              f"{rs['retraces']} steady-state retraces{mat}")
    print(f"router: {st['routed']} routed, {st['spilled']} spilled, "
          f"{st['shed']} shed")
    for name, ts in sorted(st["tenants"].items()):
        if ts["submitted"] or any(ts["shed"].values()):
            sheds = {r: c for r, c in ts["shed"].items() if c}
            print(f"tenant {name} ({ts['priority']}): "
                  f"{ts['completed']}/{ts['submitted']} completed, "
                  f"shed {sheds or 0}, p99 {ts['latency_ms']['p99']:.1f} ms")
    if args.metrics:
        _write_metrics(args.metrics)
    router.close()


def _write_trace(path: str) -> None:
    TRACER.write(path)
    TRACER.disable()
    print(f"trace: wrote {path} (load at ui.perfetto.dev)")


def _write_metrics(path: str) -> None:
    with MetricsSink(path) as sink:
        sink.write({"kind": "snapshot", "metrics": get_registry().snapshot()})
    print(f"metrics: wrote {path}")


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
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop arrival rate; 0 = closed loop at "
                         "--concurrency in-flight requests")
    ap.add_argument("--concurrency", type=int, default=32,
                    help="closed-loop in-flight window (ignored with --qps)")
    ap.add_argument("--client-threads", type=int, default=1,
                    help="closed-loop client submitter threads (ignored "
                         "with --qps)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="engine micro-batch size-flush threshold")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="engine age-flush: max wait of the oldest pending "
                         "request before a partial batch dispatches")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="bounded admission queue (backpressure limit)")
    ap.add_argument("--latency-window", type=int,
                    default=ServingConfig.latency_window,
                    help="latency percentile window size (requests)")
    ap.add_argument("--materialize", type=int, default=0, metavar="N",
                    help="materialized-subquery cache: keep up to N encoded "
                         "rows keyed by query, consulted by the batcher "
                         "before padding (version-stamped — invalidated on "
                         "param updates and KG writes; 0 = off)")
    ap.add_argument("--no-cse", action="store_true",
                    help="ablation: disable cross-query subexpression "
                         "sharing in the plan compiler")
    ap.add_argument("--semantic-store", default=None, metavar="DIR",
                    help="serve out-of-core: H_sem stays in the store at DIR "
                         "(built there with the stub PTE if DIR holds none); "
                         "the device holds only the hot-set cache")
    ap.add_argument("--semantic-budget-rows", type=int, default=2048)
    ap.add_argument("--max-staleness", type=int, default=0, metavar="V",
                    help="staleness-bounded serving: attach the live graph "
                         "and admit version-pinned requests up to V graph "
                         "versions behind; out-of-bound pins are shed with "
                         "StaleVersionError")
    ap.add_argument("--live-writes", type=int, default=0, metavar="N",
                    help="fire N live write bursts through LiveNGDB during "
                         "the timed replay (graph commit + background "
                         "incremental fine-tune)")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="multi-replica serving tier: N engines with private "
                         "plan/materialized caches behind a rendezvous-"
                         "affinity router; 1 = the single-engine path")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="router tenants as name:priority[:max_inflight],"
                         "... e.g. 'gold:high,bronze:low' — low priority is "
                         "shed (typed, never blocking) under backpressure")
    ap.add_argument("--priority-mix", default=None, metavar="SPEC",
                    help="traffic share per tenant, e.g. "
                         "'gold=0.25,bronze=0.75' (default: equal shares); "
                         "needs --tenants")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace-event/Perfetto JSON timeline "
                         "of the timed replay (lanes: client N or tenant T, "
                         "each engine's batcher; spans: request/route/batch/"
                         "sem_prefetch/store_io/encode/score/select). Load at "
                         "ui.perfetto.dev")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a final registry snapshot (engine counters, "
                         "latency histogram, cache stats) as JSONL; "
                         "summarize with python -m repro_torch.obs.report")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.priority_mix and not args.tenants:
        ap.error("--priority-mix needs --tenants")
    tier = args.replicas > 1 or args.tenants
    live = args.live_writes > 0 or args.max_staleness > 0
    if tier and (args.semantic_store or live):
        ap.error("--replicas/--tenants do not compose with --semantic-store/"
                 "--live-writes/--max-staleness (single-engine features)")
    if tier and args.no_cse:
        ap.error("--no-cse is a single-engine ablation")
    if live and args.semantic_store:
        ap.error("--live-writes/--max-staleness do not compose with "
                 "--semantic-store (the device hot set is incompatible with "
                 "version-pinned replay)")

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
    if tier:
        _serve_tier(args, kg, model, params, device)
        return
    executor = PooledExecutor(model, b_max=256, cse=not args.no_cse,
                              device=device)
    mat_cache = None
    if args.materialize > 0:
        from repro_torch.core import MaterializedSubqueryCache

        mat_cache = MaterializedSubqueryCache(args.materialize)
        mat_cache.watch_kg(kg)
        print(f"materialized cache: {args.materialize} rows "
              f"(invalidated on param update / KG write)")
    cfg = ServingConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        queue_depth=args.queue_depth, top_k=args.top_k,
                        latency_window=args.latency_window,
                        max_staleness_versions=args.max_staleness)
    engine = ServingEngine(model, params, executor=executor, cfg=cfg,
                           device=device, sem_cache=cache,
                           sem_rows_fn=store.read_rows if store else None,
                           mat_cache=mat_cache, kg=kg if live else None)
    workload = make_workload(kg, args.requests, seed=7)
    # Warmup pass builds every signature the replay will form; the timed
    # pass then reports steady-state numbers (and its retrace count).
    t0 = time.time()
    run_closed_loop(engine, workload, concurrency=args.max_batch)
    print(f"warmup: {args.requests} requests in {time.time()-t0:.1f}s "
          f"({engine.retraces()} cold cache misses)")
    engine.reset_counters()
    # Trace only the timed replay (the batcher named its lane at start, and
    # lane names survive enable()).
    if args.trace:
        TRACER.enable()
        TRACER.set_lane("loadgen main")
    writer, live_db = None, None
    if args.live_writes > 0:
        import threading

        from repro_torch.serving import LiveNGDB

        live_db = LiveNGDB(model, kg, engine, finetune_steps=2)
        wrng = np.random.default_rng(23)

        def _write_bursts():
            for _ in range(args.live_writes):
                cand = np.stack([wrng.integers(0, kg.n_entities, 16),
                                 wrng.integers(0, kg.n_relations, 16),
                                 wrng.integers(0, kg.n_entities, 16)], axis=1)
                live_db.write(cand[~kg.contains(cand)][:4])
                time.sleep(0.01)

        writer = threading.Thread(target=_write_bursts, name="live-writer")
        writer.start()
    if args.qps > 0:
        report = run_open_loop(engine, workload, qps=args.qps)
    else:
        report = run_closed_loop(engine, workload,
                                 concurrency=args.concurrency,
                                 threads=args.client_threads)
    if writer is not None:
        writer.join()
        live_db.flush()
    if args.trace:
        _write_trace(args.trace)
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
    mc = st.get("mat_cache")
    if mc is not None:
        print(f"materialized rows: hit rate {mc['hit_rate']:.2%} "
              f"({mc['hits']} hits / {mc['misses']} misses), "
              f"{mc['live']} live, {mc['evictions']} evictions")
    if live:
        lag = st.get("version_lag_served", {})
        print(f"live graph: version {st['graph_version']} "
              f"(retained {st['retained_versions']}), "
              f"{st['stale_sheds']} stale sheds, "
              f"lag histogram {dict(sorted(lag.items()))}")
    if live_db is not None:
        n_fresh = sum(r.n_written for r in live_db.receipts)
        print(f"live writes: {len(live_db.receipts)} bursts, "
              f"{n_fresh} fresh triples, "
              f"{live_db.finetunes_done} background fine-tunes")
        live_db.close()
    print(f"first: {json.dumps(report.results[0])[:140]}...")
    if cache is not None:
        cs = cache.stats()
        print(f"semantic cache: hit rate {cs['hit_rate']:.2%}, "
              f"{cs['rows_staged']} rows staged from store")
    if args.metrics:
        _write_metrics(args.metrics)
    engine.close()


if __name__ == "__main__":
    main()
