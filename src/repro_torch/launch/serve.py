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
``--autotune-cache PATH`` loads the kernel launch geometries a training
run's ``--autotune`` kept there into the process tuner before any executor
exists, so every executor pads its pools to them and every launch takes
them; serving tunes nothing.

``--mesh data=N[,model=M]`` (with ``--profile 2d|fsdp``) serves under a
mesh of one process a device, launched with ``torchrun --nproc-per-node N``
(NCCL on the card, gloo with ``--device cpu``):

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh data=2 \
        --profile fsdp --model gqe

Every rank holds its shard of each table (entity rows padded to a multiple
of the mesh size); rank 0 admits the requests, forms the micro-batches and
prints, the other ranks serve the same batches (``ServingEngine.follow``).
``--live-writes``/``--max-staleness``/``--materialize`` compose with it:
every rank builds the same ``LiveNGDB`` and materialized cache over its own
copy of the graph, rank 0 runs the writer thread, and each write and
fine-tune lands at one point of the mesh's lane on every rank (the
fine-tune holds it: serving pauses while it runs);
``--trace``/``--metrics`` write one file a rank (``m.rank1.jsonl``); a
follower's trace spans the warmup too, which it cannot tell from the timed
pass.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh data=2 \
        --model gqe --live-writes 2 --max-staleness 2 --materialize 2048

``--ckpt-dir DIR`` serves a trained model: the newest valid checkpoint in
DIR (written by either package's ``launch.train --ckpt-dir``) replaces the
random parameters before any executor, engine, replica or mesh lane
exists, in every layout above; each mesh rank restores its own shard, the
entity rows padded or trimmed to this mesh's padding. Two deviations from
the JAX package's launcher: the frozen semantic buffers (``sem_table``,
``sem_cache``, ``sem_slot``) always come from the serving side's own store
and cache, never from the checkpoint, so a model trained through one
hot-set budget serves through another (the reference restores the
checkpoint's buffer over the cache's); and a DIR that holds no valid
checkpoint exits non-zero instead of serving random weights.

    python -m repro_torch.launch.train --model betae --ckpt-dir ck --steps 200
    python -m repro_torch.launch.serve --model betae --ckpt-dir ck

``--answers PATH`` writes every micro-batch of the timed pass (rank 0's
under a mesh, every replica's in the tier) as JSON lines: the padded
composition as executed and one result a real row. ``read_answers`` gives
them back as ``BatchRecord``s for ``check_against_offline``.

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
import torch.distributed as dist

from repro_torch.core import PooledExecutor, QueryInstance
from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.distributed import (ExecutionContext, init_process_group_from_env,
                                     make_execution_context)
from repro_torch.models import ModelConfig, make_model, model_names
from repro_torch.obs import TRACER, MetricsSink, get_registry
from repro_torch.serving import (ServingConfig, ServingEngine, make_workload,
                                 run_closed_loop, run_open_loop, scorer_for,
                                 topk_desc)
from repro_torch.serving.engine import BatchRecord
from repro_torch.training.checkpoint import load_checkpoint

__all__ = ["serve_batch", "topk_desc", "restore_params", "read_answers",
           "main"]  # topk_desc re-exported


def serve_batch(model, params, executor, queries, top_k: int = 10,
                device=None, score_all_fn=None, sem_cache=None,
                n_entities=None, ctx=None, sem_rows_fn=None):
    """One-shot synchronous batch serving on ``device`` (``cuda`` unless
    given) — the offline baseline the engine is verified against. Encoding
    goes through the executor's per-signature closures and scoring through
    the model's cached scorer (``scorer_for``) or ``score_all_fn``. With a
    ``sem_cache`` the anchors stage into the hot set first, which needs a
    chunked scorer: ``sem_rows_fn`` (e.g. ``store.read_rows``, through the
    scorer's ``chunked``, as the engine scores) or ``score_all_fn``.
    ``n_entities`` overrides the model's entity count for the score mask (a
    retained version's count, from ``ServingEngine.params_at``).

    Under a mesh ``ctx`` (``params`` this rank's shards, the device
    ``ctx.device``) the call is collective: every rank calls it with the
    same queries, as the engine's ranks serve rank 0's batches, and every
    rank returns the same results. Returns ``(results, params)``."""
    sharded = ctx is not None and ctx.is_sharded
    device = resolve_device(ctx.device if sharded and device is None else device)
    if executor.device != device:
        raise ValueError(f"executor runs on {executor.device}, not {device}")
    if sharded and score_all_fn is not None:
        raise ValueError("under a mesh the scorer scores each rank's rows; pass "
                         "sem_rows_fn for the chunked path, not score_all_fn")
    if sem_cache is not None:
        if score_all_fn is None and sem_rows_fn is None:
            # Hot-set params cannot dense-score (score_all refuses the
            # bounded buffer); fail before doing any staging work.
            raise ValueError(
                "serve_batch with sem_cache needs sem_rows_fn (e.g. "
                "store.read_rows) or score_all_fn (e.g. lambda p, q: "
                "model.score_all_chunked(p, q, store.read_rows))")
        stage = sem_cache.plan(np.concatenate([q.anchors for q in queries]))
        if stage is not None:
            params = sem_cache.apply_to(params, stage)
    scorer = scorer_for(model, ctx)
    view = enc = params
    if sharded:
        view = scorer.mesh.view(params)
        enc = scorer.mesh.encode_params(view, queries)
    states = executor.encode(enc, queries)
    if score_all_fn is not None:
        scores = score_all_fn(params, states)
    elif sem_rows_fn is not None:
        scores = scorer.chunked(view, states, sem_rows_fn)
    else:
        scores = scorer(view, states, n_entities)
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


def restore_params(directory: str, model, params, ctx=None, sem_cache=None):
    """Copy the trained parameters of the newest valid checkpoint in
    ``directory`` into ``params`` (in place; this rank's shards under a mesh
    ``ctx``, the entity rows padded or trimmed to the model's). The frozen
    semantic buffers are left as they are: they belong to the serving
    side's store and ``sem_cache``, whose residency is reset. Returns the
    checkpoint's step, or None when ``directory`` holds no valid one."""
    frozen = set(model.frozen_param_names())
    trained = {k: v for k, v in params.items() if k not in frozen}
    restored = load_checkpoint(
        directory, template={"params": trained, "opt": None},
        ctx=ctx if ctx is not None and ctx.is_sharded else None,
        shapes={"params": model.full_shapes}, n_entities=model.n_entities)
    if restored is None:
        return None
    step, tree, _ = restored
    with torch.no_grad():
        for k, v in tree["params"].items():
            params[k].copy_(v)
    if sem_cache is not None:
        sem_cache.reset()
    return step


def _write_answers(path: str, batch_logs) -> None:
    """``batch_logs`` ({replica id or None: [BatchRecord]}) as JSON lines."""
    with open(path, "w") as f:
        for rid, log in batch_logs.items():
            for rec in log:
                row = {"queries": [[q.pattern, q.anchors.tolist(), q.relations.tolist()]
                                   for q in rec.queries],
                       "n_real": rec.n_real, "flush": rec.flush, "results": rec.results}
                if rid is not None:
                    row["replica"] = rid
                f.write(json.dumps(row) + "\n")
    print(f"answers: wrote {sum(len(v) for v in batch_logs.values())} micro-batches "
          f"to {path}")


def read_answers(path: str):
    """The micro-batches ``--answers`` wrote, as ``BatchRecord``s."""
    out = []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            qs = [QueryInstance(p, np.asarray(a, dtype=np.int64), np.asarray(r, dtype=np.int64))
                  for p, a, r in row["queries"]]
            out.append(BatchRecord(queries=qs, n_real=row["n_real"], flush=row["flush"],
                                   results=row["results"]))
    return out


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


def _serve_tier(args, kg, model, params, device, ctx) -> None:
    """Multi-replica serving tier: rendezvous plan-cache-affinity routing
    over ``--replicas`` engines with per-tenant priority admission and typed
    low-priority sheds. Under a mesh every rank builds the same replicas;
    rank 0 routes and the others follow its batches."""
    from repro_torch.serving import (ReplicaPool, Router, TenantLoad,
                                     run_tenant_mix)

    specs, weights = _parse_tenants(args.tenants, args.priority_mix)
    cfg = ServingConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        queue_depth=args.queue_depth, top_k=args.top_k,
                        latency_window=args.latency_window,
                        record_batches=bool(args.answers))
    pool = ReplicaPool(model, params, n_replicas=args.replicas, cfg=cfg,
                       mat_budget_rows=args.materialize, device=device, ctx=ctx)
    if ctx.rank != 0:
        _follow_rank(pool, args, ctx)
        return
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
        _write_trace(_rank_path(args.trace, ctx))
    if args.answers:
        _write_answers(args.answers, {rid: rep.engine.batch_log
                                      for rid, rep in sorted(pool.replicas().items())})
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
        _write_metrics(_rank_path(args.metrics, ctx))
    router.close()


def _follow_rank(server, args, ctx) -> None:
    """A rank other than 0 under a mesh: serve rank 0's batches until it
    closes (``server`` an engine or a replica pool), then write this rank's
    trace and metrics. A follower cannot tell the warmup's batches from the
    timed pass's, so its trace spans both."""
    if args.trace:
        TRACER.enable()
        TRACER.set_lane("follower main")
    server.follow()
    server.close()
    if args.trace:
        _write_trace(_rank_path(args.trace, ctx))
    if args.metrics:
        _write_metrics(_rank_path(args.metrics, ctx))


def _rank_path(path, ctx):
    """``path`` with this rank before its suffix under a mesh."""
    if path is None or not ctx.is_sharded:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{ctx.rank}{ext}"


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
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="serve the newest valid checkpoint in DIR (written by "
                         "launch.train --ckpt-dir of either package) instead of "
                         "random weights; exits non-zero if DIR holds none")
    ap.add_argument("--answers", default=None, metavar="PATH",
                    help="write the timed pass's micro-batches (composition and "
                         "results) as JSON lines, for offline replay")
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
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="persisted kernel launch-geometry cache to serve "
                         "with (written by launch.train --autotune)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="serve under a mesh: data=N[,model=M], one process a "
                         "device under torchrun --nproc-per-node N")
    ap.add_argument("--profile", default="2d", choices=["2d", "fsdp"],
                    help="sharding profile for --mesh: 2d = entity rows over "
                         "model, fsdp = over every axis")
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
    ctx, owns_group = ExecutionContext.single_device(), False
    if args.mesh is not None:
        if not dist.is_initialized():
            init_process_group_from_env(args.device)
            owns_group = True
        ctx = make_execution_context(args.mesh, profile=args.profile, device=args.device)
    try:
        _run(args, ctx)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, ctx) -> None:
    tier = args.replicas > 1 or args.tenants
    live = args.live_writes > 0 or args.max_staleness > 0
    device = ctx.device if ctx.is_sharded else resolve_device(args.device)
    rank0 = ctx.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    if ctx.is_sharded:
        say(f"execution context: {ctx.describe()} "
            f"({ctx.n_devices} devices, dp={ctx.dp_size})")
    kg, _, _ = load_dataset(args.dataset, reduced=args.reduced, seed=args.seed)
    say(f"graph: {kg.name} {kg.n_entities} entities, {kg.n_relations} "
        f"relations, {len(kg)} training triples; device {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))
    store, cache = None, None
    if args.semantic_store:
        from repro_torch.semantic import (SemanticCache, SemanticStore,
                                          StubPTE,
                                          precompute_semantic_table_to_store)

        if rank0 and not os.path.isfile(os.path.join(args.semantic_store, "meta.json")):
            t0 = time.time()
            precompute_semantic_table_to_store(kg, args.semantic_store,
                                               StubPTE(device=device))
            say(f"semantic store: built in {time.time() - t0:.1f}s")
        if ctx.is_sharded:
            ctx.mesh.barrier()  # rank 0 has built the store; every rank opens it
        store = SemanticStore(args.semantic_store)
        if store.n_rows != kg.n_entities:
            raise ValueError(f"the store at {args.semantic_store} holds "
                             f"{store.n_rows} rows, the graph "
                             f"{kg.n_entities} entities")
        cache = SemanticCache(store, budget_rows=min(args.semantic_budget_rows,
                                                     kg.n_entities),
                              device=device, ctx=ctx)
        say(f"semantic store: {store.n_rows}x{store.dim} {store.quant}, "
            f"{cache.device_resident_sem_bytes/1e6:.2f} MB device-resident")
    # Entity rows padded to a multiple of the mesh size, so the table splits.
    model = make_model(args.model, ModelConfig(
        dim=args.dim, semantic_dim=store.dim if store else 0,
        entity_pad=max(1, ctx.n_devices)), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, kg.n_entities, kg.n_relations,
                               semantic_cache=cache,
                               ctx=ctx if ctx.is_sharded else None)
    if args.ckpt_dir:
        step = restore_params(args.ckpt_dir, model, params, ctx=ctx, sem_cache=cache)
        if step is None:
            raise SystemExit(f"--ckpt-dir {args.ckpt_dir}: no valid checkpoint there")
        say(f"loaded checkpoint step={step}")
    if ctx.is_sharded:
        shape = model.full_shapes["entity"]
        ent = params["entity"]
        say(f"entity table: {np.prod(shape) * ent.element_size()/1e6:.2f} MB logical, "
            f"{ent.numel() * ent.element_size()/1e6:.2f} MB/device "
            f"({ctx.param_spec('entity', shape)} over {ctx.describe()})")
    if args.autotune_cache:
        # Before any executor exists: each snapshots its kernel-aware tile
        # policy from the process tuner at construction.
        from repro_torch.kernels import autotune as kat

        tuner = kat.KernelTuner(path=args.autotune_cache)
        kat.set_tuner(tuner)
        say(f"autotune: {len(tuner)} tuned configs loaded from {tuner.path}"
            + (f" (rejected: {tuner.load_error})" if tuner.load_error else ""))
    if tier:
        _serve_tier(args, kg, model, params, device, ctx)
        return
    executor = PooledExecutor(model, b_max=256, cse=not args.no_cse,
                              device=device, ctx=ctx)
    mat_cache = None
    if args.materialize > 0:
        from repro_torch.core import MaterializedSubqueryCache

        mat_cache = MaterializedSubqueryCache(args.materialize)
        mat_cache.watch_kg(kg)
        say(f"materialized cache: {args.materialize} rows "
              f"(invalidated on param update / KG write)")
    cfg = ServingConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        queue_depth=args.queue_depth, top_k=args.top_k,
                        latency_window=args.latency_window,
                        max_staleness_versions=args.max_staleness,
                        record_batches=bool(args.answers))
    engine = ServingEngine(model, params, executor=executor, cfg=cfg,
                           device=device, sem_cache=cache,
                           sem_rows_fn=store.read_rows if store else None,
                           mat_cache=mat_cache, kg=kg if live else None, ctx=ctx)
    live_db = None
    if args.live_writes > 0:
        from repro_torch.serving import LiveNGDB

        live_db = LiveNGDB(model, kg, engine, finetune_steps=2)
    if not rank0:
        _follow_rank(engine, args, ctx)
        if live_db is not None:
            live_db.close()
        return
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
    writer = None
    if live_db is not None:
        import threading

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
        _write_trace(_rank_path(args.trace, ctx))
    if args.answers:
        _write_answers(args.answers, {None: engine.batch_log})
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
        if ctx.is_sharded:
            hold = {k: f"{1e3 * float(np.median(v)):.2f}"
                    for k, v in engine._lane.hold_s.items() if v}
            print(f"mesh lane: median hold ms {hold} (fine-tune ms a burst "
                  f"{[round(1e3 * t, 1) for t in live_db.finetune_s]})")
        live_db.close()
    print(f"first: {json.dumps(report.results[0])[:140]}...")
    if cache is not None:
        cs = cache.stats()
        print(f"semantic cache: hit rate {cs['hit_rate']:.2%}, "
              f"{cs['rows_staged']} rows staged from store")
    if args.metrics:
        _write_metrics(_rank_path(args.metrics, ctx))
    engine.close()


if __name__ == "__main__":
    main()
