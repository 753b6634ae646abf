"""Rank processes for ``test_torch_mesh_serving.py``: gloo ranks on the CPU,
spawned under a file rendezvous. This module imports no JAX (it runs in each
rank); the parent holds the JAX package's results and compares.

Each rank serves the scenarios of its world size and pickles what it saw to
``<dir>/w<world>.r<rank>.pkl``: for every mesh and family the raw [B, E]
scores of two fixed compositions (``serve_batch``'s path), the engine's
batch log and a replay of it through ``serve_batch``, the retraces of a
replayed workload, its entity shard's shape, and, for ``--replicas 2``, each
replica's batch log; on two ranks also a malformed query's outcome."""
import contextlib
import datetime
import io
import json
import os
import pickle

import numpy as np
import torch

E, R, TRIPLES = 2048, 10, 9000        # tests/test_torch_mesh.py's graph
DIM, SEM_DIM, BUDGET, TOP_K = 32, 16, 256, 10
N_REQ, MAX_BATCH = 32, 16
FAMILIES = ("gqe", "betae", "gqe+sem")      # gqe+sem: H_sem through the hot set
# Replicas serve without the hot set; gqe+res: H_sem resident, its table split
# by rows (2d) or cut from the whole (fsdp keeps this small one replicated).
TIER_FAMILIES = ("gqe", "betae", "gqe+res")
MESHES = {1: (("data=1", "fsdp"), ("data=1", "2d")),
          2: (("data=2", "fsdp"), ("data=1,model=2", "2d")),
          4: (("data=4", "fsdp"), ("data=2,model=2", "2d"))}


def graph():
    from repro_torch.data import generate_synthetic_kg

    return generate_synthetic_kg(E, R, TRIPLES, seed=0)


def workload(kg):
    from repro_torch.serving import make_workload

    return make_workload(kg, N_REQ, seed=7)


def compositions(queries):
    """The fixed padded compositions every package serves offline."""
    from repro_torch.serving import pad_to_bucket

    return [pad_to_bucket(queries[i:i + MAX_BATCH])[0]
            for i in range(0, len(queries), MAX_BATCH)]


def h_sem() -> np.ndarray:
    return np.random.default_rng(5).normal(size=(E, SEM_DIM)).astype(np.float32)


def build(family, arrays, ctx, device="cpu"):
    """(model, params, cache) of ``family`` on the carried ``arrays``: this
    rank's shards under a mesh ``ctx``; the hot set is the cache's own
    (empty) buffers."""
    from repro_torch.models import ModelConfig, make_model, params_from_numpy
    from repro_torch.semantic import SemanticCache

    sem = family.endswith("+sem")
    model = make_model(family.split("+")[0], ModelConfig(
        dim=DIM, entity_pad=8, semantic_dim=SEM_DIM if "+" in family else 0), device=device)
    arrays = {k: v for k, v in arrays.items() if k not in ("sem_cache", "sem_slot")}
    cache = None
    if sem:
        cache = SemanticCache(h_sem(), BUDGET, device=device, ctx=ctx)
        arrays.update(sem_cache=cache.buffer.cpu().numpy(),
                      sem_slot=cache.slot_map.cpu().numpy())
    params = params_from_numpy(model, arrays, n_entities=E, ctx=ctx)
    if cache is not None:
        params = model._set_params({**params, "sem_cache": cache.buffer,
                                    "sem_slot": cache.slot_map}, E, model.full_shapes)
    return model, params, cache


def raw_scores(model, params, executor, comp, cache, ctx):
    """``serve_batch``'s scores of one composition, unrounded (collective)."""
    from repro_torch.serving import scorer_for

    if cache is not None:
        stage = cache.plan(np.concatenate([q.anchors for q in comp]))
        if stage is not None:
            cache.apply_to(params, stage)
    scorer = scorer_for(model, ctx)
    view = enc = params
    if ctx is not None:
        view = scorer.mesh.view(params)
        enc = scorer.mesh.encode_params(view, comp)
    states = executor.encode(enc, comp)
    if cache is not None:
        return scorer.chunked(view, states, cache.store.read_rows)
    return scorer(view, states).numpy()


def _replay(model, params, executor, log, cache, ctx):
    from repro_torch.launch.serve import serve_batch

    out = []
    for rec in log:
        res, _ = serve_batch(model, params, executor, rec.queries, top_k=TOP_K,
                             device="cpu", sem_cache=cache, ctx=ctx,
                             sem_rows_fn=cache.store.read_rows if cache else None)
        out.append([{k: r[k] for k in ("top_entities", "scores")} for r in res[:rec.n_real]])
    return out


def _log(engine):
    return [([q.key() for q in rec.queries], rec.n_real,
             [{k: r[k] for k in ("top_entities", "scores")} for r in rec.results])
            for rec in engine.batch_log]


def serve_engine(model, params, cache, ctx, queries, replay=False):
    """Run ``queries`` through a ``ServingEngine`` (rank 0 submits, the other
    ranks follow); returns (batch log, retraces of a second pass or None)."""
    from repro_torch.core import PooledExecutor
    from repro_torch.serving import ServingConfig, ServingEngine

    executor = PooledExecutor(model, b_max=64, device="cpu", ctx=ctx)
    cfg = ServingConfig(max_batch=MAX_BATCH, max_wait_ms=1000.0, top_k=TOP_K,
                        record_batches=True)
    eng = ServingEngine(model, params, executor=executor, cfg=cfg, device="cpu",
                        sem_cache=cache, sem_rows_fn=cache.store.read_rows if cache else None,
                        ctx=ctx)
    retraces = None
    if eng.leader:
        for f in eng.submit_many(queries):
            f.result(timeout=120)
        log = _log(eng)
        records = list(eng.batch_log)
        if replay:
            eng.reset_counters()
            for f in eng.submit_many(queries):
                f.result(timeout=120)
            retraces = eng.retraces()
        eng.close()
    else:
        eng.follow()
        log, records = _log(eng), list(eng.batch_log)
        eng.close()
    # serve_batch on the engine's own compositions (collective: every rank
    # holds the same log).
    return log, _replay(model, params, executor, records[:len(log)], cache, ctx), retraces


def serve_tier(model, params, ctx, queries):
    """``--replicas 2`` behind a ``Router``: each replica's batch log."""
    from repro_torch.serving import ReplicaPool, Router, ServingConfig

    cfg = ServingConfig(max_batch=MAX_BATCH, max_wait_ms=1000.0, top_k=TOP_K,
                        record_batches=True)
    pool = ReplicaPool(model, params, n_replicas=2, cfg=cfg, b_max=64, device="cpu",
                       ctx=ctx)
    if ctx is None or ctx.rank == 0:
        router = Router(pool)
        for f in router.submit_many(queries):
            f.result(timeout=120)
        router.close()
    else:
        pool.follow()
        pool.close()
    return {rid: _log(rep.engine) for rid, rep in pool.replicas().items()}


def serve_poison(model, params, ctx, queries):
    """A malformed query among ``queries``: rank 0's futures (answers, or the
    error's type name) and each rank's failure count and batch log."""
    from repro_torch.core import QueryInstance
    from repro_torch.serving import ServingConfig, ServingEngine

    bad = QueryInstance("no-such-pattern", np.array([1]), np.array([0]))
    cfg = ServingConfig(max_batch=MAX_BATCH, max_wait_ms=1000.0, top_k=TOP_K,
                        record_batches=True)
    eng = ServingEngine(model, params, cfg=cfg, device="cpu", ctx=ctx)
    got = None
    if eng.leader:
        got = []
        for f in eng.submit_many(queries[:4] + [bad] + queries[4:]):
            try:
                got.append(f.result(timeout=120)["top_entities"])
            except Exception as e:   # noqa: BLE001 (the type is the result)
                got.append(type(e).__name__)
        eng.close()
    else:
        eng.follow()
        eng.close()
    return got, eng.stats()["failures"], _log(eng)


def run(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.core import PooledExecutor
    from repro_torch.distributed import make_execution_context

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/pg{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(directory, "arrays.pkl"), "rb") as f:
        carried = pickle.load(f)
    kg = graph()
    queries = workload(kg)
    comps = compositions(queries)
    out = {"scores": {}, "engine": {}, "replay": {}, "retraces": {}, "shard": {},
           "tier": {}, "counts": {}}
    for spec, profile in MESHES[world]:
        ctx = make_execution_context(spec, profile=profile, device="cpu", backend="gloo")
        for family in FAMILIES:
            model, params, cache = build(family, carried[family], ctx)
            ex = PooledExecutor(model, b_max=64, device="cpu", ctx=ctx)
            out["scores"][spec, profile, family] = [raw_scores(model, params, ex, c, cache, ctx)
                                                    for c in comps]
            out["shard"][spec, profile, family] = tuple(params["entity"].shape)
            model, params, cache = build(family, carried[family], ctx)
            log, replay, retraces = serve_engine(model, params, cache, ctx, queries,
                                                 replay=world == 1)
            out["engine"][spec, profile, family] = log
            out["replay"][spec, profile, family] = replay
            out["retraces"][spec, profile, family] = retraces
        for family in TIER_FAMILIES:
            model, params, _ = build(family, carried[family], ctx)
            out["tier"][spec, profile, family] = serve_tier(model, params, ctx, queries)
        out["counts"][spec, profile] = ctx.mesh.stats()
    if world == 1:
        # The single-device engine and scores on the same weights.
        for family in FAMILIES:
            model, params, cache = build(family, carried[family], None)
            ex = PooledExecutor(model, b_max=64, device="cpu")
            out["scores"]["single", family] = [raw_scores(model, params, ex, c, cache, None)
                                               for c in comps]
            model, params, cache = build(family, carried[family], None)
            log, replay, retraces = serve_engine(model, params, cache, None, queries,
                                                 replay=True)
            out["engine"]["single", family] = log
            out["replay"]["single", family] = replay
            out["retraces"]["single", family] = retraces
        for family in TIER_FAMILIES:
            model, params, _ = build(family, carried[family], None)
            out["tier"]["single", family] = serve_tier(model, params, None, queries)
    if world == 2:
        from repro_torch.launch.serve import main

        ctx = make_execution_context("data=2", profile="fsdp", device="cpu", backend="gloo")
        model, params, _ = build("gqe", carried["gqe"], ctx)
        out["poison"] = serve_poison(model, params, ctx, queries[:8])

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--reduced", "--device", "cpu", "--dim", "8", "--requests", "32",
                  "--mesh", "data=2", "--profile", "fsdp", "--model", "betae",
                  "--trace", os.path.join(directory, "serve.json")])
        out["cli"] = buf.getvalue()
        with open(os.path.join(directory, f"serve.rank{rank}.json")) as f:
            out["cli_trace"] = json.load(f)
    with open(os.path.join(directory, f"w{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
