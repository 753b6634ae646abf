"""Rank processes for ``test_torch_mesh_live.py``: gloo ranks on the CPU,
spawned under a file rendezvous. This module imports no JAX (it runs in each
rank); the parent holds the JAX package's results and compares.

Each rank runs the live tier's deterministic write script (``script``) for
every mesh and family of its world size, and pickles what it saw to
``<dir>/w<world>.r<rank>.pkl``: the answers of every request (or ``"stale"``
for a shed), the graph versions, the engine's counters, each published
params set gathered whole (rank 0; a digest on the others), its entity block
after the growth, and a synchronous mesh ``incremental_finetune``. At one
rank it also runs the script single-device; at two ranks a concurrent writer
under a closed loop, the replica tier's hot swap and the serving CLI."""
import contextlib
import datetime
import hashlib
import io
import os
import pickle
import threading

import numpy as np
import torch

E, R, TRIPLES = 2048, 10, 9000        # tests/test_torch_mesh_serving.py's graph
# dim 32: at 16 the 2,048-row table (32,768 elements) falls under fsdp's
# 65,536-element floor and would be replicated, not split.
DIM, TOP_K, MAX_BATCH, PAD = 32, 10, 16, 8
FAMILIES = ("gqe", "betae")
MESHES = {1: (("data=1", "fsdp"), ("data=1", "2d")),
          2: (("data=2", "fsdp"), ("data=1,model=2", "2d")),
          4: (("data=4", "fsdp"), ("data=2,model=2", "2d"))}
STALENESS, FT_STEPS, FT_SEED, N_NEW = 1, 2, 3, 8
N_QUERIES = 112
# The sync fine-tune held to the reference's (test_torch_live.py's call).
SYNC_STEPS, SYNC_LR, SYNC_SEED = 4, 1e-2, 4


def graph():
    from repro_torch.data import generate_synthetic_kg

    return generate_synthetic_kg(E, R, TRIPLES, seed=0)


def workload(kg, n=N_QUERIES):
    from repro_torch.serving import make_workload

    return make_workload(kg, n, seed=7)


def bursts(kg) -> dict:
    """The script's three write bursts (fresh against the initial graph and
    each other): A plain, B adding ``N_NEW`` entities (their ids as heads
    and tails), C plain; and the sync fine-tune's burst (existing triples)."""
    rng = np.random.default_rng(11)
    cand = np.stack([rng.integers(0, E, 400), rng.integers(0, R, 400),
                     rng.integers(0, E, 400)], axis=1)
    cand = np.unique(cand[~kg.contains(cand)], axis=0)
    cand = cand[rng.permutation(len(cand))]
    a, b, c = cand[:16], cand[16:32].copy(), cand[32:48]
    new_ids = np.arange(E, E + N_NEW)
    b[:N_NEW, 0] = new_ids
    b[N_NEW:, 2] = new_ids
    sync = kg.triples[rng.choice(len(kg), 16, replace=False)]
    return {"A": a, "B": b, "C": c, "sync": sync}


def build(family, arrays, ctx, device="cpu"):
    from repro_torch.models import ModelConfig, make_model, params_from_numpy

    model = make_model(family, ModelConfig(dim=DIM, entity_pad=PAD), device=device)
    params = params_from_numpy(model, arrays, n_entities=E, ctx=ctx)
    return model, params


def whole(ctx, model, params) -> dict:
    """``params`` gathered whole as numpy (collective under a mesh), the
    entity table's rows read off its block (retained sets predate growth)."""
    if ctx is None:
        return {k: v.cpu().numpy().copy() for k, v in sorted(params.items())}
    axes = ctx.row_axes("entity", model.full_shapes["entity"])
    rows = params["entity"].shape[0] * ctx.mesh.ways(axes)
    shapes = {**model.full_shapes, "entity": (rows, params["entity"].shape[1])}
    return {k: ctx.gather(k, v, shapes[k]).cpu().numpy() for k, v in sorted(params.items())}


def digest(obj) -> str:
    """A hash of ``obj``'s values (not of how its objects are shared)."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, np.ndarray):
            h.update(f"{o.dtype}{o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, dict):
            for k in sorted(o):
                h.update(repr(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for x in o:
                walk(x)
            h.update(b"]")
        else:
            h.update(repr(o).encode())

    walk(obj)
    return h.hexdigest()


def _payloads(results) -> list:
    """What ``serve_batch`` returns of each result (rank 0's engine also
    notes each request's latency and batch size in its log)."""
    return [{k: r[k] for k in ("top_entities", "scores")} for r in results]


def _answer(f):
    from repro_torch.serving import StaleVersionError

    try:
        r = f.result(timeout=120)
    except StaleVersionError:
        return "stale"
    return {k: r[k] for k in ("top_entities", "scores")}


def script(family, arrays, kg, burst, ctx) -> dict:
    """The deterministic write script on one engine (rank 0 submits and
    writes, the other ranks follow): steps of whole 16-request batches,
    pinned ones among them, with a write and its flushed fine-tune between
    steps (A; B, which grows the table; C). Every rank publishes the same
    params sets, gathered afterwards (collective)."""
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.serving import (LiveNGDB, ServingConfig, ServingEngine,
                                     StaleVersionError)

    model, params = build(family, arrays, ctx)
    mat = MaterializedSubqueryCache(256)
    mat.watch_kg(kg)
    cfg = ServingConfig(max_batch=MAX_BATCH, max_wait_ms=2000.0, top_k=TOP_K,
                        max_staleness_versions=STALENESS, record_batches=True)
    eng = ServingEngine(model, params, executor=PooledExecutor(model, b_max=64, device="cpu",
                                                               ctx=ctx),
                        cfg=cfg, device="cpu", kg=kg, mat_cache=mat, ctx=ctx)
    published = []
    swap = eng._swap

    def recorded(p):
        published.append(p)
        swap(p)

    eng._swap = recorded
    live = LiveNGDB(model, kg, eng, finetune_steps=FT_STEPS, n_negatives=8, seed=FT_SEED)
    out = {"answers": [], "versions": []}
    if eng.leader:
        qs = workload(kg)
        v0 = kg.graph_version

        def serve(unpinned, pinned=()):
            fs = eng.submit_many(unpinned)
            for q, v in pinned:
                try:
                    fs.append(eng.submit(q, pin_version=v))
                except StaleVersionError:
                    out["answers"].append("stale")
            out["answers"] += [_answer(f) for f in fs]

        def write(name, n_new=0):
            live.write(burst[name], n_new_entities=n_new)
            live.flush()
            out["versions"].append(kg.graph_version)

        serve(qs[:32])
        write("A")
        serve(qs[32:48], [(q, v0) for q in qs[48:64]])
        write("B", N_NEW)
        vb = kg.graph_version
        serve(qs[64:80], [(q, v0) for q in qs[80:96]] + [(q, vb - 1) for q in qs[96:112]])
        write("C")
        serve(qs[:16], [(q, kg.graph_version - 1) for q in qs[16:32]])
        live.close()
        eng.close()
    else:
        eng.follow()
        eng.close()
        live.close()
    st = eng.stats()
    out["stats"] = {k: st[k] for k in ("graph_version", "retained_versions", "stale_sheds",
                                       "version_lag_served", "failures", "batches")}
    out["stats"]["mat"] = {k: st["mat_cache"][k] for k in ("hits", "misses", "live",
                                                          "evictions")}
    out["finetunes"] = live.finetunes_done
    out["reblock_bytes"] = live.reblock_bytes
    out["n_entities"] = (kg.n_entities, model.n_entities)
    out["block"] = tuple(eng.params["entity"].shape)
    out["full"] = tuple(model.full_shapes["entity"])
    out["params"] = [whole(ctx, model, p) for p in published]
    # This rank's block is exactly its rows of the grown table.
    n = out["block"][0]
    lo = ctx.mesh.index(ctx.row_axes("entity", model.full_shapes["entity"])) * n if ctx else 0
    out["own_block"] = bool(np.array_equal(eng.params["entity"].numpy(),
                                           out["params"][-1]["entity"][lo:lo + n]))
    # Every rank's batches (a follower answers no future) and params.
    out["digest"] = (digest([[q.key() for q in rec.queries] + _payloads(rec.results)
                             for rec in eng.batch_log]), digest(out["params"]))
    return out


def concurrent(arrays, kg, burst, ctx) -> dict:
    """A closed loop of 8 in flight (every fourth request pinned a version
    behind) while a writer thread lands A, B (growth) and C."""
    from repro_torch.core import PooledExecutor
    from repro_torch.serving import LiveNGDB, ServingConfig, ServingEngine, StaleVersionError

    model, params = build("gqe", arrays, ctx)
    cfg = ServingConfig(max_batch=8, max_wait_ms=2.0, top_k=TOP_K, max_staleness_versions=1)
    eng = ServingEngine(model, params, executor=PooledExecutor(model, b_max=64, device="cpu",
                                                               ctx=ctx),
                        cfg=cfg, device="cpu", kg=kg, ctx=ctx)
    live = LiveNGDB(model, kg, eng, finetune_steps=FT_STEPS, n_negatives=8, seed=FT_SEED)
    out = {}
    if eng.leader:
        qs = workload(kg) * 2
        served = shed = 0

        def writer():
            for name, n_new in (("A", 0), ("B", N_NEW), ("C", 0)):
                live.write(burst[name], n_new_entities=n_new)

        wt = threading.Thread(target=writer)
        wt.start()
        window = []
        for i, q in enumerate(qs):
            if len(window) >= 8:
                served, shed = _settle(window.pop(0), served, shed)
            pin = max(0, eng.graph_version - 1) if i % 4 == 3 else None
            try:
                window.append(eng.submit(q, pin_version=pin))
            except StaleVersionError:
                shed += 1
        for f in window:
            served, shed = _settle(f, served, shed)
        wt.join()
        live.close()
        eng.close()
        out.update(served=served, shed=shed, n=len(qs))
    else:
        out["followed"] = eng.follow()
        eng.close()
        live.close()
    out["failures"] = eng.stats()["failures"]
    out["finetunes"] = live.finetunes_done
    out["final"] = digest(whole(ctx, model, eng.params))
    return out


def _settle(f, served, shed):
    from repro_torch.serving import StaleVersionError

    try:
        f.result(timeout=120)
        return served + 1, shed
    except StaleVersionError:
        return served, shed + 1


def tier_swap(arrays, kg, ctx) -> dict:
    """``ReplicaPool(2)`` behind a ``Router``: half a stream, ``update_params``
    at once (the first half still queued), the other half. Every rank's
    batches: the params version each ran on, the half its queries came
    from, and whether it is bitwise ``serve_batch`` on those params."""
    from repro_torch.launch.serve import serve_batch
    from repro_torch.serving import ReplicaPool, Router, ServingConfig

    model, params_a = build("gqe", arrays, ctx)
    params_b = {**params_a, "entity": params_a["entity"] * 1.5}
    cfg = ServingConfig(max_batch=MAX_BATCH, max_wait_ms=5.0, top_k=TOP_K,
                        record_batches=True)
    pool = ReplicaPool(model, params_a, n_replicas=2, cfg=cfg, b_max=64, device="cpu",
                       ctx=ctx)
    qs = workload(kg, 96)
    first, second = qs[:48], qs[48:]
    if ctx.rank == 0:
        router = Router(pool)
        fa = router.submit_many(first)
        router.update_params(params_b)
        fb = router.submit_many(second)
        for f in fa + fb:
            f.result(timeout=120)
        router.close()
    else:
        pool.update_params(params_b)   # staged: applied when swap 1 arrives
        pool.follow()
        pool.close()
    keys_a = {q.key() for q in first}
    keys_b = {q.key() for q in second}
    out = []
    for rid, rep in sorted(pool.replicas().items()):
        for rec in rep.engine.batch_log:
            keys = {q.key() for q in rec.queries[:rec.n_real]}
            half = ("first" if keys <= keys_a - keys_b else
                    "second" if keys <= keys_b - keys_a else "both")
            p = params_a if rec.params_version == 0 else params_b
            res, _ = serve_batch(model, p, rep.executor, rec.queries, top_k=TOP_K,
                                 device="cpu", ctx=ctx)
            out.append((rid, rec.params_version, half,
                        _payloads(rec.results) == _payloads(res[:rec.n_real])))
    return {"batches": out, "digest": digest([[q.key() for q in rec.queries]
                                              + _payloads(rec.results)
                                              for rep in pool.replicas().values()
                                              for rec in rep.engine.batch_log])}


def sync_finetune(family, arrays, burst, ctx) -> dict:
    from repro_torch.training import incremental_finetune

    model, params = build(family, arrays, ctx)
    new, losses = incremental_finetune(model, params, burst, steps=SYNC_STEPS, lr=SYNC_LR,
                                       seed=SYNC_SEED, ctx=ctx)
    return {"params": whole(ctx, model, new), "losses": losses}


def run(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import make_execution_context

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/pg{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(directory, "arrays.pkl"), "rb") as f:
        carried = pickle.load(f)
    burst = carried["bursts"]
    out = {"script": {}, "sync": {}}
    for spec, profile in MESHES[world]:
        ctx = make_execution_context(spec, profile=profile, device="cpu", backend="gloo")
        for family in FAMILIES:
            res = script(family, carried[family], graph(), burst, ctx)
            if rank:
                res["params"] = None     # rank 0 keeps them; the digest covers them
            out["script"][spec, profile, family] = res
            if world > 1:
                out["sync"][spec, profile, family] = sync_finetune(
                    family, carried[family], burst["sync"], ctx)
    if world == 1:
        for family in FAMILIES:
            out["script"]["single", family] = script(family, carried[family], graph(), burst,
                                                     None)
    if world == 2:
        from repro_torch.launch.serve import main

        ctx = make_execution_context("data=2", profile="fsdp", device="cpu", backend="gloo")
        out["concurrent"] = concurrent(carried["gqe"], graph(), burst, ctx)
        out["tier"] = tier_swap(carried["gqe"], graph(), ctx)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--reduced", "--device", "cpu", "--dim", "8", "--requests", "32",
                  "--mesh", "data=2", "--profile", "fsdp", "--model", "gqe",
                  "--live-writes", "2", "--max-staleness", "2", "--materialize", "64",
                  "--max-wait-ms", "20"])
        out["cli"] = buf.getvalue()
    with open(os.path.join(directory, f"w{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
