"""Rank processes for ``test_torch_ckpt_serve.py``: gloo ranks on the CPU,
spawned under a file rendezvous, each restoring single-device checkpoints
(``launch/serve.py::restore_params``) onto its mesh and serving fixed
compositions through ``serve_batch(ctx=)``. This module imports no JAX.

The graph has 2,049 entities, so a mesh of N ranks pads the entity rows to
a multiple of N (2,050 or 2,052) and, at dim 32, fsdp splits them: every
restore pads a checkpoint of 2,049 rows. Each rank pickles, for every mesh
and family, its answers, its entity block's shape and whether that block
is the checkpoint's rows (the padding rows its own), to
``<dir>/w<world>.r<rank>.pkl``; on two ranks also the serving CLI's output
with ``--mesh data=2 --ckpt-dir``."""
import contextlib
import datetime
import io
import os
import pickle

import numpy as np
import torch

E, R, TRIPLES = 2049, 10, 9000
DIM, SEM_DIM, TRAIN_BUDGET, SERVE_BUDGET, TOP_K = 32, 16, 256, 128, 10
N_REQ, MAX_BATCH = 32, 16
FAMILIES = ("betae", "gqe", "gqe+sem")      # gqe+sem: H_sem through the hot set
MESHES = {2: (("data=2", "fsdp"), ("data=1,model=2", "2d")),
          4: (("data=4", "fsdp"), ("data=2,model=2", "2d"))}


def graph():
    from repro_torch.data import generate_synthetic_kg

    return generate_synthetic_kg(E, R, TRIPLES, seed=0)


def compositions(kg):
    """The fixed padded compositions every rank serves."""
    from repro_torch.serving import make_workload, pad_to_bucket

    queries = make_workload(kg, N_REQ, seed=7)
    return [pad_to_bucket(queries[i:i + MAX_BATCH])[0]
            for i in range(0, len(queries), MAX_BATCH)]


def h_sem() -> np.ndarray:
    return np.random.default_rng(5).normal(size=(E, SEM_DIM)).astype(np.float32)


def model_for(family, pad: int):
    from repro_torch.models import ModelConfig, make_model

    return make_model(family.split("+")[0], ModelConfig(
        dim=DIM, entity_pad=pad, semantic_dim=SEM_DIM if "+" in family else 0), device="cpu")


def serve(family, ckpt, ctx, comps, pad: int):
    """(answers of every composition, entity block shape, whether the block
    holds the checkpoint's rows and keeps its own padding rows): the
    family's model with entity rows padded to ``pad``, its random draw
    replaced by the checkpoint in ``ckpt`` (collective under ``ctx``)."""
    from repro_torch.core import PooledExecutor
    from repro_torch.launch.serve import restore_params, serve_batch
    from repro_torch.semantic import SemanticCache
    from repro_torch.training.checkpoint import load_checkpoint

    model = model_for(family, pad)
    cache = (SemanticCache(h_sem(), SERVE_BUDGET, device="cpu", ctx=ctx)
             if family.endswith("+sem") else None)
    gen = torch.Generator().manual_seed(3)
    params = model.init_params(gen, E, R, semantic_cache=cache, ctx=ctx)
    before = params["entity"].clone()
    step = restore_params(ckpt, model, params, ctx=ctx, sem_cache=cache)
    assert step is not None
    ent = load_checkpoint(ckpt)[1]["params/entity"]
    n = before.shape[0]
    lo = 0
    if ctx is not None:
        axes = ctx.row_axes("entity", model.full_shapes["entity"])
        lo = ctx.mesh.index(axes) * n if axes else 0
    real = max(min(E - lo, n), 0)
    block_ok = (np.array_equal(params["entity"][:real].numpy(), ent[lo:lo + real])
                and torch.equal(params["entity"][real:], before[real:]))
    executor = PooledExecutor(model, b_max=64, device="cpu", ctx=ctx)
    answers = []
    for comp in comps:
        res, _ = serve_batch(model, params, executor, comp, top_k=TOP_K, device="cpu",
                             sem_cache=cache, ctx=ctx,
                             sem_rows_fn=cache.store.read_rows if cache else None)
        answers.append([{k: r[k] for k in ("top_entities", "scores")} for r in res])
    return answers, tuple(params["entity"].shape), block_ok


def run(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import make_execution_context

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/pg{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    kg = graph()
    comps = compositions(kg)
    out = {"answers": {}, "shard": {}, "block_ok": {}}
    for spec, profile in MESHES[world]:
        ctx = make_execution_context(spec, profile=profile, device="cpu", backend="gloo")
        for family in FAMILIES:
            got = serve(family, os.path.join(directory, family), ctx, comps, world)
            key = spec, profile, family
            out["answers"][key], out["shard"][key], out["block_ok"][key] = got
    if world == 2:
        from repro_torch.launch.serve import main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--reduced", "--device", "cpu", "--dim", "128", "--requests", "32",
                  "--max-wait-ms", "1000", "--mesh", "data=2", "--profile", "fsdp",
                  "--model", "betae", "--ckpt-dir", os.path.join(directory, "cli"),
                  "--answers", os.path.join(directory, "cli.jsonl")])
        out["cli"] = buf.getvalue()
    with open(os.path.join(directory, f"w{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
