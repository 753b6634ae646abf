"""Rank processes for ``test_torch_mesh.py``: gloo ranks on the CPU, spawned
under a file rendezvous. This module imports no JAX (it runs in each rank);
the parent holds the JAX package's results and compares.

Each rank runs the scenarios of its world size and pickles what it saw to
``<dir>/w<world>.r<rank>.pkl``."""
import contextlib
import datetime
import io
import os
import pickle

import numpy as np
import torch

E, R, TRIPLES = 2048, 10, 9000       # tests/test_sharded_parity.py's graph
DIM, SEM_DIM, B, NEG, STEPS, N_BATCHES = 32, 16, 16, 4, 4, 3
BUDGET = 256                         # hot-set rows (a batch needs <= 128)
FAMILIES = ("gqe", "betae", "gqe+sem")
MESHES = {1: (("data=1", "fsdp"), ("data=1", "2d")),
          2: (("data=2", "fsdp"), ("data=1,model=2", "2d")),
          4: (("data=4", "fsdp"), ("data=2,model=2", "2d"))}


def graph_and_batches():
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.sampling import OnlineSampler

    kg = generate_synthetic_kg(E, R, TRIPLES, seed=0)
    sampler = OnlineSampler(kg, seed=7)
    return kg, [sampler.sample_batch(B) for _ in range(N_BATCHES)]


def h_sem() -> np.ndarray:
    return np.random.default_rng(5).normal(size=(E, SEM_DIM)).astype(np.float32)


def make_trainer(kg, family, ctx, pipeline, arrays=None, ckpt=None, device="cpu", **kw):
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    sem = family.endswith("+sem")
    model = make_model(family.split("+")[0], ModelConfig(dim=DIM, entity_pad=8,
                                                         semantic_dim=SEM_DIM if sem else 0),
                       device=device)
    cfg = TrainConfig(batch_size=B, n_negatives=NEG, b_max=64, prefetch=0,
                      adam=AdamConfig(lr=1e-3), pipeline=pipeline, seed=0,
                      checkpoint_dir=ckpt, checkpoint_every=STEPS, **kw)
    cache = SemanticCache(h_sem(), BUDGET, device=device, ctx=ctx) if sem else None
    tr = NGDBTrainer(model, kg, cfg, semantic_cache=cache, ctx=ctx)
    if arrays is not None:
        tr.load_params(arrays)
    return tr


def losses(tr, batches):
    return [r["loss"] for r in tr.train(STEPS, log_every=0, batches=batches)]


def step1_gaps(tr, ref):
    """After one step of ``tr`` (a mesh rank) and ``ref`` (single-device, on
    the same batch from the same parameters), for each trainable name
    against the shard ``ctx.shard`` keeps of ``ref``'s: the norm-wise
    relative difference of this rank's Adam ``m`` and ``v`` shards, and the
    largest difference of its parameter shard in units of the learning rate
    (a first Adam step moves an element by at most lr, so rounding can at
    most flip one: 2). A name whose gradient is exactly zero (``ref``'s
    ``m`` at most 1e-6 of the largest) is rounding on both sides: its
    moments get instead the largest ``m`` of the rank's shard over that
    bound ("rounding", at most 1.0 to pass)."""
    frozen, lr = tr.cfg.adam.frozen, tr.cfg.adam.lr
    names = [k for k in sorted(tr.params) if k not in frozen]
    top = max(float(ref.opt_state["m"][k].abs().max()) for k in names)
    out = {}
    for k in names:
        out["params", k] = float((tr.params[k] - tr.ctx.shard(k, ref.params[k])).abs().max()) / lr
        if float(ref.opt_state["m"][k].abs().max()) <= 1e-6 * top:
            out["rounding", k] = float(tr.opt_state["m"][k].abs().max()) / (1e-6 * top)
            continue
        for part in ("m", "v"):
            want = tr.ctx.shard(k, ref.opt_state[part][k])
            got = tr.opt_state[part][k]
            out[part, k] = float((got - want).norm()) / max(float(want.norm()), 1e-30)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def run(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import make_execution_context

    device, backend = "cpu", "gloo"
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{directory}/pg{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(directory, "arrays.pkl"), "rb") as f:
        carried = pickle.load(f)
    kg, batches = graph_and_batches()
    out = {"losses": {}, "local_rows": {}, "counts": {}, "step1": {}}
    for spec, profile in MESHES[world]:
        ctx = make_execution_context(spec, profile=profile, device=device, backend=backend)
        for family in FAMILIES:
            # What the trainer's own update wrote after one step.
            tr = make_trainer(kg, family, ctx, False, carried[family], device=device)
            tr.train(1, log_every=0, batches=batches)
            ref = make_trainer(kg, family, None, False, carried[family], device=device)
            ref.train(1, log_every=0, batches=batches)
            out["step1"][spec, profile, family] = step1_gaps(tr, ref)
        for family in FAMILIES:
            for pipeline in (False, True):
                tr = make_trainer(kg, family, ctx, pipeline, carried[family], device=device)
                out["losses"][spec, profile, family, pipeline] = losses(tr, batches)
                out["local_rows"][spec, profile, family] = tuple(tr.params["entity"].shape)
        tr = make_trainer(kg, "gqe", ctx, False, carried["gqe"], device=device,
                          executor="query_level")
        out["losses"][spec, profile, "gqe query_level", False] = losses(tr, batches)
        out["counts"][spec, profile] = ctx.mesh.stats()
    first = MESHES[world][0]
    ctx = make_execution_context(first[0], profile=first[1], device=device, backend=backend)
    if world == 1:
        for family in FAMILIES:
            for pipeline in (False, True):
                tr = make_trainer(kg, family, None, pipeline, carried[family], device=device)
                out["losses"]["single", family, pipeline] = losses(tr, batches)
        tr = make_trainer(kg, "gqe", None, False, carried["gqe"], device=device,
                          executor="query_level")
        out["losses"]["single", "gqe query_level", False] = losses(tr, batches)
    # per_q after one step, in the global batch's canonical order.
    tr = make_trainer(kg, "gqe", ctx, False, carried["gqe"], device=device)
    tr.train(1, log_every=0, batches=batches)
    out["per_q"] = tr.last_per_q
    # Adaptive sampling from the seeded sampler: π and the losses per rank.
    for pipeline in (False, True):
        tr = make_trainer(kg, "gqe", ctx, pipeline, carried["gqe"], device=device,
                          adaptive=True)
        tr.train(STEPS, log_every=0)
        out["adaptive", pipeline] = (dict(tr.adaptive.difficulty),
                                     [r["loss"] for r in tr.history])
    if world == 4:
        # Save at step STEPS: every rank gathers, rank 0 writes.
        tr = make_trainer(kg, "gqe", ctx, True, carried["gqe"],
                          ckpt=os.path.join(directory, "ck"), device=device)
        tr.train(STEPS, log_every=0, batches=batches)
        out["saved"] = _np(tr._full_tree(tr.params, tr.opt_state))
        from repro_torch.training.compression import compressed_psum

        g = torch.from_numpy(np.random.default_rng(rank).normal(size=64).astype(np.float32))
        e = torch.from_numpy(np.random.default_rng(10 + rank).normal(
            scale=0.01, size=64).astype(np.float32))
        out["psum"] = [t.numpy() for t in compressed_psum(g.to(device), None, e.to(device))]
    if world == 2:
        # Elastic restore of the 4-rank run's checkpoint onto this mesh.
        tr = make_trainer(kg, "gqe", ctx, False, ckpt=os.path.join(directory, "ck"),
                          device=device)
        out["resumed"] = tr.resume()
        out["restored_step"] = tr.step
        out["restored_local"] = _np({"params": tr.params, "opt": tr.opt_state})
        out["restored_full"] = _np(tr._full_tree(tr.params, tr.opt_state))
        # gpipe over the pod axis against the sequential loop (in the parent).
        from repro_torch.distributed import gpipe_forward

        pp = make_execution_context("pod=2,data=1", device=device, backend=backend)
        rng = np.random.default_rng(3)
        w = torch.from_numpy(rng.normal(size=(2, 8, 8)).astype(np.float32) / 3).to(device)
        bias = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)).to(device)
        x = torch.from_numpy(rng.normal(size=(4, 3, 8)).astype(np.float32)).to(device)
        y = gpipe_forward(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                          {"w": w, "b": bias}, x, pp.mesh)
        out["gpipe"] = (w.cpu().numpy(), bias.cpu().numpy(), x.cpu().numpy(), y.cpu().numpy())
        out["gpipe_staged"] = pp.mesh.staged
        # The training CLI in this group.
        from repro_torch.launch.train import main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--reduced", "--device", device, "--dim", "8", "--batch-size", "16",
                  "--negatives", "4", "--steps", "2", "--eval-queries", "8",
                  "--log-every", "1", "--mesh", "data=2", "--profile", "fsdp"])
        out["cli"] = buf.getvalue()
    with open(os.path.join(directory, f"w{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
