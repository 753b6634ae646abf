"""Rank processes for ``test_torch_lm_mesh.py``: gloo ranks on the CPU,
spawned under a file rendezvous. This module imports no JAX (it runs in each
rank); the parent holds the JAX package's results and compares.

Each rank runs every case of its world size (``cases``) with compute in fp32
and pickles what it saw to ``<dir>/w<world>.r<rank>.pkl``: its rows' forward
logits, prefill logits and decode logits, the train step's loss, the whole
parameters and Adam m after the step (gathered from the shards), and the
``ProcessMesh`` counters of the case beside a ``VirtualMesh``'s of the same
program run on meta tensors."""
import dataclasses
import datetime
import os
import pickle

import numpy as np
import torch

S, MARGIN = 32, 8
# (mesh, profile, global batch): the model-only mesh takes one row, so that
# every mesh's rows are the reference's one-row programs.
MESHES = {2: (("data=2", "fsdp", 2), ("data=1,model=2", "2d", 1)),
          4: (("data=2,model=2", "2d", 2),)}
BOTH_MODES = ("jamba-v0.1-52b", "mixtral-8x22b")


def names():
    from repro_torch.configs import ARCHS

    return sorted(ARCHS)


def cases(world):
    """(mesh spec, profile, batch, arch, moe_mode, seq_shard) of a world."""
    from repro_torch.configs import ARCHS

    for spec, profile, b in MESHES[world]:
        for name in names():
            modes = ("tp", "ep") if name in BOTH_MODES else (ARCHS[name].moe_mode,)
            for mode in modes:
                for seq in ((False,) if profile == "fsdp" else (False, True)):
                    yield spec, profile, b, name, mode, seq


def config(name, mode="tp", seq=False):
    from repro_torch.configs import ARCHS, reduced_config

    return dataclasses.replace(reduced_config(ARCHS[name]), moe_mode=mode, seq_shard=seq)


def batch_arrays(cfg, b=2):
    """The numpy batch both packages see (rows 0..b-1 of a 2-row draw)."""
    rng = np.random.default_rng(0)
    out = {"labels": rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["embeddings"] = (rng.normal(size=(2, S, cfg.d_model)) * 0.05).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    if cfg.is_encdec:
        out["encoder_frames"] = (rng.normal(size=(2, cfg.encoder_seq, cfg.d_model))
                                 * 0.05).astype(np.float32)
    return {k: v[:b] for k, v in out.items()}


def _program(cfg, ctx, dp, full, batch, b):
    """Forward logits, prefill and decode logits, then one train step, on
    this rank's shards of ``full`` (which stays whole)."""
    from repro_torch.lm.model import forward, logits_fn
    from repro_torch.lm.parallel import MeshPlan
    from repro_torch.lm.steps import (_forward_kwargs, lm_adam_init, make_decode_step,
                                      make_prefill_step, make_train_step)

    mesh = ctx.mesh
    shards = ctx.shard_tree(full)
    plan = MeshPlan(cfg, mesh, dp, b)
    local = {k: plan.local_rows(v) for k, v in batch.items()}
    with torch.no_grad():
        hidden, _ = forward(shards, cfg, par=plan, **_forward_kwargs(cfg, local))
        logits = logits_fn(shards, cfg, hidden, par=plan)
    caches, prefill = make_prefill_step(cfg, mesh, dp, cache_margin=MARGIN)(shards, batch)
    tok = torch.zeros((b, 1), dtype=torch.long, device=batch["labels"].device)
    decode, _ = make_decode_step(cfg, mesh, dp)(shards, caches, tok, S)
    opt = lm_adam_init(shards)
    _, opt, loss = make_train_step(cfg, mesh, dp)(shards, opt, batch)
    return {"logits": logits, "prefill": prefill, "decode": decode, "loss": loss,
            "shards": shards, "m": opt["m"]}


def run_case(live, rank, spec, profile, b, name, mode, seq, device="cpu"):
    """One case on ``live``'s ``ProcessMesh`` and on a ``VirtualMesh`` of
    its shape and rank."""
    from repro_torch.distributed import ExecutionContext, VirtualMesh
    from repro_torch.distributed.sharding import dp_axes
    from repro_torch.lm.model import init_params
    from repro_torch.lm.steps import flatten

    cfg = config(name, mode, seq)
    dp = dp_axes(live.mesh, profile)
    ctx = ExecutionContext.from_mesh(live.mesh, profile=profile, moe_mode=mode)
    full = init_params(cfg, seed=0, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_arrays(cfg, b).items()}
    live.mesh.counts.clear()
    live.mesh.bytes.clear()
    got = _program(cfg, ctx, dp, full, batch, b)
    counts = live.mesh.stats()
    # The same program on meta tensors over a virtual mesh.
    vm = VirtualMesh(dict(live.mesh.shape), rank)
    vctx = ExecutionContext.from_mesh(vm, profile=profile, moe_mode=mode)
    _program(cfg, vctx, dp, init_params(cfg, device="meta"),
             {k: v.to("meta") for k, v in batch.items()}, b)
    out = {k: got[k].detach().cpu().numpy() for k in ("logits", "prefill", "decode")}
    out["loss"] = float(got["loss"])
    out["counts"], out["virtual"] = counts, vm.stats()
    shapes = {k: tuple(v.shape) for k, v in flatten(full).items()}
    for part in ("shards", "m"):
        out[part] = {k: ctx.gather(k.rsplit("/", 1)[-1], v, shapes[k]).cpu().numpy()
                     for k, v in flatten(got[part]).items()}
    return out


def run(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import make_execution_context
    from repro_torch.lm import model as tm

    torch.set_num_threads(1)
    tm.COMPUTE_DTYPE = torch.float32
    dist.init_process_group("gloo", init_method=f"file://{directory}/lm{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    out, contexts = {}, {}
    for case in cases(world):
        spec, profile = case[0], case[1]
        if (spec, profile) not in contexts:
            contexts[spec, profile] = make_execution_context(spec, profile=profile,
                                                             device="cpu", backend="gloo")
        out[case] = run_case(contexts[spec, profile], rank, *case)
    with open(os.path.join(directory, f"w{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
