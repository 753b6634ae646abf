"""The LM zoo over a mesh on the CPU: gloo ranks spawned under a file
rendezvous (``tests/torch_lm_mesh_worker.py``), held to the JAX package's
single-device results on the same weights and numpy inputs, with compute in
fp32 in both (``COMPUTE_DTYPE`` patched).

* all ten reduced architectures on ``data=2`` (fsdp), ``data=1,model=2``
  (2d) and ``data=2,model=2`` (2d), 2d with ``seq_shard`` off and on,
  mixtral and jamba in ``moe_mode`` tp and ep;
* each rank's rows: forward logits, prefill logits and decode logits within
  ``tests/test_torch_lm.py``'s fp32 tolerance (rtol 1e-4, atol 1e-4) of the
  reference's forward, prefill and decode on those rows; the train step's
  loss within 1e-5 of the mean over the batch's rows of the reference's loss;
  the whole Adam m (gathered from the shards) leaf by leaf within 1e-4 of
  its norm of 0.1 of the mean of the rows' gradients, and each leaf's
  update (parameters after the step less before) within 0.5 of its norm
  of the reference's first Adam step, -lr·g/(|g|+eps). A rank routes its own rows' tokens through the experts (each
  capacity is a row's), so the reference runs one row at a time, the
  model-only mesh taking a one-row batch;
* each rank's ``ProcessMesh`` counters of a case equal to a ``VirtualMesh``'s
  of the same shape and rank over the same program on meta tensors.

The two spawns (2 and 4 ranks) run while the reference compiles, each with a
time limit."""
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_lm_mesh_worker as W

SPAWN_TIMEOUT_S = 150
LR, B1 = 1e-4, 0.9   # LM_ADAM
# A first Adam step moves an element by about lr·sign(g): gradients within
# rounding of 0 may take either sign, so the update is held norm-wise (an
# update left out reads 1, one of the wrong sign 2).
UPDATE_TOL = 0.5


def _spawn(world, directory):
    import torch.multiprocessing as mp

    return mp.start_processes(W.run, args=(world, directory), nprocs=world, join=False,
                              start_method="spawn")


def _join(pc, world):
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not pc.join(timeout=1):
        if time.monotonic() > deadline:
            for p in pc.processes:
                p.kill()
            pytest.fail(f"the {world}-rank spawn did not finish in {SPAWN_TIMEOUT_S} s")


def _reference():
    """{arch: [row 0's, row 1's]} of the reference's fp32 one-row program on
    the port's weights: forward logits, loss, flat gradients, prefill and
    decode logits; and {arch: flat initial parameters}."""
    from repro.lm import model as jm
    from repro.lm import steps as js
    from repro_torch.lm.model import init_params
    from repro_torch.lm.steps import flatten

    saved = jm.COMPUTE_DTYPE
    jm.COMPUTE_DTYPE = jnp.float32
    out, init = {}, {}
    try:
        for name in W.names():
            cfg = W.config(name)
            arrays = jax.tree.map(lambda t: t.numpy(), init_params(cfg, seed=0, device="cpu"))
            init[name] = flatten(arrays)

            def ref(p, b, cfg=cfg):
                def loss_fn(p):
                    h, _ = jm.forward(p, cfg, **js._forward_kwargs(cfg, b))
                    return jm.chunked_ce_loss(p, cfg, h, b["labels"]), h

                (loss, h), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
                caches, prefill = js.make_prefill_step(cfg, cache_margin=W.MARGIN)(p, b)
                decode, _ = js.make_decode_step(cfg)(p, caches, jnp.zeros((1, 1), jnp.int32),
                                                     jnp.int32(W.S))
                return jm.logits_fn(p, cfg, h), loss, g, prefill, decode

            fn = jax.jit(ref)
            both = W.batch_arrays(cfg, 2)
            rows = []
            for r in range(2):
                o = jax.tree.map(np.asarray, fn(jax.tree.map(jnp.asarray, arrays),
                                                {k: jnp.asarray(v[r:r + 1]) for k, v in both.items()}))
                rows.append({"logits": o[0], "loss": float(o[1]), "grads": flatten(o[2]),
                             "prefill": o[3], "decode": o[4]})
            out[name] = rows
    finally:
        jm.COMPUTE_DTYPE = saved
    return out, init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm_mesh"))
    pcs = {w: _spawn(w, d) for w in (2, 4)}
    ref = _reference()
    for w, pc in pcs.items():
        _join(pc, w)
    out = {}
    for w in (2, 4):
        for r in range(w):
            with open(os.path.join(d, f"w{w}.r{r}.pkl"), "rb") as f:
                out[w, r] = pickle.load(f)
    return ref, out


CASES = [(w, case) for w in (2, 4) for case in W.cases(w)]


def _rank_rows(world, spec, b, rank):
    """The reference rows a rank holds: by its data coordinate (row-major
    over (data, model)); the one-row batch's single row on every rank."""
    if b == 1:
        return [0]
    model = 2 if "model=2" in spec else 1
    return [rank // model]


def _id(c):
    w, (spec, profile, b, name, mode, seq) = c
    return f"{spec}-{profile}-{name}-{mode}" + ("-seq" if seq else "")


@pytest.mark.parametrize("world,case", CASES, ids=[_id(c) for c in CASES])
def test_mesh_rank_outputs_match_reference(runs, world, case):
    """Every rank's logits, prefill and decode logits and loss (module
    docstring)."""
    (ref, _), out = runs
    spec, profile, b, name, mode, seq = case
    rows = ref[name]
    want_loss = np.mean([rows[r]["loss"] for r in range(b)])
    for rank in range(world):
        got = out[world, rank][case]
        (row,) = _rank_rows(world, spec, b, rank)
        for key in ("logits", "prefill", "decode"):
            assert np.isfinite(got[key]).all(), (rank, key)
            np.testing.assert_allclose(got[key], rows[row][key], rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {rank} {key}")
        assert abs(got["loss"] - want_loss) <= 1e-5, (rank, got["loss"], want_loss)


@pytest.mark.parametrize("world,case", CASES, ids=[_id(c) for c in CASES])
def test_mesh_train_step_moments_and_params_match_reference(runs, world, case):
    """The whole Adam m and parameters after one step, gathered from the
    shards on every rank (module docstring)."""
    (ref, init), out = runs
    spec, profile, b, name, mode, seq = case
    g = {k: np.mean([ref[name][r]["grads"][k] for r in range(b)], axis=0)
         for k in ref[name][0]["grads"]}
    update = {k: -LR * v / (np.abs(v) + 1e-8) for k, v in g.items()}
    for rank in range(world):
        got = out[world, rank][case]
        assert set(got["m"]) == set(g)
        for k, v in g.items():
            want = (1 - B1) * v.astype(np.float64)
            gap = np.linalg.norm(got["m"][k] - want) / max(np.linalg.norm(want), 1e-30)
            assert gap <= 1e-4, (rank, "m", k, gap)
            moved = got["shards"][k].astype(np.float64) - init[name][k]
            gap = np.linalg.norm(moved - update[k]) / max(np.linalg.norm(update[k]), 1e-30)
            assert gap <= UPDATE_TOL, (rank, "update", k, gap)


@pytest.mark.parametrize("world", [2, 4])
def test_process_mesh_counts_equal_the_virtual_meshes(runs, world):
    """For every case and rank: calls and bytes of each collective on the
    gloo ``ProcessMesh`` equal those of a ``VirtualMesh`` of the same shape
    and rank over the same program on meta tensors; a case split over
    model (or over data) issues collectives."""
    _, out = runs
    for rank in range(world):
        for case, got in out[world, rank].items():
            assert got["counts"] == got["virtual"], (case, rank)
            assert got["counts"]["counts"], case


@pytest.mark.parametrize("mode", ["tp", "ep"])
def test_moe_ffn_under_a_one_rank_plan_matches_reference(mode):
    """``moe_ffn(par=)`` on a one-rank gloo mesh (the copy-in, the local
    experts and the all-reduce after the combine) is bitwise the port's
    single-device ``moe_ffn``, and within fp32 tolerance (rtol 1e-5,
    atol 1e-5) of the reference's."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro.lm import moe as jmoe
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.lm import moe as tmoe
    from repro_torch.lm.parallel import MeshPlan

    rng = np.random.default_rng(3)
    t, d, f, e = 24, 16, 8, 4
    cfg = dataclasses.replace(reduced_config(ARCHS["mixtral-8x22b"]), n_experts=e, top_k=2,
                              moe_mode=mode)
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) / 4 for s in ((e, d, f), (e, d, f), (e, f, d))]
    was = dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        par = MeshPlan(cfg, mesh, ("data",), x.shape[0])
        before = dict(mesh.counts)
        got = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(router),
                           *(torch.from_numpy(a) for a in w), cfg, par=par)
        assert mesh.counts.get("all_reduce", 0) == before.get("all_reduce", 0) + 1
    finally:
        if not was and dist.is_initialized():
            dist.destroy_process_group()
    single = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(router),
                          *(torch.from_numpy(a) for a in w), cfg)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    want = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router), *(jnp.asarray(a) for a in w), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
