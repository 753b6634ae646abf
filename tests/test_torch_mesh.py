"""Training under a mesh on the CPU: gloo ranks spawned under a file
rendezvous (``tests/torch_mesh_worker.py``), held to the JAX package.

* GQE, BetaE and GQE+H_sem through a hot set, sync and pipelined, at 1, 2
  and 4 ranks, fsdp and 2d: losses within 1e-3 of the reference's
  single-device ``NGDBTrainer`` on the same batches from the same
  parameters (the gate of ``tests/test_sharded_parity.py``); at one rank
  bitwise the port's single-device run;
* after one step, each rank's Adam moments and parameters (what the
  trainer's own update wrote) against a single-device step's;
* the entity table physically 1/N a rank where the rules split it;
* per-query losses gathered in the global canonical order, adaptive
  distributions identical on every rank;
* elastic restore of a 4-rank checkpoint on 2 ranks, bitwise;
* ``compressed_psum`` on 4 ranks against the reference's under
  ``shard_map`` on 4 emulated devices; ``gpipe_forward`` on 2 ranks against
  the sequential loop; the training CLI with ``--mesh data=2``.

The spawns run once for the module (4 ranks while the reference trains, then
2 and 1 together), each with a time limit."""
import os
import pickle
import subprocess
import sys
import time

import jax  # noqa: F401  (on the CPU, before the JAX package's modules)
import numpy as np
import pytest
import torch

import torch_mesh_worker as W

SPAWN_TIMEOUT_S = 150
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _reference(directory):
    """The JAX package's single-device losses per family on the port's
    batches' twins, and its initial parameters (carried to every rank)."""
    from repro.data import generate_synthetic_kg
    from repro.models import ModelConfig, make_model
    from repro.sampling import OnlineSampler
    from repro.semantic import SemanticCache
    from repro.training import AdamConfig, NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(W.E, W.R, W.TRIPLES, seed=0)
    sampler = OnlineSampler(kg, seed=7)
    batches = [sampler.sample_batch(W.B) for _ in range(W.N_BATCHES)]
    carried, ref = {}, {}
    for family in W.FAMILIES:
        sem = family.endswith("+sem")
        model = make_model(family.split("+")[0], ModelConfig(
            dim=W.DIM, entity_pad=8, semantic_dim=W.SEM_DIM if sem else 0))
        cfg = TrainConfig(batch_size=W.B, n_negatives=W.NEG, b_max=64, prefetch=0,
                          adam=AdamConfig(lr=1e-3), seed=0)
        cache = SemanticCache(W.h_sem(), W.BUDGET) if sem else None
        tr = NGDBTrainer(model, kg, cfg, semantic_cache=cache)
        carried[family] = {k: np.asarray(v) for k, v in tr.params.items()}
        ref[family] = np.array([r["loss"] for r in tr.train(W.STEPS, log_every=0,
                                                            batches=batches)])
    with open(os.path.join(directory, "arrays.pkl"), "wb") as f:
        pickle.dump(carried, f)
    return ref


_PSUM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.lm.moe import shard_map
from repro.training.compression import compressed_psum
g = np.stack([np.random.default_rng(r).normal(size=64).astype(np.float32) for r in range(4)])
e = np.stack([np.random.default_rng(10 + r).normal(scale=0.01, size=64).astype(np.float32)
              for r in range(4)])
mesh = jax.make_mesh((4,), ("x",))
f = shard_map(lambda g, e: tuple(a[None] for a in compressed_psum(g[0], "x", e[0])), mesh,
              in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x")))
out, err = f(jnp.asarray(g), jnp.asarray(e))
np.save(sys.argv[1], np.stack([np.asarray(out), np.asarray(err)]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    # The 4-rank spawn needs the carried parameters, so the reference
    # trains first; the reference's compressed_psum runs beside the spawn.
    ref = _reference(d)
    psum = subprocess.Popen([sys.executable, "-c", _PSUM, os.path.join(d, "psum.npy")],
                            cwd=ROOT)
    _join(_spawn(4, d), 4)           # writes the checkpoint world 2 restores
    pcs = {w: _spawn(w, d) for w in (2, 1)}
    for w, pc in pcs.items():
        _join(pc, w)
    assert psum.wait(timeout=SPAWN_TIMEOUT_S) == 0
    out = {}
    for w in (1, 2, 4):
        for r in range(w):
            with open(os.path.join(d, f"w{w}.r{r}.pkl"), "rb") as f:
                out[w, r] = pickle.load(f)
    return ref, out, np.load(os.path.join(d, "psum.npy")), d


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("family", W.FAMILIES)
def test_mesh_losses_match_reference(runs, world, family):
    """Every rank's losses, sync and pipelined, fsdp and 2d, within 1e-3 of
    the reference's single-device run; the ranks agree bitwise."""
    ref, out, _, _ = runs
    for spec, profile in W.MESHES[world]:
        for pipeline in (False, True):
            got = [out[world, r]["losses"][spec, profile, family, pipeline]
                   for r in range(world)]
            assert all(g == got[0] for g in got)
            assert np.abs(np.array(got[0]) - ref[family]).max() < 1e-3, (
                spec, profile, pipeline, got[0], ref[family])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_query_level_mesh_losses_match_reference(runs, world):
    """The query-level baseline under a mesh (each rank's pattern groups,
    their gradients scaled by local/global rows): the same mean loss as the
    reference's pooled run within 1e-3, bitwise the port's single-device
    query-level run at one rank."""
    ref, out, _, _ = runs
    for spec, profile in W.MESHES[world]:
        got = [out[world, r]["losses"][spec, profile, "gqe query_level", False]
               for r in range(world)]
        assert all(g == got[0] for g in got)
        assert np.abs(np.array(got[0]) - ref["gqe"]).max() < 1e-3
        if world == 1:
            assert got[0] == out[1, 0]["losses"]["single", "gqe query_level", False]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_one_step_moments_and_params_match_single_device(runs, world):
    """What the trainer's own update wrote after one step, on every rank,
    fsdp and 2d, against a single-device step on the same batch: the Adam
    ``m`` shards norm-wise within 1e-3 (BetaE) or 1e-4 of its, the ``v``
    shards within twice that (v goes with the square of the gradient), the
    parameter shards within one flipped step (2 lr), and names with an
    exact-zero gradient still rounding. ``m`` is 0.1 of the reduced gradient
    and ``v`` 1e-3 of its square, so a skipped all-reduce or a wrong
    local/global factor moves them by O(1). Bitwise where no axis splits
    the batch (one rank, or 2d over model alone)."""
    _, out, _, _ = runs
    for spec, profile in W.MESHES[world]:
        for family in W.FAMILIES:
            tol = 1e-3 if family == "betae" else 1e-4
            limits = {"m": tol, "v": 2 * tol, "params": 2.001, "rounding": 1.0}
            for r in range(world):
                gaps = out[world, r]["step1"][spec, profile, family]
                assert {k for _, k in gaps} >= {"entity"}
                for (part, k), gap in gaps.items():
                    assert gap <= limits[part], (spec, profile, family, r, part, k, gap)
                    if "data=1" in spec and part != "rounding":
                        assert gap == 0.0, (spec, profile, family, r, part, k, gap)


@pytest.mark.parametrize("family", W.FAMILIES)
def test_one_rank_is_bitwise_the_single_device_run(runs, family):
    _, out, _, _ = runs
    o = out[1, 0]
    for pipeline in (False, True):
        want = o["losses"]["single", family, pipeline]
        for spec, profile in W.MESHES[1]:
            assert o["losses"][spec, profile, family, pipeline] == want


@pytest.mark.parametrize("world", [2, 4])
def test_entity_table_is_one_nth_a_rank(runs, world):
    """Under fsdp (the entity table's E x dim reaches 65,536 elements) and
    under 2d with a model axis, each rank holds E/N rows, or E/model; 2d over
    data alone keeps it whole (its rule splits rows over model only)."""
    _, out, _, _ = runs
    for (spec, profile) in W.MESHES[world]:
        model_ways = int(dict(p.split("=") for p in spec.split(",")).get("model", 1))
        want = W.E // (world if profile == "fsdp" else model_ways)
        for family in ("gqe", "gqe+sem"):
            for r in range(world):
                assert out[world, r]["local_rows"][spec, profile, family] == (want, W.DIM)
        assert out[world, 0]["counts"][spec, profile]["staged"] == 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_per_query_losses_in_global_order(runs, world):
    """After one step every rank holds the same per-query losses, in the
    global batch's canonical order: those of a single-device step on the
    same batch and parameters."""
    from repro_torch.training import NGDBTrainer  # noqa: F401

    _, out, _, d = runs
    with open(os.path.join(d, "arrays.pkl"), "rb") as f:
        carried = pickle.load(f)
    kg, batches = W.graph_and_batches()
    tr = W.make_trainer(kg, "gqe", None, False, carried["gqe"])
    queries, pos, neg = tr.sampler.to_training_arrays(batches[0], W.NEG)
    plan = tr.executor.prepare(queries)
    _, want, _ = tr.loss_and_grads(plan, pos[plan.order], neg[plan.order])
    got = [out[world, r]["per_q"] for r in range(world)]
    assert all(np.array_equal(g, got[0]) for g in got)
    np.testing.assert_allclose(got[0], want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_adaptive_distribution_identical_on_every_rank(runs, world):
    _, out, _, _ = runs
    for pipeline in (False, True):
        got = [out[world, r]["adaptive", pipeline] for r in range(world)]
        assert all(g == got[0] for g in got)
        assert any(v != 1.0 for v in got[0][0].values())


def test_elastic_restore_four_to_two_ranks(runs):
    """A checkpoint the 4-rank run wrote comes back on 2 ranks: values,
    moments and step bitwise, each rank holding this mesh's shard."""
    _, out, _, _ = runs
    saved = out[4, 0]["saved"]
    for r in range(2):
        o = out[2, r]
        assert o["resumed"] and o["restored_step"] == W.STEPS
        full = o["restored_full"]
        for part in ("m", "v"):
            for k, v in saved["opt"][part].items():
                np.testing.assert_array_equal(full["opt"][part][k], v)
        np.testing.assert_array_equal(full["opt"]["step"], saved["opt"]["step"])
        for k, v in saved["params"].items():
            np.testing.assert_array_equal(full["params"][k], v)
        ent = o["restored_local"]["params"]["entity"]
        rows = W.E // 2
        np.testing.assert_array_equal(ent, saved["params"]["entity"][r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(o["restored_local"]["opt"]["m"]["entity"],
                                      saved["opt"]["m"]["entity"][r * rows:(r + 1) * rows])


def test_compressed_psum_matches_reference_on_four_ranks(runs):
    _, out, ref, _ = runs
    for r in range(4):
        got_out, got_err = out[4, r]["psum"]
        np.testing.assert_array_equal(got_out, ref[0][r])
        np.testing.assert_array_equal(got_err, ref[1][r])


def test_gpipe_on_two_ranks_matches_the_sequential_loop(runs):
    _, out, _, _ = runs
    w, b, x, _ = out[2, 0]["gpipe"]
    want = np.tanh(np.tanh(x @ w[0] + b[0]) @ w[1] + b[1])
    for r in range(2):
        np.testing.assert_allclose(out[2, r]["gpipe"][3], want, rtol=1e-5, atol=1e-5)
        assert out[2, r]["gpipe_staged"] == 0   # CPU tensors: nothing to stage


def test_train_cli_mesh_data2_on_two_ranks(runs):
    """``launch.train --device cpu --mesh data=2`` in a 2-rank group: rank 0
    prints the context, entity-table, loss and eval lines; rank 1 none."""
    _, out, _, _ = runs
    text = out[2, 0]["cli"]
    assert "execution context: mesh(data=2, model=1) profile=fsdp (2 devices, dp=2)" in text
    assert "entity table:" in text and "MB/device" in text
    assert sum(l.startswith("step ") for l in text.splitlines()) == 2
    assert "eval: " in text
    assert "step " not in out[2, 1]["cli"] and "eval: " not in out[2, 1]["cli"]
