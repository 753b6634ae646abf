"""The live tier under a mesh on the CPU: gloo ranks spawned under a file
rendezvous (``tests/torch_mesh_live_worker.py``), held to the port's
single-device live tier and to the JAX package's ``ServingEngine(ctx=,
kg=)`` with ``LiveNGDB`` on 4 emulated XLA devices in a subprocess.

* one rank (fsdp and 2d), GQE and BetaE: the deterministic write script
  (batches between writes, pinned requests, a write that grows 8 entities,
  flushed fine-tunes) bitwise the single-device script: answers, every
  published params set, graph versions, stale sheds, mat-cache counters;
* two and four ranks: every rank bitwise equal; answers within rtol 1e-4,
  atol 1e-4·d of single-device (top-k ids by the gap rule), params within
  ``test_torch_live.py``'s fine-tune tolerance, each rank holding its block
  of the grown table; a synchronous mesh ``incremental_finetune`` within
  that tolerance of the reference's;
* four ranks against the reference's mesh engine through the write that adds
  no entity (grown rows come from different RNGs, so no further);
* two ranks: a writer thread under a closed loop (every request served or
  shed, both ranks' final params equal, ``follow()`` ending), the replica
  tier's hot swap, and the serving CLI with live writes;
* a follower's own error in a write, a fine-tune or a swap: counted, written
  to stderr and raised out of ``follow()``; the CLI's refusals under a mesh.

The spawns run once for the module (4 ranks beside the reference, then 2
and 1 together), each with a time limit."""
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

import torch_mesh_live_worker as W

SPAWN_TIMEOUT_S = 150
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_MESHES = (("data=4", "fsdp"), ("data=2,model=2", "2d"))
TOL = dict(rtol=1e-4, atol=1e-4 * W.DIM + 1e-3)   # scoring's, plus the 3-place rounding
FT_RTOL = {"gqe": 1e-4, "betae": 1e-3}             # tests/test_torch_live.py's


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


def _carried(directory):
    """The JAX package's initial parameters of each family and the write
    bursts, for every rank and the oracle."""
    from repro.models import ModelConfig, make_model

    carried = {"bursts": W.bursts(W.graph())}
    for family in W.FAMILIES:
        model = make_model(family, ModelConfig(dim=W.DIM, entity_pad=W.PAD))
        params = model.init_params(jax.random.PRNGKey(0), W.E, W.R)
        carried[family] = {k: np.asarray(v) for k, v in params.items()}
    with open(os.path.join(directory, "arrays.pkl"), "wb") as f:
        pickle.dump(carried, f)
    return carried


_ORACLE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import jax, numpy as np
import torch_mesh_live_worker as W
from repro.core import PooledExecutor
from repro.data import generate_synthetic_kg
from repro.distributed.context import make_execution_context
from repro.models import ModelConfig, make_model
from repro.serving import LiveNGDB, ServingConfig, ServingEngine, make_workload
d, meshes = sys.argv[1], eval(sys.argv[2])
with open(os.path.join(d, "arrays.pkl"), "rb") as f:
    carried = pickle.load(f)
out = {}
for spec, profile in meshes:
    ctx = make_execution_context(spec, profile=profile)
    for family in W.FAMILIES:
        kg = generate_synthetic_kg(W.E, W.R, W.TRIPLES, seed=0)
        qs = make_workload(kg, W.N_QUERIES, seed=7)
        model = make_model(family, ModelConfig(dim=W.DIM, entity_pad=W.PAD))
        params = model.init_params(jax.random.PRNGKey(0), W.E, W.R, ctx=ctx)
        params = {**params, **{k: ctx.put_param(k, v) for k, v in carried[family].items()}}
        cfg = ServingConfig(max_batch=W.MAX_BATCH, max_wait_ms=2000.0, top_k=W.TOP_K,
                            max_staleness_versions=W.STALENESS)
        eng = ServingEngine(model, params, executor=PooledExecutor(model, b_max=64, ctx=ctx),
                            cfg=cfg, kg=kg, ctx=ctx)
        live = LiveNGDB(model, kg, eng, finetune_steps=W.FT_STEPS, n_negatives=8,
                        seed=W.FT_SEED)
        v0 = kg.graph_version
        fs = eng.submit_many(qs[:32])
        answers = [f.result(timeout=300) for f in fs]
        live.flush()
        live.write(carried["bursts"]["A"])
        live.flush()
        fs = eng.submit_many(qs[32:48]) + [eng.submit(q, pin_version=v0) for q in qs[48:64]]
        answers += [f.result(timeout=300) for f in fs]
        live.close()
        eng.close()
        out[spec, profile, family] = [{k: r[k] for k in ("top_entities", "scores")}
                                      for r in answers]
with open(os.path.join(d, "oracle.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_live"))
    carried = _carried(d)
    oracle = subprocess.Popen([sys.executable, "-c", _ORACLE, d, repr(ORACLE_MESHES)],
                              cwd=ROOT, stderr=subprocess.PIPE, text=True)
    _join(_spawn(4, d), 4)
    pcs = {w: _spawn(w, d) for w in (2, 1)}
    for w, pc in pcs.items():
        _join(pc, w)
    try:
        _, err = oracle.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        oracle.kill()
        pytest.fail("the reference's mesh live tier did not finish")
    assert oracle.returncode == 0, err[-3000:]
    out = {}
    for w in (1, 2, 4):
        for r in range(w):
            with open(os.path.join(d, f"w{w}.r{r}.pkl"), "rb") as f:
                out[w, r] = pickle.load(f)
    with open(os.path.join(d, "oracle.pkl"), "rb") as f:
        ref = pickle.load(f)
    return out, ref, carried


def _answers_agree(got, want, atol=TOL["atol"], rtol=TOL["rtol"]):
    """``got`` and ``want`` (answers, or "stale") agree: the same sheds,
    scores within the tolerance at each position, top-k ids equal up to
    every position after which ``want``'s scores drop by more than it."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w == "stale" or g == "stale":
            assert g == w
            continue
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=rtol, atol=atol)
        s = w["scores"]
        for j in range(len(s) - 1):
            if s[j] - s[j + 1] > atol + rtol * abs(s[j]):
                assert set(g["top_entities"][:j + 1]) == set(w["top_entities"][:j + 1])


@pytest.mark.parametrize("family", W.FAMILIES)
def test_one_rank_is_bitwise_the_single_device_live_tier(runs, family):
    out, _, _ = runs
    o = out[1, 0]["script"]
    want = o["single", family]
    assert want["answers"].count("stale") == 16 and want["finetunes"] == 3
    for spec, profile in W.MESHES[1]:
        got = o[spec, profile, family]
        assert got["answers"] == want["answers"]
        assert got["versions"] == want["versions"] and got["stats"] == want["stats"]
        assert got["n_entities"] == want["n_entities"] == (W.E + W.N_NEW,) * 2
        assert len(got["params"]) == len(want["params"]) == 4   # growth + 3 fine-tunes
        for p, q in zip(got["params"], want["params"]):
            assert p.keys() == q.keys()
            for k in p:
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", W.FAMILIES)
def test_ranks_agree_bitwise(runs, world, family):
    out, _, _ = runs
    for spec, profile in W.MESHES[world]:
        key = spec, profile, family
        r0 = out[world, 0]["script"][key]
        assert r0["answers"].count("stale") == 16 and r0["finetunes"] == 3
        for r in range(1, world):
            o = out[world, r]["script"][key]
            assert o["digest"] == r0["digest"] and o["finetunes"] == 3
            # Rank 0 sheds stale pins before announcing: no other rank sees them.
            assert o["stats"] == {**r0["stats"], "stale_sheds": 0}
            assert o["versions"] == [] and o["n_entities"] == r0["n_entities"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", W.FAMILIES)
def test_within_tolerance_of_single_device(runs, world, family):
    """Answers at the scoring tolerance (the sheds identical); every
    published params set within the fine-tune tolerance of single-device's,
    ``FT_STEPS`` more Adam steps of allowance after each fine-tune."""
    out, _, _ = runs
    want = out[1, 0]["script"]["single", family]
    rtol = FT_RTOL[family]
    for spec, profile in W.MESHES[world]:
        got = out[world, 0]["script"][spec, profile, family]
        _answers_agree(got["answers"], want["answers"])
        assert got["versions"] == want["versions"]
        assert got["stats"]["stale_sheds"] == want["stats"]["stale_sheds"]
        steps = 0
        for i, (p, q) in enumerate(zip(got["params"], want["params"])):
            steps += W.FT_STEPS if i != 1 else 0     # the second set is the growth's
            for k in q:
                np.testing.assert_allclose(p[k], q[k], rtol=rtol,
                                           atol=rtol * 1e-2 * max(steps, 1), err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_block_of_the_grown_table(runs, world):
    """After growing 2,048 rows by 8: fsdp 1/world of the 2,056 rows a rank,
    2d 1/model; the re-block gathered the old table (its bytes counted)."""
    out, _, _ = runs
    for spec, profile in W.MESHES[world]:
        ways = world if profile == "fsdp" else int(dict(
            p.split("=") for p in spec.split(","))["model"])
        for family in W.FAMILIES:
            for r in range(world):
                o = out[world, r]["script"][spec, profile, family]
                assert o["full"] == (W.E + W.N_NEW, W.DIM)
                assert o["block"] == ((W.E + W.N_NEW) // ways, W.DIM) and o["own_block"]
                assert o["reblock_bytes"] == [W.E * W.DIM * 4]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", W.FAMILIES)
def test_mesh_incremental_finetune_matches_reference(runs, world, family):
    import repro.training.loop as jloop
    from repro.models import ModelConfig, make_model

    out, _, carried = runs
    model = make_model(family, ModelConfig(dim=W.DIM, entity_pad=W.PAD))
    model.init_params(jax.random.PRNGKey(0), W.E, W.R)
    want, jl = jloop.incremental_finetune(model, carried[family], carried["bursts"]["sync"],
                                          steps=W.SYNC_STEPS, lr=W.SYNC_LR, seed=W.SYNC_SEED)
    rtol = FT_RTOL[family]
    for spec, profile in W.MESHES[world]:
        got = out[world, 0]["sync"][spec, profile, family]
        np.testing.assert_allclose(got["losses"], jl, rtol=rtol)
        assert set(got["params"]) == set(want)
        for k in want:
            np.testing.assert_allclose(got["params"][k], np.asarray(want[k]), rtol=rtol,
                                       atol=rtol * 1e-2 * W.SYNC_STEPS, err_msg=k)
        for r in range(1, world):
            o = out[world, r]["sync"][spec, profile, family]
            assert o["losses"] == got["losses"]
            for k in want:
                np.testing.assert_array_equal(o["params"][k], got["params"][k])


@pytest.mark.parametrize("family", W.FAMILIES)
def test_within_tolerance_of_the_reference_before_growth(runs, family):
    """Four ranks against the reference's mesh engine and LiveNGDB on 4
    emulated devices: the 64 requests served before and after write A (the
    pinned ones on the version before it)."""
    out, ref, _ = runs
    for spec, profile in ORACLE_MESHES:
        got = out[4, 0]["script"][spec, profile, family]["answers"][:64]
        _answers_agree(got, ref[spec, profile, family])


def test_concurrent_writer_on_two_ranks(runs):
    r0, r1 = runs[0][2, 0]["concurrent"], runs[0][2, 1]["concurrent"]
    assert r0["served"] + r0["shed"] == r0["n"] and r0["served"] > 0
    assert r0["failures"] == r1["failures"] == 0
    assert r0["finetunes"] == r1["finetunes"] == 3
    assert r1["followed"] > 0 and r0["final"] == r1["final"]


def test_replica_tier_swap_on_two_ranks(runs):
    """On each rank: batches of the first half ran on the old params, of the
    second on the new, each bitwise ``serve_batch`` on its params; the ranks'
    batches bitwise equal."""
    t0, t1 = runs[0][2, 0]["tier"], runs[0][2, 1]["tier"]
    assert t0["digest"] == t1["digest"]
    for t in (t0, t1):
        assert {pv for _, pv, _, _ in t["batches"]} == {0, 1}
        for _rid, pv, half, replayed in t["batches"]:
            assert replayed
            assert half != ("second" if pv == 0 else "first")


def test_serve_cli_live_writes_under_a_mesh(runs):
    text = runs[0][2, 0]["cli"]
    assert "execution context: mesh(data=2, model=1) profile=fsdp (2 devices, dp=2)" in text
    assert "live writes: 2 bursts" in text and "2 background fine-tunes" in text
    assert "mesh lane: median hold ms" in text and "live graph: version" in text
    assert runs[0][2, 1]["cli"] == ""


@pytest.mark.parametrize("flags", [["--replicas", "2", "--live-writes", "1"],
                                   ["--tenants", "a:high", "--max-staleness", "1"],
                                   ["--semantic-store", "/nonexistent", "--live-writes", "1"]])
def test_serve_cli_refuses_what_the_reference_refuses_under_a_mesh(flags, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--reduced", "--device", "cpu", "--mesh", "data=1"] + flags)
    assert "do not compose" in capsys.readouterr().err


@pytest.fixture
def one_rank(tmp_path):
    """An engine (not started) and a LiveNGDB on a one-rank gloo mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import make_execution_context
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import LiveNGDB, ServingEngine

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    ctx = make_execution_context("data=1", profile="fsdp", device="cpu")
    kg = W.graph()
    model = make_model("gqe", ModelConfig(dim=8, entity_pad=8), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations, ctx=ctx)
    eng = ServingEngine(model, params, device="cpu", ctx=ctx, kg=kg, started=False)
    eng.SWAP_WAIT_S = 0.2
    live = LiveNGDB(model, kg, eng, finetune_steps=1)
    yield eng, live
    live.close(flush=False)
    eng.close()
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["write", "finetune", "swap"])
def test_a_follower_raises_its_own_write_finetune_or_swap_error(one_rank, kind, capsys):
    eng, live = one_rank

    def fault(*a, **k):
        raise RuntimeError("a device fault on this rank")

    live._apply_write = fault
    live._finetune = fault
    payload = {"write": (np.array([[0, 0, 1]]), 0, None), "finetune": (5, 0), "swap": 1}[kind]
    with pytest.raises((RuntimeError, KeyError, TimeoutError)) as ei:
        eng._on_lane(kind, payload)
    if kind == "swap":
        assert "swap 1" in str(ei.value)
    assert eng.stats()["failures"] == 1
    assert f"a {kind} failed on this rank" in capsys.readouterr().err
