"""Serving under a mesh on the CPU: gloo ranks spawned under a file
rendezvous (``tests/torch_mesh_serving_worker.py``), held to the port's
single-device engine and to the JAX package's ``ServingEngine(ctx=)`` run on
4 emulated XLA devices in a subprocess (the reference has no mesh-serving
test of its own).

* one rank (fsdp and 2d): scores, engine answers and their ``serve_batch``
  replay bitwise the single-device engine's, zero retraces on replay;
* two and four ranks: every rank's scores and answers bitwise equal, within
  the scoring tolerance (rtol 1e-4, atol 1e-4·d) of the single-device engine
  and of the reference's; top-k ids equal wherever the gap after a position
  exceeds that tolerance;
* BetaE, GQE and GQE+H_sem through the hot set, one engine; BetaE and GQE
  for ``--replicas 2`` (the hot set is single-engine, as single-device);
* each rank's entity shard: 1/N of the rows under fsdp, 1/model under 2d;
* a malformed query among good ones on two ranks: it fails alone, and both
  ranks count the one failure; a follower's error of its own is raised;
* the CLI with ``--mesh data=2`` on two ranks.

The spawns run once for the module (4 ranks beside the reference, then 2
and 1 together), each with a time limit."""
import os
import pickle
import subprocess
import sys
import time

import jax  # noqa: F401  (on the CPU, before the JAX package's modules)
import numpy as np
import pytest

import torch_mesh_serving_worker as W

SPAWN_TIMEOUT_S = 150
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_MESHES = (("data=4", "fsdp"), ("data=2,model=2", "2d"))
TOL = dict(rtol=1e-4, atol=1e-4 * W.DIM)   # scoring's (tests/test_kernels.py:18-19)


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
    """The JAX package's initial parameters of each family, carried to every
    rank and to the oracle."""
    from repro.models import ModelConfig, make_model
    from repro.semantic import SemanticCache

    carried = {}
    for family in W.FAMILIES + W.TIER_FAMILIES:
        sem = family.endswith("+sem")
        model = make_model(family.split("+")[0], ModelConfig(
            dim=W.DIM, entity_pad=8, semantic_dim=W.SEM_DIM if "+" in family else 0))
        cache = SemanticCache(W.h_sem(), W.BUDGET) if sem else None
        params = model.init_params(jax.random.PRNGKey(0), W.E, W.R, semantic_cache=cache,
                                   semantic_table=W.h_sem() if family.endswith("+res")
                                   else None)
        carried[family] = {k: np.asarray(v) for k, v in params.items()
                           if k not in ("sem_cache", "sem_slot")}
    with open(os.path.join(directory, "arrays.pkl"), "wb") as f:
        pickle.dump(carried, f)


_ORACLE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import jax, numpy as np
import torch_mesh_serving_worker as W
from repro.core import PooledExecutor
from repro.data import generate_synthetic_kg
from repro.distributed.context import make_execution_context
from repro.models import ModelConfig, make_model
from repro.semantic import SemanticCache
from repro.serving import ServingConfig, ServingEngine, make_workload, pad_to_bucket, scorer_for
d, meshes = sys.argv[1], eval(sys.argv[2])
with open(os.path.join(d, "arrays.pkl"), "rb") as f:
    carried = pickle.load(f)
kg = generate_synthetic_kg(W.E, W.R, W.TRIPLES, seed=0)
qs = make_workload(kg, W.N_REQ, seed=7)
comps = [pad_to_bucket(qs[i:i + W.MAX_BATCH])[0] for i in range(0, len(qs), W.MAX_BATCH)]
out = {"keys": [[q.key() for q in c] for c in comps]}
for spec, profile in meshes:
    ctx = make_execution_context(spec, profile=profile)
    for family in W.FAMILIES:
        sem = family.endswith("+sem")
        model = make_model(family.split("+")[0], ModelConfig(
            dim=W.DIM, entity_pad=8, semantic_dim=W.SEM_DIM if sem else 0))
        cache = SemanticCache(W.h_sem(), W.BUDGET, ctx=ctx) if sem else None
        params = model.init_params(jax.random.PRNGKey(0), W.E, W.R, semantic_cache=cache, ctx=ctx)
        params = {**params, **{k: ctx.put_param(k, v) for k, v in carried[family].items()}}
        ex = PooledExecutor(model, b_max=64, ctx=ctx)
        scores = []
        for c in comps:
            p = params
            if cache is not None:
                stage = cache.plan(np.concatenate([q.anchors for q in c]))
                if stage is not None:
                    params = p = cache.apply_to(params, stage)
            states = ex.encode(p, c, compiled=True)
            if cache is not None:
                scores.append(np.asarray(model.score_all_chunked(p, states, cache.store.read_rows)))
            else:
                scores.append(np.asarray(scorer_for(model, ctx)(p, states)))
        cfg = ServingConfig(max_batch=W.MAX_BATCH, max_wait_ms=1000.0, top_k=W.TOP_K)
        if cache is not None:
            cache = SemanticCache(W.h_sem(), W.BUDGET, ctx=ctx)
            params = model.init_params(jax.random.PRNGKey(0), W.E, W.R, semantic_cache=cache,
                                       ctx=ctx)
            params = {**params, **{k: ctx.put_param(k, v) for k, v in carried[family].items()}}
        eng = ServingEngine(model, params, executor=ex, cfg=cfg, sem_cache=cache,
                            sem_rows_fn=cache.store.read_rows if cache else None, ctx=ctx)
        answers = {q.key(): f.result(timeout=300)["top_entities"]
                   for q, f in zip(qs, eng.submit_many(qs))}
        eng.close()
        out[spec, profile, family] = (scores, answers)
with open(os.path.join(d, "oracle.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_serving"))
    _carried(d)
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
        pytest.fail("the reference's mesh engine did not finish")
    assert oracle.returncode == 0, err[-3000:]
    out = {}
    for w in (1, 2, 4):
        for r in range(w):
            with open(os.path.join(d, f"w{w}.r{r}.pkl"), "rb") as f:
                out[w, r] = pickle.load(f)
    with open(os.path.join(d, "oracle.pkl"), "rb") as f:
        ref = pickle.load(f)
    return out, ref


def _topk_agree(ids, want_ids, scores, k=W.TOP_K):
    """``ids`` and ``want_ids`` (top-k lists) name the same entities up to
    every position after which ``scores`` (the row both were taken from, or
    its twin) drops by more than the tolerance."""
    order = np.sort(scores)[::-1]
    for j in range(k):
        gap = order[j] - order[j + 1]
        if gap > TOL["atol"] + TOL["rtol"] * abs(order[j]):
            assert set(ids[:j + 1]) == set(want_ids[:j + 1]), (j, ids, want_ids)


def _rows(out, key):
    """{query key: raw score row} of one run's fixed compositions."""
    from repro_torch.serving import make_workload  # noqa: F401

    kg = W.graph()
    comps = W.compositions(W.workload(kg))
    rows = {}
    for c, s in zip(comps, out["scores"][key]):
        for i, q in enumerate(c):
            rows.setdefault(q.key(), s[i])
    return rows


@pytest.mark.parametrize("family", W.FAMILIES)
def test_one_rank_is_bitwise_the_single_device_engine(runs, family):
    out, _ = runs
    o = out[1, 0]
    for spec, profile in W.MESHES[1]:
        key = spec, profile, family
        for got, want in zip(o["scores"][key], o["scores"]["single", family]):
            np.testing.assert_array_equal(got, want)
        assert o["engine"][key] == o["engine"]["single", family]
        assert o["retraces"][key] == 0 and o["retraces"]["single", family] == 0
        # The engine's answers are serve_batch's on its own compositions.
        assert [[r for r in log[2]] for log in o["engine"][key]] == o["replay"][key]
        if family in W.TIER_FAMILIES:
            assert o["tier"][spec, profile, family] == o["tier"]["single", family]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", W.FAMILIES)
def test_ranks_agree_bitwise(runs, world, family):
    """Every rank holds the same scores and answers, for one engine and for
    each replica of ``--replicas 2``; the engine answers as ``serve_batch``
    does on its compositions."""
    out, _ = runs
    for spec, profile in W.MESHES[world]:
        key = spec, profile, family
        for r in range(1, world):
            for got, want in zip(out[world, r]["scores"][key], out[world, 0]["scores"][key]):
                np.testing.assert_array_equal(got, want)
            assert out[world, r]["engine"][key] == out[world, 0]["engine"][key]
            assert out[world, r]["replay"][key] == out[world, 0]["replay"][key]
            if family in W.TIER_FAMILIES:
                assert out[world, r]["tier"][key] == out[world, 0]["tier"][key]
        assert ([log[2] for log in out[world, 0]["engine"][key]]
                == out[world, 0]["replay"][key])
        if family in W.TIER_FAMILIES:
            logs = out[world, 0]["tier"][key]
            assert sum(len(rec[2]) for log in logs.values() for rec in log) > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", W.FAMILIES)
def test_within_tolerance_of_single_device_and_reference(runs, world, family):
    """The mesh's raw scores within rtol 1e-4, atol 1e-4·d of the
    single-device engine's (and, at four ranks, of the reference's engine on
    4 emulated devices); its engine's top-k ids equal theirs up to every
    position followed by a gap wider than that."""
    out, ref = runs
    single = _rows(out[1, 0], ("single", family))
    single_answers = {}
    for log in out[1, 0]["engine"]["single", family]:
        for key, res in zip(log[0], log[2]):
            single_answers[key] = res["top_entities"]
    for spec, profile in W.MESHES[world]:
        key = spec, profile, family
        for got, want in zip(out[world, 0]["scores"][key], out[1, 0]["scores"]["single", family]):
            np.testing.assert_allclose(got, want, **TOL)
        if (spec, profile) in ORACLE_MESHES:
            for got, want in zip(out[world, 0]["scores"][key], ref[key][0]):
                np.testing.assert_allclose(got, want, **TOL)
        for log in out[world, 0]["engine"][key]:
            for qkey, res in zip(log[0], log[2]):
                _topk_agree(res["top_entities"], single_answers[qkey], single[qkey])
                if (spec, profile) in ORACLE_MESHES:
                    _topk_agree(res["top_entities"], ref[key][1][qkey], single[qkey])


@pytest.mark.parametrize("world", [2, 4])
def test_no_rank_holds_the_whole_entity_table(runs, world):
    """fsdp splits the rows over every rank (E x dim reaches 65,536), 2d
    over the model axis; the collectives stayed unstaged on the CPU."""
    out, _ = runs
    for spec, profile in W.MESHES[world]:
        ways = world if profile == "fsdp" else int(dict(
            p.split("=") for p in spec.split(","))["model"])
        assert ways > 1
        for family in W.FAMILIES:
            for r in range(world):
                assert out[world, r]["shard"][spec, profile, family] == (W.E // ways, W.DIM)
        counts = out[world, 0]["counts"][spec, profile]
        assert counts["staged"] == 0 and counts["counts"]["all_gather"] > 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_resident_h_sem_replicas(runs, world):
    """GQE with H_sem resident behind ``--replicas 2``: the ranks' answers
    bitwise equal, one rank's bitwise single-device's, more ranks' scores at
    the same entities within the tolerance (plus the results' rounding to
    3 places) of single-device's."""
    out, _ = runs

    def answers(tier):
        return {k: r for log in tier.values() for rec in log for k, r in zip(rec[0], rec[2])}

    single = answers(out[1, 0]["tier"]["single", "gqe+res"])
    for spec, profile in W.MESHES[world]:
        key = spec, profile, "gqe+res"
        for r in range(1, world):
            assert out[world, r]["tier"][key] == out[world, 0]["tier"][key]
        got = answers(out[world, 0]["tier"][key])
        assert got.keys() == single.keys() and len(got) > 0
        if world == 1:
            assert got == single
        for q, res in got.items():
            np.testing.assert_allclose(res["scores"], single[q]["scores"], rtol=TOL["rtol"],
                                       atol=TOL["atol"] + 1e-3)


def test_serve_cli_mesh_data2_on_two_ranks(runs):
    out, _ = runs
    text = out[2, 0]["cli"]
    assert "execution context: mesh(data=2, model=1) profile=fsdp (2 devices, dp=2)" in text
    assert "entity table:" in text and "MB/device" in text
    assert "steady-state retraces" in text and "first: " in text
    assert out[2, 1]["cli"].splitlines() == [
        line for line in out[2, 1]["cli"].splitlines() if line.startswith("trace: wrote ")]
    for r in range(2):   # one trace a rank, each with its batches' spans
        assert f"serve.rank{r}.json" in out[2, r]["cli"]
        names = {e.get("name") for e in out[2, r]["cli_trace"]["traceEvents"]}
        assert {"encode", "score", "select"} <= names, sorted(n for n in names if n)


def test_a_malformed_query_fails_alone_on_every_rank(runs):
    """Rank 0 fails the malformed request alone and answers the others; the
    follower meets the same error on the same batches, counts the same one
    failure and goes on serving in step."""
    out, _ = runs
    got, failures, log = out[2, 0]["poison"]
    assert got[4] == "KeyError"
    assert all(isinstance(g, list) and len(g) == W.TOP_K for i, g in enumerate(got) if i != 4)
    assert failures == 1
    assert out[2, 1]["poison"][1:] == (failures, log)


def test_a_follower_raises_an_error_of_its_own(tmp_path):
    """On a follower a query's error is counted where rank 0 counts it and
    serving goes on; any other error is counted and raised."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import make_execution_context
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import ServingEngine

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    try:
        ctx = make_execution_context("data=1", profile="fsdp", device="cpu")
        kg = W.graph()
        model = make_model("gqe", ModelConfig(dim=8, entity_pad=8), device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                                   kg.n_relations, ctx=ctx)
        eng = ServingEngine(model, params, device="cpu", ctx=ctx, started=False)
        bad = ("no-such-pattern", np.array([1]), np.array([0]), 3)
        eng._follow("full", [bad, bad])      # rank 0 retries each alone
        assert eng.stats()["failures"] == 0
        eng._follow("retry", [bad])
        assert eng.stats()["failures"] == 1

        def fault(batch, flush):
            raise RuntimeError("a read error on this rank")

        eng._serve = fault
        with pytest.raises(RuntimeError, match="read error"):
            eng._follow("full", [bad, bad])
        assert eng.stats()["failures"] == 3
        eng.close()
    finally:
        dist.destroy_process_group()
