"""Serving a trained checkpoint, and the reference's last constructor
arguments, on the CPU.

* ``load_checkpoint``: the port's and the JAX package's on one checkpoint
  and the serving template ``{"params": ..., "opt": None}`` give the same
  leaves (``opt`` stays None); a leaf of the wrong shape raises
  ``ValueError``; entity rows differ by padding alone (surplus dropped,
  missing ones the template's, fewer rows than the graph's entities
  refused);
* ``launch.serve --ckpt-dir``: a checkpoint written by either package's
  training CLI, served by the JAX package's serving CLI and by the port's
  (BetaE, GQE, GQE+H_sem through the store at a hot-set budget below
  training's), gives the same top-k answers on the same requests (scores
  within the encode tolerance, rtol 2e-4 / atol 2e-5, BetaE's rtol 1e-4 /
  atol 1e-3, plus the 3-place rounding; ids equal except at near ties),
  and other answers than the random weights;
* two and four gloo ranks (``data=N`` fsdp, 2d) restore a single-device
  checkpoint of a 2,049-entity graph with its rows padded to the mesh
  (``tests/torch_ckpt_serve_worker.py``): each rank holds its block of the
  checkpoint's rows, the ranks' answers are bitwise equal and within the
  scoring tolerance (rtol 1e-4, atol 1e-4·d) of single-device; the CLI
  with ``--mesh data=2 --ckpt-dir``;
* ``PooledExecutor(plan_cache=, plan_cache_size=)``,
  ``Replica``/``ReplicaPool(plan_cache_size=)``,
  ``ServingEngine(latency_window=)``, ``NGDBTrainer.train(prefetcher=)`` and
  ``StubPTE.encode_entities`` against the reference;
* the drivers ``launch.e2e``, ``launch.semantic_fusion`` and
  ``launch.lm_zoo`` exit 0.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_ckpt_serve.py``."""
import os
import pickle
import sys
import time

import jax  # noqa: F401  (on the CPU, before the JAX package's modules)
import numpy as np
import pytest
import torch

import torch_ckpt_serve_worker as W
from torch_parity import BETAE_DISTANCE, ENCODE, carried_models, graphs, queries

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 150
ROUNDING = 5e-4                 # results carry scores rounded to 3 places
MESH_TOL = dict(rtol=1e-4, atol=1e-4 * W.DIM)   # scoring's (tests/test_kernels.py)
TRAIN = ["--dim", "16", "--batch-size", "16", "--negatives", "4", "--steps", "2",
         "--eval-queries", "8", "--log-every", "0"]
SERVE = ["--dim", "16", "--requests", "32", "--max-wait-ms", "1000"]


# --------------------------------------------------------- load_checkpoint
def _saved(tmp_path, params, step=3):
    from repro.training.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path), step, {"params": params})
    return str(tmp_path)


@pytest.mark.parametrize("name", ["betae", "gqe"])
def test_load_checkpoint_matches_reference_with_opt_none(name, tmp_path):
    from repro.training.checkpoint import load_checkpoint as j_load
    from repro_torch.training.checkpoint import load_checkpoint as t_load

    _, jp, tm, tp = carried_models(name)
    d = _saved(tmp_path, jp)
    jstep, jtree, _ = j_load(d, template={"params": jp, "opt": None})
    tstep, ttree, _ = t_load(d, template={"params": dict(tp), "opt": None})
    assert jstep == tstep == 3 and jtree["opt"] is None and ttree["opt"] is None
    assert set(ttree["params"]) == set(jtree["params"])
    for k, v in jtree["params"].items():
        np.testing.assert_array_equal(ttree["params"][k].numpy(), np.asarray(v))


def test_load_checkpoint_refuses_a_wrong_shape(tmp_path):
    from repro_torch.training.checkpoint import load_checkpoint

    _, jp, _, tp = carried_models("gqe")
    d = _saved(tmp_path, jp)
    wrong = {**tp, "relation": torch.zeros(tp["relation"].shape[0] + 1, tp["relation"].shape[1])}
    with pytest.raises(ValueError, match=r"'params/relation' has shape \(10, 16\); "
                                         r"the template wants \(11, 16\)"):
        load_checkpoint(d, template={"params": wrong}, n_entities=200)
    narrow = {**tp, "entity": torch.zeros(200, 8)}
    with pytest.raises(ValueError, match="params/entity"):
        load_checkpoint(d, template={"params": narrow}, n_entities=200)
    # Without the graph's entity count no row count is padding.
    padded = {**tp, "entity": torch.zeros(202, 16)}
    with pytest.raises(ValueError, match=r"\(200, 16\); the template wants \(202, 16\)"):
        load_checkpoint(d, template={"params": padded})


@pytest.mark.parametrize("ckpt_rows,template_rows", [(200, 203), (204, 201), (204, 200)])
def test_load_checkpoint_pads_and_trims_entity_rows(tmp_path, ckpt_rows, template_rows):
    """200 real entities: rows past them are padding, taken from the
    checkpoint where it has them and from the template where it does not;
    Adam's moments of ``entity`` follow the same rule."""
    from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(0)
    ent = rng.normal(size=(ckpt_rows, 4)).astype(np.float32)
    save_checkpoint(str(tmp_path), 1, {"params": {"entity": ent, "relation": ent[:3]},
                                       "opt": {"m": {"entity": ent * 2}}})
    tmpl = torch.from_numpy(rng.normal(size=(template_rows, 4)).astype(np.float32))
    _, tree, _ = load_checkpoint(str(tmp_path), n_entities=200, template={
        "params": {"entity": tmpl.clone(), "relation": torch.zeros(3, 4)},
        "opt": {"m": {"entity": tmpl.clone()}}})
    n = min(ckpt_rows, template_rows)
    for got, src in ((tree["params"]["entity"], ent), (tree["opt"]["m"]["entity"], ent * 2)):
        assert got.shape == (template_rows, 4)
        np.testing.assert_array_equal(got[:n].numpy(), src[:n])
        torch.testing.assert_close(got[n:], tmpl[n:], rtol=0, atol=0)


def test_load_checkpoint_refuses_fewer_rows_than_entities(tmp_path):
    from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

    save_checkpoint(str(tmp_path), 1, {"params": {"entity": np.zeros((199, 4), np.float32)}})
    with pytest.raises(ValueError, match="199 entity rows, fewer than the graph's 200"):
        load_checkpoint(str(tmp_path), template={"params": {"entity": torch.zeros(200, 4)}},
                        n_entities=200)


# ------------------------------------------------- launch.serve --ckpt-dir
def _capture(monkeypatch, module):
    """Every ``run_closed_loop`` report of ``module``'s CLI (the last one
    is the timed pass)."""
    reports = []
    real = module.run_closed_loop

    def run(*a, **k):
        reports.append(real(*a, **k))
        return reports[-1]

    monkeypatch.setattr(module, "run_closed_loop", run)
    return reports


def _jax_cli(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()
    return capsys.readouterr().out


def _serve_both(argv, monkeypatch, capsys):
    """(JAX CLI's answers, port CLI's answers, both outputs) on ``argv``."""
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    jrep = _capture(monkeypatch, j_serve)
    jout = _jax_cli(j_serve, argv, monkeypatch, capsys)
    trep = _capture(monkeypatch, t_serve)
    t_serve.main(argv + ["--reduced", "--device", "cpu"])
    tout = capsys.readouterr().out
    return jrep[-1].results, trep[-1].results, jout, tout


def _assert_answers_agree(got, want, tol):
    """Same requests, scores within ``tol`` plus the rounding, ids equal
    except where the reference's neighbouring scores tie within it."""
    slack = tol["atol"] + ROUNDING
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["pattern"], g["anchors"], g["relations"]) == (
            w["pattern"], w["anchors"], w["relations"])
        ws = np.asarray(w["scores"])
        np.testing.assert_allclose(g["scores"], ws, rtol=tol["rtol"], atol=slack)
        for j, (a, b) in enumerate(zip(g["top_entities"], w["top_entities"])):
            if a != b:
                near = [abs(ws[j] - ws[i]) for i in (j - 1, j + 1) if 0 <= i < len(ws)]
                assert j == len(ws) - 1 or min(near) <= 2 * slack + tol["rtol"] * abs(ws[j]), (
                    j, g["top_entities"], w["top_entities"], ws)


@pytest.mark.parametrize("case", ["betae", "gqe", "gqe+store", "port-trained"])
def test_serve_cli_serves_a_trained_checkpoint_as_the_reference(case, tmp_path, monkeypatch,
                                                                capsys):
    from repro.launch import train as j_train
    from repro_torch.launch import serve as t_serve
    from repro_torch.launch.train import main as t_train

    ck = str(tmp_path / "ck")
    model = "betae" if case == "betae" else "gqe"
    sem = []
    if case == "gqe+store":
        store = str(tmp_path / "store")
        _jax_cli(j_train, ["--model", "gqe", "--semantic-store", store, "--semantic-dim", "16",
                           "--semantic-budget-rows", "256", "--ckpt-dir", ck] + TRAIN,
                 monkeypatch, capsys)
        # Serving stages through a smaller hot set than training's.
        sem = ["--semantic-store", store, "--semantic-budget-rows", "128"]
    elif case == "port-trained":
        t_train(["--reduced", "--device", "cpu", "--model", model, "--ckpt-dir", ck] + TRAIN)
        capsys.readouterr()
    else:
        _jax_cli(j_train, ["--model", model, "--ckpt-dir", ck] + TRAIN, monkeypatch, capsys)
    argv = ["--model", model, "--ckpt-dir", ck] + SERVE + sem
    want, got, jout, tout = _serve_both(argv, monkeypatch, capsys)
    assert "loaded checkpoint step=2" in jout and "loaded checkpoint step=2" in tout
    _assert_answers_agree(got, want, BETAE_DISTANCE if model == "betae" else ENCODE)
    # The random weights answer otherwise: the checkpoint was loaded.
    rand = _capture(monkeypatch, t_serve)
    t_serve.main(["--model", model] + SERVE + sem + ["--reduced", "--device", "cpu"])
    assert [r["top_entities"] for r in rand[-1].results] != [r["top_entities"] for r in got]


def test_serve_cli_refuses_a_directory_without_a_checkpoint(tmp_path):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="no valid checkpoint"):
        main(["--reduced", "--device", "cpu", "--dim", "8", "--requests", "4",
              "--ckpt-dir", str(tmp_path / "empty")])


def test_serve_cli_answers_replay_bitwise_through_serve_batch(tmp_path, capsys):
    """``--answers``' micro-batches, engine and replica tier, are
    ``serve_batch``'s on the checkpoint's params, bitwise."""
    from repro_torch.core import PooledExecutor
    from repro_torch.data import load_dataset
    from repro_torch.launch.serve import main, read_answers, restore_params, serve_batch
    from repro_torch.launch.train import main as t_train
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import check_against_offline

    ck = str(tmp_path / "ck")
    t_train(["--reduced", "--device", "cpu", "--model", "betae", "--ckpt-dir", ck] + TRAIN)
    kg = load_dataset("FB15k")[0]
    model = make_model("betae", ModelConfig(dim=16), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(9), kg.n_entities, kg.n_relations)
    assert restore_params(ck, model, params) == 2
    ex = PooledExecutor(model, b_max=256, device="cpu")
    for extra in ([], ["--replicas", "2"]):
        path = str(tmp_path / f"a{len(extra)}.jsonl")
        main(["--model", "betae", "--reduced", "--device", "cpu", "--ckpt-dir", ck,
              "--answers", path] + SERVE + extra)
        assert "answers: wrote" in capsys.readouterr().out
        log = read_answers(path)
        n = check_against_offline(log, lambda qs: serve_batch(model, params, ex, qs, top_k=5,
                                                              device="cpu")[0])
        assert n == sum(r.n_real for r in log) >= 1


# ------------------------------------------------------------- under a mesh
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


def _write_checkpoints(d):
    """Single-device checkpoints of each family on the worker's graph (2
    steps of the port's trainer; GQE+H_sem through a 256-row hot set), and
    one of BetaE at dim 128 on the CLI's graph."""
    from repro_torch.launch.train import main as t_train
    from repro_torch.semantic import SemanticCache
    from repro_torch.training import NGDBTrainer, TrainConfig

    kg = W.graph()
    for family in W.FAMILIES:
        sem = ({"semantic_cache": SemanticCache(W.h_sem(), W.TRAIN_BUDGET, device="cpu")}
               if family.endswith("+sem") else {})
        tr = NGDBTrainer(W.model_for(family, 1), kg, TrainConfig(
            batch_size=16, n_negatives=4, b_max=16, prefetch=0,
            checkpoint_dir=os.path.join(d, family)), **sem)
        tr.train(2, log_every=0)
    t_train(["--reduced", "--device", "cpu", "--model", "betae", "--dim", "128",
             "--batch-size", "16", "--negatives", "4", "--steps", "1", "--eval-queries", "8",
             "--log-every", "0", "--ckpt-dir", os.path.join(d, "cli")])


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt_serve"))
    _write_checkpoints(d)
    for w in (4, 2):
        _join(_spawn(w, d), w)
    out = {}
    for w in (2, 4):
        for r in range(w):
            with open(os.path.join(d, f"w{w}.r{r}.pkl"), "rb") as f:
                out[w, r] = pickle.load(f)
    return d, out


def _mesh_agree(got, want):
    tol = dict(rtol=MESH_TOL["rtol"], atol=MESH_TOL["atol"] + ROUNDING)
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            np.testing.assert_allclose(g["scores"], w["scores"], **tol)
            ws = np.asarray(w["scores"])
            for j, (a, b) in enumerate(zip(g["top_entities"], w["top_entities"])):
                if a != b:
                    near = [abs(ws[j] - ws[i]) for i in (j - 1, j + 1) if 0 <= i < len(ws)]
                    assert j == len(ws) - 1 or min(near) <= 2 * tol["atol"], (j, g, w)


@pytest.mark.parametrize("family", W.FAMILIES)
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_restores_a_single_device_checkpoint(mesh_runs, world, family):
    d, out = mesh_runs
    single, _, ok = W.serve(family, os.path.join(d, family), None,
                            W.compositions(W.graph()), 1)
    assert ok
    for spec, profile in W.MESHES[world]:
        key = spec, profile, family
        ranks = [out[world, r] for r in range(world)]
        assert all(o["block_ok"][key] for o in ranks), [o["block_ok"][key] for o in ranks]
        assert all(o["answers"][key] == ranks[0]["answers"][key] for o in ranks)
        _mesh_agree(ranks[0]["answers"][key], single)
        rows = ranks[0]["shard"][key][0]
        ways = world if profile == "fsdp" else 2
        assert rows * ways == -(-W.E // world) * world, (key, rows)


def test_mesh_cli_serves_the_checkpoint(mesh_runs, tmp_path, capsys):
    from repro_torch.launch.serve import main, read_answers

    d, out = mesh_runs
    assert "loaded checkpoint step=1" in out[2, 0]["cli"]
    assert "execution context: mesh(data=2, model=1) profile=fsdp" in out[2, 0]["cli"]
    assert out[2, 1]["cli"] == ""          # rank 0 alone prints
    path = str(tmp_path / "single.jsonl")
    main(["--reduced", "--device", "cpu", "--dim", "128", "--requests", "32",
          "--max-wait-ms", "1000", "--model", "betae", "--ckpt-dir", os.path.join(d, "cli"),
          "--answers", path])
    capsys.readouterr()

    def by_key(p):
        return {q.key(): r for rec in read_answers(p)
                for q, r in zip(rec.queries[:rec.n_real], rec.results)}

    mesh, single = by_key(os.path.join(d, "cli.jsonl")), by_key(path)
    assert set(mesh) == set(single) and len(mesh) >= 16
    _mesh_agree([[mesh[k] for k in sorted(mesh)]], [[single[k] for k in sorted(mesh)]])


# ------------------------------------------------- constructor arguments
def test_plan_cache_arguments_match_reference():
    """A shared ``plan_cache`` serves a second executor's prepares; a
    ``plan_cache_size`` of 2 evicts as the reference's does."""
    from repro.core import PooledExecutor as JEx
    from repro_torch.core import PlanCache, PooledExecutor

    jm, _, tm, _ = carried_models("gqe")
    batches = [queries(8, seed=s) for s in (1, 2, 3, 1)]
    shared = PlanCache(16)
    a = PooledExecutor(tm, b_max=16, device="cpu", plan_cache=shared)
    b = PooledExecutor(tm, b_max=16, device="cpu", plan_cache=shared)
    a.prepare(batches[0][1])
    b.prepare(batches[0][1])
    assert b._plan_cache is shared and shared.stats()["hits"] == 1
    small = PooledExecutor(tm, b_max=16, device="cpu", plan_cache_size=2)
    ref = JEx(jm, b_max=16, plan_cache_size=2)
    for jq, tq in batches:
        small.prepare(tq)
        ref.prepare(jq)
    keys = ("size", "capacity", "hits", "misses", "evictions")
    want = ref.sharing_stats()["plan_cache"]
    assert {k: small.sharing_stats()["plan_cache"][k] for k in keys} == {k: want[k] for k in keys}


def test_replicas_take_plan_cache_size():
    from repro_torch.serving import Replica, ReplicaPool

    _, _, tm, tp = carried_models("gqe")
    rep = Replica(0, tm, tp, device="cpu", started=False, plan_cache_size=5)
    assert rep.executor._plan_cache.capacity == 5
    pool = ReplicaPool(tm, tp, n_replicas=2, device="cpu", started=False, plan_cache_size=7)
    assert [r.executor._plan_cache.capacity for r in pool.replicas().values()] == [7, 7]


def test_engine_latency_window_matches_reference():
    from repro.serving import ServingConfig as JCfg, ServingEngine as JEngine
    from repro_torch.serving import ServingConfig, ServingEngine

    jm, jp, tm, tp = carried_models("gqe")
    eng = ServingEngine(tm, tp, device="cpu", started=False, latency_window=7,
                        cfg=ServingConfig(latency_window=99))
    ref = JEngine(jm, jp, started=False, latency_window=7, cfg=JCfg(latency_window=99))
    assert eng.cfg.latency_window == ref.cfg.latency_window == 7
    for engine, kw in ((ServingEngine, {"device": "cpu"}), (JEngine, {})):
        m, p = (tm, tp) if engine is ServingEngine else (jm, jp)
        with pytest.raises(ValueError, match="latency_window must be >= 1"):
            engine(m, p, started=False, latency_window=0, **kw)


class _FixedPrefetcher:
    """A ``BatchPrefetcher`` stand-in: hands out fixed batches, must stay open."""

    def __init__(self, batches):
        self.batches, self.drawn = batches, 0

    def next(self, timeout=None):
        self.drawn += 1
        return self.batches[(self.drawn - 1) % len(self.batches)]

    def close(self):
        raise AssertionError("train() closed a caller's prefetcher")


def test_train_draws_from_a_callers_prefetcher():
    """``train(prefetcher=)`` draws a batch a step from the caller's
    prefetcher and leaves it open; the losses are the reference's on the
    same batches, and bitwise the port's own with ``batches=``."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro.sampling import OnlineSampler as JSampler
    from repro.training import AdamConfig as JAdam, NGDBTrainer as JTrainer, TrainConfig as JTC
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make
    from repro_torch.sampling import OnlineSampler as TSampler
    from repro_torch.training import AdamConfig as TAdam, NGDBTrainer as TTrainer, TrainConfig as TTC

    jkg, tkg = graphs()
    common = dict(batch_size=24, n_negatives=8, b_max=16, prefetch=2,
                  patterns=("1p", "2p", "2i", "3i"))
    jt = JTrainer(j_make("gqe", JCfg(dim=16)), jkg, JTC(adam=JAdam(lr=3e-3), **common))
    carried = {k: np.asarray(v) for k, v in jt.params.items()}

    def port():
        t = TTrainer(t_make("gqe", TCfg(dim=16), device="cpu"), tkg,
                     TTC(adam=TAdam(lr=3e-3), **common))
        t.load_params(carried)
        return t

    jb = [JSampler(jkg, patterns=common["patterns"], seed=20 + i).sample_batch(24)
          for i in range(3)]
    tb = [TSampler(tkg, patterns=common["patterns"], seed=20 + i).sample_batch(24)
          for i in range(3)]
    jpf, tpf = _FixedPrefetcher(jb), _FixedPrefetcher(tb)
    jl = [r["loss"] for r in jt.train(3, log_every=0, prefetcher=jpf)]
    tl = [r["loss"] for r in port().train(3, log_every=0, prefetcher=tpf)]
    assert jpf.drawn == tpf.drawn == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl == [r["loss"] for r in port().train(3, log_every=0, batches=tb)]


def test_encode_entities_matches_reference():
    from repro.semantic import PTEConfig as JCfg, StubPTE as JPTE
    from repro_torch.semantic import PTEConfig, StubPTE

    cfg = dict(d_l=16, n_layers=1, d_model=32, n_heads=2)
    jpte = JPTE(JCfg(**cfg))
    tpte = StubPTE(PTEConfig(**cfg), device="cpu",
                   params={k: np.asarray(v) for k, v in jpte.params.items()})
    jkg, tkg = graphs()
    ids = np.arange(0, 200, 9)
    want = np.asarray(jpte.encode_entities(jkg, ids))
    got = tpte.encode_entities(tkg, ids)
    assert got.shape == (len(ids), 16)
    np.testing.assert_allclose(got.numpy(), want, **ENCODE)
    torch.testing.assert_close(got, tpte.encode_tokens(StubPTE.descriptions(tkg, ids)),
                               rtol=0, atol=0)


# ---------------------------------------------------------------- drivers
def test_e2e_driver_trains_crashes_resumes_and_serves(capsys):
    from repro_torch.launch import e2e

    out = e2e.main(["--device", "cpu", "--steps", "40", "--dim", "16"])
    text = capsys.readouterr().out
    assert "resumed at step 20; continuing" in text and "serve sample:" in text
    assert out["step"] == 40 and np.isfinite(out["metrics"]["mrr"])
    assert len(out["results"]) == 16 and all(len(r["top_entities"]) == 5
                                            for r in out["results"])


def test_semantic_fusion_driver_holds_the_kernel_to_the_model(capsys):
    from repro_torch.launch import semantic_fusion

    assert semantic_fusion.main(["--device", "cpu"]) == {"model": True, "plain": True}
    assert "kernel == model fusion: True" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b", "whisper-large-v3"])
def test_lm_zoo_driver_runs_the_reduced_steps(arch, capsys):
    from repro_torch.launch import lm_zoo

    out = lm_zoo.main(["--device", "cpu", "--arch", arch])
    text = capsys.readouterr().out
    assert out["finite"] and np.isfinite(out["loss"])
    assert f"== {arch} [" in text and "cell train_4k" in text
    assert text.rstrip().splitlines()[-1].startswith(
        "(dry-run at production scale: PYTHONPATH=src python -m repro_torch.launch.dryrun")
