"""The port's semantic-augmented training (§4.4, Eq. 11+12) against the JAX
package on the CPU, at small widths (dim 16, d_l 32, dp 8) with H_sem made
from a seed with numpy: the loss's gradients of all six families with H_sem
resident and through a hot set smaller than the graph, the ``gather_fuse``
gradient against ``jax.grad`` in fp64 and fp32, 20-step loss sequences of
the sync trainer, ``evaluate`` with the chunked out-of-core scorer,
``batch_entity_ids``, ``resume`` under a cache, and semantic checkpoints
read by either package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import FAMILIES
from test_torch_semantic import _models as _semantic_models
from test_torch_training import _assert_grads_close, _port_grads, _ref_grads
from torch_parity import graphs, queries

torch.set_num_threads(1)

DIM, D_L, DP = 16, 32, 8
N_ENT = 200                 # the shared graph's entities (torch_parity.KG_SHAPE)
BUDGET = 184                # a hot set below the graph's 200 rows
SEM = dict(dim=DIM, semantic_dim=D_L, semantic_proj_dim=DP)
PATTERNS = ("1p", "2p", "2i", "3i", "ip", "pi", "2u", "2in")


@pytest.fixture(scope="module")
def table():
    """H_sem [200, 32]: unit rows from a seeded numpy generator (a stand-in
    for the PTE's normalised embeddings)."""
    t = np.random.default_rng(21).normal(size=(N_ENT, D_L))
    return (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)


def _models(name, table, budget=None, stage_ids=None):
    return _semantic_models(name, table, budget, stage_ids, cfg=SEM)


# --------------------------------------------------------------- gradients
@pytest.mark.parametrize("layout", ["resident", "cache"])
@pytest.mark.parametrize("name", FAMILIES)
def test_semantic_loss_gradients_match_reference(name, layout, table):
    """The loss and every trainable parameter's gradient (the fusion weights
    and the structural table included) through pooled encode against
    ``jax.value_and_grad`` of the reference, H_sem resident or staged in a
    hot set of 184 rows (below the graph's 200)."""
    from repro.data.pipeline import batch_entity_ids

    jq, tq = queries(20, seed=13)
    rng = np.random.default_rng(13)
    pos, neg = rng.integers(0, N_ENT, size=20), rng.integers(0, N_ENT, size=(20, 4))
    stage = batch_entity_ids(jq, pos, neg)
    assert len(np.unique(stage)) <= BUDGET < N_ENT
    jm, jp, tm, tp = _models(name, table, *(() if layout == "resident" else (BUDGET, stage)))
    want_loss, want = _ref_grads(jm, jp, jq, pos, neg)
    got_loss, got = _port_grads(tm, tp, tq, pos, neg)
    assert {"fuse_w", "fuse_b", "sem_proj_w", "sem_proj_b", "entity"} <= set(got)
    assert np.abs(got["sem_proj_w"]).max() > 0 and np.abs(got["fuse_w"]).max() > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(name, got, want)


@pytest.mark.parametrize("layout", ["resident", "cache"])
def test_gather_fuse_gradient_matches_reference(layout):
    """The CPU ``gather_fuse`` gradient (autograd through ``gather_fuse_ref``)
    against ``jax.grad`` of the JAX package's oracle
    (``src/repro/kernels/ref.py::gather_fuse_ref``), with ids repeated as the
    loss repeats them, H_sem read straight or through hot-set slots: in fp64
    the two agree to 1e-9 of the largest gradient; in fp32 each element of
    both lies within 1e-4·|exact| + its allowance of that fp64 value
    (``gather_fuse_backward_allowance``)."""
    from repro.kernels.ref import gather_fuse_ref as j_ref
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(4)
    n, E, d, dl, dp = 90, 40, 16, 32, 8
    ids = rng.integers(0, E, size=n)
    h_str = (rng.normal(size=(E, d)) / 4).astype(np.float32)
    full = rng.normal(size=(E, dl)).astype(np.float32)
    wp = (rng.normal(size=(dl, dp)) / 4).astype(np.float32)
    bp = (rng.normal(size=dp) / 10).astype(np.float32)
    wf = (rng.normal(size=(d + dp, d)) / 4).astype(np.float32)
    bf = (rng.normal(size=d) / 10).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    if layout == "resident":
        h_sem, sem_ids = full, None
    else:  # the rows the ids name, at shuffled slots of a 48-row hot set
        used = np.unique(ids)
        slot_of = np.full(E, -1)
        slot_of[used] = rng.permutation(48)[:len(used)]
        h_sem = np.zeros((48, dl), np.float32)
        h_sem[slot_of[used]] = full[used]
        sem_ids = torch.from_numpy(slot_of[ids])

    def j_grad(dtype):
        a = [jnp.asarray(v, dtype) for v in (h_str, full, wp, bp, wf, bf)]
        gg = jnp.asarray(g, dtype)
        grads = jax.grad(lambda hs, hm, *w: jnp.sum(j_ref(jnp.asarray(ids), hs, hm, *w) * gg),
                         argnums=(0, 2, 3, 4, 5))(*a)
        return [np.asarray(v) for v in grads]

    want = j_grad(jnp.float32)
    with jax.enable_x64(True):
        want64 = j_grad(jnp.float64)
    tid = torch.from_numpy(ids)
    hs = torch.from_numpy(h_sem)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h_str, wp, bp, wf, bf)]
    out = kops.gather_fuse(tid, leaves[0], hs, *leaves[1:], sem_ids=sem_ids)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    args = [torch.from_numpy(a) for a in (h_str, h_sem, wp, bp, wf, bf, g)]
    plain = kops.gather_fuse_backward(tid, *args, sem_ids=sem_ids)
    exact = kops.gather_fuse_backward_ref(tid, *(a.double() for a in args), sem_ids=sem_ids)
    allowed = kops.gather_fuse_backward_allowance(tid, *args, sem_ids=sem_ids)
    top = max(float(np.abs(w).max()) for w in want64)
    for a, p, e, w, w64, al in zip(got, plain, exact, want, want64, allowed):
        torch.testing.assert_close(a, p, rtol=0, atol=0)
        assert e.dtype == torch.float64 and w64.dtype == np.float64
        np.testing.assert_allclose(e.numpy(), w64, rtol=1e-9, atol=1e-9 * top)
        for fp32 in (a.numpy(), w):
            assert (np.abs(fp32 - w64) <= 1e-4 * np.abs(w64) + al.numpy()).all()


def test_gather_fuse_ref_keeps_fp64():
    """The plain version computes fp64 tables in fp64 (the exact value the
    card's checks compare to) and everything else in fp32."""
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 10, size=7))
    h_str, h_sem = rng.normal(size=(10, 6)), rng.normal(size=(10, 12))
    w = [rng.normal(size=s) / 3 for s in ((12, 4), (4,), (10, 6), (6,))]
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    out64 = kops.gather_fuse_ref(ids, t(h_str, torch.float64), t(h_sem, torch.float64),
                                 *(t(a, torch.float32) for a in w))
    out32 = kops.gather_fuse_ref(ids, t(h_str, torch.float32), t(h_sem, torch.float32),
                                 *(t(a, torch.float32) for a in w))
    assert out64.dtype == torch.float64 and out32.dtype == torch.float32
    z = h_sem[ids.numpy()] @ w[0].astype(np.float32).astype(np.float64) + w[1].astype(
        np.float32)
    x = np.concatenate([h_str[ids.numpy()], z], 1)
    want = 2 / (1 + np.exp(-(x @ w[2].astype(np.float32) + w[3].astype(np.float32)))) - 1
    np.testing.assert_allclose(out64.numpy(), want, rtol=1e-12, atol=1e-13)
    assert float((out32.double() - out64).abs().max()) > 1e-12  # fp32 is not fp64


# -------------------------------------------------------------- the trainer
def _trainers(name, table, executor="pooled", budget=None, steps=20, n_batches=2,
              ckpt=None, **cfg_kw):
    """The reference trainer and the port's with H_sem resident (``budget``
    None) or behind hot sets of ``budget`` rows, from the same parameters,
    fed the same fixed batches; returns both trainers and loss sequences.
    With ``ckpt``, each checkpoints into its own directory under it."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro.sampling import OnlineSampler as JSampler
    from repro.semantic import SemanticCache as JCache
    from repro.training import AdamConfig as JAdam, NGDBTrainer as JTrainer, TrainConfig as JTC
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make
    from repro_torch.sampling import OnlineSampler as TSampler
    from repro_torch.semantic import SemanticCache as TCache
    from repro_torch.training import AdamConfig as TAdam, NGDBTrainer as TTrainer, TrainConfig as TTC

    jkg, tkg = graphs()
    common = dict(batch_size=24, n_negatives=8, b_max=16, executor=executor, prefetch=0,
                  patterns=PATTERNS, **cfg_kw)
    if budget is None:
        jsem, tsem = dict(semantic_table=table), dict(semantic_table=table)
    else:
        jsem = dict(semantic_cache=JCache(table, budget_rows=budget))
        tsem = dict(semantic_cache=TCache(table, budget_rows=budget, device="cpu"))
    dirs = {"j": {}, "t": {}} if ckpt is None else {
        w: dict(checkpoint_dir=str(ckpt / w), checkpoint_every=100) for w in "jt"}
    jt = JTrainer(j_make(name, JCfg(**SEM)), jkg,
                  JTC(adam=JAdam(lr=3e-3), **common, **dirs["j"]), **jsem)
    tt = TTrainer(t_make(name, TCfg(**SEM), device="cpu"), tkg,
                  TTC(adam=TAdam(lr=3e-3), **common, **dirs["t"]), **tsem)
    tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
    jb = [JSampler(jkg, patterns=PATTERNS, seed=10 + i).sample_batch(24)
          for i in range(n_batches)]
    tb = [TSampler(tkg, patterns=PATTERNS, seed=10 + i).sample_batch(24)
          for i in range(n_batches)]
    jl = [r["loss"] for r in jt.train(steps, log_every=0, batches=jb)]
    tl = [r["loss"] for r in tt.train(steps, log_every=0, batches=tb)]
    return jt, tt, np.array(jl), np.array(tl)


@pytest.mark.parametrize("executor,budget", [("pooled", None), ("pooled", BUDGET),
                                             ("query_level", None)])
def test_semantic_trainer_losses_match_reference(executor, budget, table):
    """Sync semantic GQE training from carried parameters on fixed batches,
    H_sem resident or behind a hot set below the graph (every step staging
    its rows, with evictions): the first loss within rtol 1e-4, every one of
    20 within 1e-3."""
    jt, tt, jl, tl = _trainers("gqe", table, executor, budget)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k in ("sem_table", "sem_cache", "sem_slot"):
        if k in jt.params:  # H_sem is frozen; the hot set holds the store's rows
            got, want = tt.params[k].numpy(), np.asarray(jt.params[k])
            np.testing.assert_array_equal(got, want)
    if budget is not None:
        tc, jc = tt.sem_cache, jt.sem_cache
        assert tt.params["sem_cache"] is tc.buffer and tt.params["sem_slot"] is tc.slot_map
        assert (int(tc.misses), int(tc.evictions)) == (int(jc.misses), int(jc.evictions))
        assert tc.evictions > 0
        np.testing.assert_array_equal(tc.resident_ids(), jc.resident_ids())


def test_semantic_trainer_takes_a_cache_loaded_under_load_params(table):
    """``load_params`` under a cache keeps the params' hot set the cache's own
    tensors (the ones staging writes) and resets its residency."""
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache
    from repro_torch.training import NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(N_ENT, 6, 1500, seed=1)
    cache = SemanticCache(table, budget_rows=BUDGET, device="cpu")
    tr = NGDBTrainer(make_model("gqe", ModelConfig(**SEM), device="cpu"), kg,
                     TrainConfig(batch_size=8, n_negatives=4, b_max=8, patterns=("1p", "2i")),
                     semantic_cache=cache)
    tr.train(1, log_every=0)
    assert cache.resident_rows > 0
    arrays = {k: v.numpy().copy() for k, v in tr.params.items()}
    tr.load_params(arrays)
    assert tr.params["sem_cache"] is cache.buffer and tr.params["sem_slot"] is cache.slot_map
    assert dict(tr.model.named_buffers())["sem_cache"] is cache.buffer
    assert cache.resident_rows == 0
    np.testing.assert_array_equal(cache.slot_map.numpy(), arrays["sem_slot"])
    tr.train(1, log_every=0)
    assert cache.resident_rows > 0


# ------------------------------------------------------------- evaluation
@pytest.mark.parametrize("scorer", ["score_all", "chunked"])
def test_semantic_evaluate_matches_reference(scorer, table):
    """MRR, Hits@k, hard-MRR and per-pattern MRR of semantic GQE on fixed
    parameters: H_sem resident and scored by ``score_all``, or behind a hot
    set holding the queries' anchors and scored by ``score_all_chunked``
    through ``score_all_fn`` (chunks of 64 rows from the table)."""
    from repro.core import PooledExecutor as JExecutor
    from repro.data import split_kg as j_split
    from repro.sampling import OnlineSampler as JSampler
    from repro.training import evaluate as j_eval
    from repro_torch.core import PooledExecutor
    from repro_torch.data import split_kg as t_split
    from repro_torch.sampling import OnlineSampler as TSampler
    from repro_torch.training import evaluate as t_eval

    jkg, tkg = graphs()
    jtrain, _, _ = j_split(jkg)
    ttrain, _, _ = t_split(tkg)
    pats = ("1p", "2p", "2i", "ip", "2u", "2in")
    jq = [b.query for b in JSampler(jtrain, patterns=pats, seed=4).sample_batch(16)]
    tq = [b.query for b in TSampler(ttrain, patterns=pats, seed=4).sample_batch(16)]
    if scorer == "score_all":
        jm, jp, tm, tp = _models("gqe", table)
        jfn = tfn = None
    else:
        anchors = np.concatenate([q.anchors for q in jq])
        jm, jp, tm, tp = _models("gqe", table, 64, anchors)
        rows = lambda i: table[np.asarray(i)]  # noqa: E731
        jfn = lambda p, q: jm.score_all_chunked(p, q, rows, chunk=64)  # noqa: E731
        tfn = lambda p, q: tm.score_all_chunked(p, q, rows, chunk=64)  # noqa: E731
    want = j_eval(jm, jp, JExecutor(jm, b_max=16), jkg, jq, train_kg=jtrain, batch_size=8,
                  score_all_fn=jfn)
    got = t_eval(tm, tp, PooledExecutor(tm, b_max=16, device="cpu"), tkg, tq,
                 train_kg=ttrain, batch_size=8, score_all_fn=tfn)
    assert set(got) == set(want) and "hard_mrr" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


# ----------------------------------------------------------------- staging
def test_batch_entity_ids_matches_reference_exactly():
    from repro.data.pipeline import batch_entity_ids as j_ids
    from repro.sampling import OnlineSampler as JSampler
    from repro_torch.data import batch_entity_ids as t_ids
    from repro_torch.sampling import OnlineSampler as TSampler

    jkg, tkg = graphs()
    jq, jpos, jneg = JSampler(jkg, seed=6).to_training_arrays(JSampler(jkg, seed=5)
                                                              .sample_batch(30), 8)
    tq, tpos, tneg = TSampler(tkg, seed=6).to_training_arrays(TSampler(tkg, seed=5)
                                                              .sample_batch(30), 8)
    want, got = j_ids(jq, jpos, jneg), t_ids(tq, tpos, tneg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_resume_under_a_cache_resets_it_and_matches_reference(tmp_path, table):
    """Both packages train three cached steps and checkpoint; a fresh trainer
    of each takes one step (so that its hot set holds rows), resumes, and
    takes the next: the port's resume leaves the params' hot set the cache's
    tensors with nothing resident, and its next loss matches the
    reference's."""
    from repro.sampling import OnlineSampler as JSampler
    from repro_torch.sampling import OnlineSampler as TSampler

    jt, tt, _, _ = _trainers("gqe", table, budget=BUDGET, steps=3, n_batches=2,
                             ckpt=tmp_path / "a")
    jkg, tkg = graphs()
    jb = JSampler(jkg, patterns=PATTERNS, seed=30).sample_batch(24)
    tb = TSampler(tkg, patterns=PATTERNS, seed=30).sample_batch(24)
    jt2, tt2, _, _ = _trainers("gqe", table, budget=BUDGET, steps=1, n_batches=1,
                               ckpt=tmp_path / "b", seed=5)
    for tr, src in ((jt2, jt), (tt2, tt)):
        tr.ckpt.directory = src.ckpt.directory
    assert tt2.sem_cache.resident_rows > 0
    assert jt2.resume() and tt2.resume() and tt2.step == jt2.step == 3
    assert tt2.sem_cache.resident_rows == 0
    assert tt2.params["sem_cache"] is tt2.sem_cache.buffer
    assert tt2.params["sem_slot"] is tt2.sem_cache.slot_map
    for k in ("entity", "fuse_w", "sem_proj_w"):
        torch.testing.assert_close(tt2.params[k], tt.params[k], rtol=0, atol=0)
    jl, tl = jt2.train_step(jb)["loss"], tt2.train_step(tb)["loss"]
    assert tl == pytest.approx(jl, rel=1e-4)


def test_semantic_checkpoints_cross_between_packages(tmp_path, table):
    """A semantic checkpoint under a hot set (the int32 slot map included)
    written by the reference trainer restores into the port's exactly, and
    one the port writes into the reference's."""
    jt, tt, _, _ = _trainers("gqe", table, budget=BUDGET, steps=2, n_batches=1)
    from repro.training.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
    from repro_torch.training.checkpoint import (load_checkpoint as t_load,
                                                 save_checkpoint as t_save)

    j_save(str(tmp_path / "j"), 2, {"params": jt.params, "opt": jt.opt_state})
    step, tree, _ = t_load(str(tmp_path / "j"), template={"params": tt.params,
                                                          "opt": tt.opt_state})
    assert step == 2 and tree["params"]["sem_slot"].dtype == torch.int32
    for k, v in jt.params.items():
        np.testing.assert_array_equal(tree["params"][k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(tree["opt"]["m"][k].numpy(), np.asarray(jt.opt_state["m"][k]))
    t_save(str(tmp_path / "t"), 2, {"params": tt.params, "opt": tt.opt_state})
    step, tree, _ = j_load(str(tmp_path / "t"), template={"params": jt.params,
                                                          "opt": jt.opt_state})
    assert step == 2 and np.asarray(tree["params"]["sem_slot"]).dtype == np.int32
    for k, v in tt.params.items():
        np.testing.assert_array_equal(np.asarray(tree["params"][k]), v.numpy())
        np.testing.assert_array_equal(np.asarray(tree["opt"]["v"][k]), tt.opt_state["v"][k].numpy())
    assert tree["opt"]["m"]["sem_cache"].shape == (1,)


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("E,batch,negatives,want", [(14951, 512, 64, 14951), (200, 24, 8, 200),
                                                    (10**6, 16, 4, 512), (10**6, 512, 64, 139264)])
def test_training_budget_rows_is_the_reference_launchers_rule(E, batch, negatives, want):
    """``training_budget_rows`` is the hot-set budget of the reference's
    ``launch/train.py`` (four steps' working sets, at least one, at most
    every entity)."""
    from repro_torch.semantic import training_budget_rows

    per_batch = batch * (4 + negatives)
    assert training_budget_rows(E, batch, negatives) == want == max(
        min(E, 4 * per_batch), min(E, per_batch))


@pytest.mark.parametrize("layout", ["resident", "cache"])
def test_fuse_backward_inputs_name_the_same_rows_in_both_layouts(layout):
    """The backward's timing inputs (``kernels.timing.fuse_backward_inputs``,
    as ``chip_smoke.py`` and ``time_kernels`` take them) on the CPU: ids
    repeat, hot-set slots hold the rows the ids name, and the saved output and
    zp are the plain version's."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.timing import fuse_backward_inputs

    args, g, sem_ids, out, zp = fuse_backward_inputs(64, layout, 50, 8, 16, 4,
                                                     torch.Generator().manual_seed(3))
    ids, h_str, h_sem = args[:3]
    assert len(torch.unique(ids)) < len(ids) and int(ids.max()) < 32
    assert tuple(g.shape) == tuple(out.shape) == (64, 8)
    rows = h_sem[ids] if sem_ids is None else h_sem[sem_ids]
    torch.testing.assert_close(torch.linalg.norm(rows, dim=1), torch.ones(64))
    if sem_ids is not None:
        same = ids[:, None] == ids[None, :]
        assert bool(((sem_ids[:, None] == sem_ids[None, :]) == same).all())
    torch.testing.assert_close(out, kops.gather_fuse_ref(*args, sem_ids=sem_ids), rtol=0, atol=0)
    torch.testing.assert_close(zp, rows @ args[3] + args[4], rtol=0, atol=0)
