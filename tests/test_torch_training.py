"""The port's training slice against the JAX package on the CPU: schedules
under the ablation policies, the training tensors and the adaptive sampler
(exactly), the loss's gradients through pooled encode for all six families,
the ``intersect`` gradient, Adam, a 20-step loss sequence of the sync
trainer, evaluation and checkpoints written by either package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import FAMILIES
from test_torch_plan import _assert_plans_equal as assert_plans_equal
from torch_parity import carried_models, graphs, queries

torch.set_num_threads(1)

# Gradient tolerances (per parameter): rtol 1e-4 and atol 1e-6·max|g|; the
# largest difference seen on these inputs is 7.2e-7·max|g| (FuzzQE's
# entity). BetaE is looser for its betaln/digamma deviation (torch_parity):
# largest seen 9.4e-6·max|g| (uatt_w1), elementwise 8.8e-5 relative.
GRAD = dict(rtol=1e-4, atol_frac=1e-6)
GRAD_BETAE = dict(rtol=1e-3, atol_frac=1e-4)
# Biases whose only path to the loss is a softmax's logits: a softmax does
# not change when its logits shift, so their exact gradient is 0 and both
# packages give rounding alone. They are held to |g| <= 1e-6·max over all
# the model's gradients instead.
SHIFT_INVARIANT = {"betae": ("att_b1", "uatt_b1"), "q2b": ("att_b1",)}


def _batch(n: int, seed: int, k: int = 8):
    """The same queries in both packages, and positives/negatives from a
    numpy generator (answers of the queries are not needed for the
    gradient)."""
    jq, tq = queries(n, seed=seed)
    rng = np.random.default_rng(seed)
    return jq, tq, rng.integers(0, 200, size=n), rng.integers(0, 200, size=(n, k))


# H_sem in either layout: closed over by the loss, as both trainers do.
FROZEN = ("sem_table", "sem_cache", "sem_slot")


def _ref_grads(jm, jp, jq, pos, neg, b_max=16):
    """``jax.value_and_grad`` of the reference's loss over the trainable
    params (all but H_sem)."""
    from repro.core import PooledExecutor as JExecutor
    from repro.training.loss import negative_sampling_loss as j_loss

    ex = JExecutor(jm, b_max=b_max)
    prep = ex.prepare(jq)
    enc = ex.encode_fn(prep)
    steps, ans = prep.device_args()
    p_pos, p_neg = jnp.asarray(pos[prep.order]), jnp.asarray(neg[prep.order])
    frozen = {k: v for k, v in jp.items() if k in FROZEN}

    def loss_fn(t):
        p = {**t, **frozen}
        return j_loss(jm, p, enc(p, steps, ans), p_pos, p_neg)[0]

    trainable = {k: v for k, v in jp.items() if k not in FROZEN}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_grads(tm, tp, tq, pos, neg, b_max=16):
    from repro_torch.core import PooledExecutor
    from repro_torch.training.loss import negative_sampling_loss

    ex = PooledExecutor(tm, b_max=b_max, device="cpu")
    prep = ex.prepare(tq)
    steps, ans = prep.device_args(torch.device("cpu"))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items() if k not in FROZEN}
    p = {**leaves, **{k: v for k, v in tp.items() if k in FROZEN}}
    q = ex.encode_fn(prep)(p, steps, ans)
    loss, _ = negative_sampling_loss(tm, p, q, torch.from_numpy(pos[prep.order]),
                                     torch.from_numpy(neg[prep.order]))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.item(), {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy())
                         for (k, v), g in zip(leaves.items(), grads)}


def _assert_grads_close(name, got, want):
    tol = GRAD_BETAE if name == "betae" else GRAD
    top = max(float(np.abs(g).max()) for g in want.values())
    assert set(got) == set(want)
    for k in sorted(want):
        if k in SHIFT_INVARIANT.get(name, ()):
            assert np.abs(got[k]).max() <= 1e-6 * top and np.abs(want[k]).max() <= 1e-6 * top, k
            continue
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=tol["rtol"],
                                   atol=tol["atol_frac"] * scale, err_msg=f"{name}.{k}")


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("cse", [True, False])
@pytest.mark.parametrize("reuse_slots", [True, False])
@pytest.mark.parametrize("policy", ["max_fillness", "fifo"])
def test_schedule_policies_match_reference_exactly(policy, reuse_slots, cse):
    from repro.core import compile_batch as j_compile
    from repro_torch.core import compile_batch as t_compile

    jq, tq = queries(40, seed=5)
    kw = dict(model_name="gqe", b_max=8, reuse_slots=reuse_slots, policy=policy, cse=cse)
    assert_plans_equal(j_compile(jq, **kw), t_compile(tq, **kw))


def test_query_level_groups_match_reference_exactly():
    from repro.core.executor import QueryLevelExecutor as JQL
    from repro_torch.core import QueryLevelExecutor as TQL

    jm, _, tm, _ = carried_models("gqe")
    jq, tq = queries(40, seed=6)
    jex, tex = JQL(jm, b_max=8), TQL(tm, b_max=8, device="cpu")
    (jg, jidx), (tg, tidx) = jex.prepare_groups(jq), tex.prepare_groups(tq)
    assert list(jg) == list(tg) and jidx == tidx
    for pat in jg:
        assert_plans_equal(jex.prepare(jg[pat]), tex.prepare(tg[pat]))


# ------------------------------------------------------- sampler, adaptive
def test_training_arrays_match_reference_exactly():
    from repro.sampling import OnlineSampler as JSampler
    from repro_torch.sampling import OnlineSampler as TSampler

    jkg, tkg = graphs()
    js, ts = JSampler(jkg, seed=3), TSampler(tkg, seed=3)
    for _ in range(2):
        jq, jpos, jneg = js.to_training_arrays(js.sample_batch(24), 16)
        tq, tpos, tneg = ts.to_training_arrays(ts.sample_batch(24), 16)
        assert [q.key() for q in jq] == [q.key() for q in tq]
        np.testing.assert_array_equal(jpos, tpos)
        np.testing.assert_array_equal(jneg, tneg)


def test_adaptive_distribution_matches_reference_exactly():
    from repro.sampling import AdaptiveDistribution as JAD
    from repro.sampling import pattern_losses_from_batch as j_plb
    from repro_torch.core import TEMPLATES
    from repro_torch.sampling import AdaptiveDistribution as TAD
    from repro_torch.sampling import pattern_losses_from_batch as t_plb

    pats = list(TEMPLATES)
    jad, tad = JAD(pats, ema=0.8, temperature=0.5), TAD(pats, ema=0.8, temperature=0.5)
    rng = np.random.default_rng(0)
    for _ in range(4):
        names = [pats[i] for i in rng.integers(0, len(pats), 64)]
        losses = rng.gamma(2.0, size=64).astype(np.float32)
        jl, tl = j_plb(names, jnp.asarray(losses)), t_plb(names, losses)
        assert jl == tl
        jad.update(jl)
        tad.update(tl)
        assert jad.distribution() == tad.distribution()


# --------------------------------------------------------------- gradients
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_gradients_match_reference(name):
    """The loss and every parameter's gradient through pooled encode (CSE
    on, pools of up to 16) against ``jax.value_and_grad`` of the reference's
    jnp path."""
    jm, jp, tm, tp = carried_models(name)
    jq, tq, pos, neg = _batch(28, seed=13)
    want_loss, want = _ref_grads(jm, jp, jq, pos, neg)
    got_loss, got = _port_grads(tm, tp, tq, pos, neg)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(name, got, want)


def test_intersect_gradient_matches_reference():
    """The CPU ``intersect`` gradient (autograd through ``intersect_ref``)
    against ``jax.grad`` of the JAX package's oracle: in fp64 the two agree
    to 1e-9 of the largest gradient; in fp32 each element of both lies
    within 1e-4·|exact| + its allowance of that fp64 value
    (``intersect_backward_allowance``)."""
    from repro.kernels.ref import intersect_ref as j_ref
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(0)
    n, k, d, hd = 9, 3, 16, 32
    x = (np.abs(rng.normal(size=(n, k, d))) + 0.05).astype(np.float32)
    w1 = (rng.normal(size=(d, hd)) / 4).astype(np.float32)
    b1 = (rng.normal(size=hd) / 10).astype(np.float32)
    w2 = (rng.normal(size=(hd, 1)) / 4).astype(np.float32)
    b2 = np.zeros(1, np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)

    def j_grad(dtype):
        a = [jnp.asarray(v, dtype) for v in (x, w1, b1, w2, b2)]
        gg = jnp.asarray(g, dtype)
        return [np.asarray(v) for v in jax.grad(
            lambda *p: jnp.sum(j_ref(*p) * gg), argnums=(0, 1, 2, 3, 4))(*a)]

    want = j_grad(jnp.float32)
    with jax.enable_x64(True):
        want64 = j_grad(jnp.float64)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    got = torch.autograd.grad((kops.intersect(*leaves) * torch.from_numpy(g)).sum(), leaves)
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g)]
    plain = kops.intersect_backward(*args)
    exact = kops.intersect_backward_ref(*(a.double() for a in args))
    allowed = kops.intersect_backward_allowance(*args)
    top = max(float(np.abs(w).max()) for w in want64)
    for a, p, e, w, w64, al in zip(got, plain, exact, want, want64, allowed):
        torch.testing.assert_close(a, p, rtol=0, atol=0)
        assert w64.dtype == np.float64
        np.testing.assert_allclose(e.numpy(), w64, rtol=1e-9, atol=1e-9 * top)
        for fp32 in (a.numpy(), w):
            assert (np.abs(fp32 - w64) <= 1e-4 * np.abs(w64) + al.numpy()).all()


# ------------------------------------------------------------------- adam
@pytest.mark.parametrize("clip_norm,weight_decay", [(0.0, 0.0), (0.05, 0.01)])
def test_adam_matches_reference_step_by_step(clip_norm, weight_decay):
    from repro.training.optim import AdamConfig as JCfg, adam_init as j_init, adam_update as j_upd
    from repro_torch.training.optim import (AdamConfig as TCfg, adam_init as t_init,
                                            adam_update as t_upd, global_norm)

    rng = np.random.default_rng(1)
    shapes = {"entity": (20, 8), "relation": (5, 8), "att_b0": (16,), "sem_table": (20, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=3e-3, weight_decay=weight_decay, clip_norm=clip_norm)
    jc, tc = JCfg(**kw), TCfg(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = j_init(jp, jc), t_init(tp, tc)
    assert ts["m"]["sem_table"].shape == (1,) and ts["m"]["entity"].shape == (20, 8)
    for _ in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        grads["sem_table"] = np.zeros(1, np.float32)   # the frozen leaf's token
        jp, js = j_upd({k: jnp.asarray(v) for k, v in grads.items()}, js, jp, jc)
        t_upd({k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp, tc)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                       rtol=1e-6, atol=1e-12)
        assert int(ts["step"]) == int(js["step"])
    np.testing.assert_array_equal(tp["sem_table"].numpy(), params["sem_table"])
    g = {k: torch.ones(2, 3) for k in "ab"}
    assert float(global_norm(g)) == pytest.approx(12 ** 0.5)


# -------------------------------------------------------------- the trainer
def _trainers(name, executor="pooled", steps=20, n_batches=2, **cfg_kw):
    """The reference trainer and the port's, from the same parameters, fed
    the same fixed batches; returns both loss sequences."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro.sampling import OnlineSampler as JSampler
    from repro.training import AdamConfig as JAdam, NGDBTrainer as JTrainer, TrainConfig as JTC
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make
    from repro_torch.sampling import OnlineSampler as TSampler
    from repro_torch.training import AdamConfig as TAdam, NGDBTrainer as TTrainer, TrainConfig as TTC

    jkg, tkg = graphs()
    common = dict(batch_size=24, n_negatives=8, b_max=16, executor=executor, prefetch=0,
                  patterns=("1p", "2p", "2i", "3i", "ip", "pi", "2u", "2in"), **cfg_kw)
    jt = JTrainer(j_make(name, JCfg(dim=16)), jkg, JTC(adam=JAdam(lr=3e-3), **common))
    tt = TTrainer(t_make(name, TCfg(dim=16), device="cpu"), tkg,
                  TTC(adam=TAdam(lr=3e-3), **common))
    tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
    jb = [JSampler(jkg, patterns=common["patterns"], seed=10 + i).sample_batch(24)
          for i in range(n_batches)]
    tb = [TSampler(tkg, patterns=common["patterns"], seed=10 + i).sample_batch(24)
          for i in range(n_batches)]
    jl = [r["loss"] for r in jt.train(steps, log_every=0, batches=jb)]
    tl = [r["loss"] for r in tt.train(steps, log_every=0, batches=tb)]
    return jt, tt, np.array(jl), np.array(tl)


@pytest.mark.parametrize("name,executor,n_batches", [("betae", "pooled", 2),
                                                     ("gqe", "pooled", 2),
                                                     ("gqe", "query_level", 1)])
def test_trainer_losses_match_reference(name, executor, n_batches):
    """Sync training from carried parameters on fixed batches: the first
    loss within rtol 1e-4, every one of 20 within 1e-3."""
    _, _, jl, tl = _trainers(name, executor, n_batches=n_batches)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_trainer_raises_for_later_slices(tmp_path):
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.obs import read_jsonl
    from repro_torch.training import NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(50, 4, 300, seed=0)
    model = make_model("gqe", ModelConfig(dim=8), device="cpu")
    # materialized_rows came with slice 5: it now builds the trainer's cache.
    assert NGDBTrainer(model, kg, TrainConfig(materialized_rows=8)).mat_cache.budget_rows == 8
    # metrics_path came with slice 6: it now writes one step record a step.
    path = tmp_path / "m.jsonl"
    tr = NGDBTrainer(model, kg, TrainConfig(batch_size=8, n_negatives=2, b_max=32,
                                            patterns=("1p", "2p"), prefetch=0,
                                            metrics_path=str(path)))
    tr.train(2, log_every=0)
    assert [(r["kind"], r["mode"], r["step"]) for r in read_jsonl(str(path))] == [
        ("step", "sync", 1), ("step", "sync", 2)]
    with pytest.raises(NotImplementedError, match="slice 9"):
        NGDBTrainer(model, kg, TrainConfig(), ctx=object())


# ------------------------------------------------------------- evaluation
@pytest.mark.parametrize("name", FAMILIES)
def test_evaluate_matches_reference(name):
    """MRR, Hits@k, hard-MRR and per-pattern MRR on fixed parameters."""
    from repro.core import PooledExecutor as JExecutor
    from repro.data import split_kg as j_split
    from repro.sampling import OnlineSampler as JSampler
    from repro.training import evaluate as j_eval
    from repro_torch.core import PooledExecutor
    from repro_torch.data import split_kg as t_split
    from repro_torch.sampling import OnlineSampler as TSampler
    from repro_torch.training import evaluate as t_eval

    jm, jp, tm, tp = carried_models(name)
    jkg, tkg = graphs()
    jtrain, _, _ = j_split(jkg)
    ttrain, _, _ = t_split(tkg)
    pats = ("1p", "2p", "2i", "ip", "2u", "2in")
    jq = [b.query for b in JSampler(jtrain, patterns=pats, seed=4).sample_batch(16)]
    tq = [b.query for b in TSampler(ttrain, patterns=pats, seed=4).sample_batch(16)]
    want = j_eval(jm, jp, JExecutor(jm, b_max=16), jkg, jq, train_kg=jtrain, batch_size=8)
    got = t_eval(tm, tp, PooledExecutor(tm, b_max=16, device="cpu"), tkg, tq,
                 train_kg=ttrain, batch_size=8)
    assert set(got) == set(want) and "hard_mrr" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


# ------------------------------------------------------------- checkpoints
def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the reference trainer writes restores into the port's
    trainer exactly, and one the port writes into the reference's."""
    jt, tt, _, _ = _trainers("gqe", steps=2, n_batches=1)
    from repro.training.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
    from repro_torch.training.checkpoint import (load_checkpoint as t_load,
                                                 save_checkpoint as t_save)

    j_save(str(tmp_path / "j"), 2, {"params": jt.params, "opt": jt.opt_state})
    step, tree, _ = t_load(str(tmp_path / "j"), template={"params": tt.params,
                                                          "opt": tt.opt_state})
    assert step == 2 and tree["opt"]["step"].dtype == torch.int32
    for k, v in jt.params.items():
        np.testing.assert_array_equal(tree["params"][k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(tree["opt"]["m"][k].numpy(), np.asarray(jt.opt_state["m"][k]))
    t_save(str(tmp_path / "t"), 2, {"params": tt.params, "opt": tt.opt_state},
           metadata={"loss": 1.5})
    step, tree, meta = j_load(str(tmp_path / "t"), template={"params": jt.params,
                                                             "opt": jt.opt_state})
    assert step == 2 and meta == {"loss": 1.5}
    for k, v in tt.params.items():
        np.testing.assert_array_equal(np.asarray(tree["params"][k]), v.numpy())
        np.testing.assert_array_equal(np.asarray(tree["opt"]["v"][k]), tt.opt_state["v"][k].numpy())
    assert int(tree["opt"]["step"]) == int(tt.opt_state["step"]) == 2


def test_resume_restores_the_trainer(tmp_path):
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(80, 5, 600, seed=0)
    cfg = TrainConfig(batch_size=16, n_negatives=4, b_max=8, patterns=("1p", "2i"),
                      adam=AdamConfig(lr=1e-2), checkpoint_dir=str(tmp_path),
                      checkpoint_every=2)
    a = NGDBTrainer(make_model("betae", ModelConfig(dim=8), device="cpu"), kg, cfg)
    assert not a.resume()
    a.train(3, log_every=0)
    b = NGDBTrainer(make_model("betae", ModelConfig(dim=8), device="cpu"), kg,
                    dataclasses.replace(cfg, seed=5))
    assert b.resume() and b.step == 3 and int(b.opt_state["step"]) == 3
    for k in a.params:
        torch.testing.assert_close(b.params[k], a.params[k], rtol=0, atol=0)
        torch.testing.assert_close(b.opt_state["v"][k], a.opt_state["v"][k], rtol=0, atol=0)


def test_quickstart_trains_on_cpu(capsys):
    from repro_torch.launch import quickstart

    metrics = quickstart.main(["--device", "cpu", "--steps", "4", "--dim", "8"])
    out = capsys.readouterr().out
    assert "KG:" in out and "mrr" in metrics and np.isfinite(metrics["mrr"])


def test_quickstart_needs_a_gpu_unless_told_cpu(monkeypatch):
    from repro_torch.launch import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--steps", "1"])
