"""BetaE's all-entity KL score through ``kernels.ops.betae_kl`` on the CPU:
the plain version bit for bit ``gamma - BetaE.distance``, ``BetaE._score``'s
dispatch between the forward-only kernel and the differentiable
``distance``, the meta reckoning and the wrapper's guards. The CUDA kernel
itself is tested on the card by tests/test_torch_gpu.py."""
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import reckon
from repro_torch.models import ModelConfig, make_model

torch.set_num_threads(1)


def _betae(dim, n_entities=60, seed=0):
    model = make_model("betae", ModelConfig(dim=dim), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(seed), n_entities, 7)
    return model, params


def _states(B, d, seed=1, extreme=False):
    """Query states as the operators leave them (in the clip range), or with
    columns past both clip ends."""
    g = torch.Generator().manual_seed(seed)
    q = torch.rand((B, 2 * d), generator=g) * 3.0 + 0.05
    if extreme:
        q[:, ::5] = 45.0
        q[:, 1::5] = 0.01
    return q


# (B, dim, extreme): a single query, a micro-batch of 16, evaluation's 64, a
# ragged width, and entity rows whose (alpha, beta) sit at both clip ends.
SHAPES = [(1, 16, False), (16, 16, False), (64, 8, False), (5, 33, True), (16, 400, False)]


@pytest.mark.parametrize("B,dim,extreme", SHAPES)
def test_betae_kl_on_cpu_is_bitwise_distance(B, dim, extreme):
    model, params = _betae(dim)
    ev = params["entity"]
    if extreme:
        ev = ev.clone()
        ev[::3] *= 60.0
    q = _states(B, dim, extreme=extreme)
    want = model.cfg.gamma - model.distance(params, q[:, None, :], ev[None, :, :])
    got = kops.betae_kl(q, ev, gamma=model.cfg.gamma)
    assert got.dtype == torch.float32 and got.shape == (B, ev.shape[0])
    assert torch.equal(got, want)
    assert torch.equal(kops.betae_kl_ref(q, ev, model.cfg.gamma), want)


@pytest.mark.parametrize("how", ["no_grad", "inference_mode", "grad_on_plain_inputs"])
def test_betae_score_takes_the_kernel_when_no_gradient_is_needed(monkeypatch, how):
    model, params = _betae(16)
    q = _states(4, 16)
    calls = []
    real = kops.betae_kl
    monkeypatch.setattr(kops, "betae_kl", lambda *a, **k: calls.append(a) or real(*a, **k))
    want = model.cfg.gamma - model.distance(params, q[:, None, :], params["entity"][None])
    if how == "no_grad":
        with torch.no_grad():
            got = model.score_all(params, q)
    elif how == "inference_mode":
        with torch.inference_mode():
            got = model.score_all(params, q)
    else:
        got = model.score_all(params, q)
    assert len(calls) == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["q", "entity"])
def test_betae_score_keeps_distance_when_an_input_requires_grad(monkeypatch, which):
    model, params = _betae(16)
    q = _states(4, 16)
    if which == "q":
        q.requires_grad_(True)
    else:
        params = {**params, "entity": params["entity"].clone().requires_grad_(True)}
    calls = []
    monkeypatch.setattr(kops, "betae_kl", lambda *a, **k: calls.append(a))
    scores = model.score_all(params, q)
    scores.sum().backward()
    assert calls == []
    grad = q.grad if which == "q" else params["entity"].grad
    assert grad is not None and torch.isfinite(grad).all() and grad.abs().sum() > 0


@pytest.mark.parametrize("chunk", [16, 25])
def test_betae_chunked_rows_through_the_kernel_entry(monkeypatch, chunk):
    """The out-of-core path scores each chunk of rows (the structural slices
    alone here) through ``betae_kl``, and agrees with the all-entity score.
    The CPU's plain sum may take another order for another row count, so the
    bits are held on the card (tests/test_torch_gpu.py)."""
    model, params = _betae(16, n_entities=60)
    q = _states(8, 16)
    calls = []
    real = kops.betae_kl
    monkeypatch.setattr(kops, "betae_kl", lambda *a, **k: calls.append(a[1].shape[0])
                        or real(*a, **k))
    with torch.no_grad():
        full = model.score_all(params, q)
        rows = model.score_rows_chunked(params, q, None, 0, 60, chunk=chunk)
    assert calls == [60] + [min(chunk, 60 - a) for a in range(0, 60, chunk)]
    torch.testing.assert_close(rows, full, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", ["q2b", "q2p", "fuzzqe"])
def test_other_distance_families_keep_the_base_score(monkeypatch, name):
    model = make_model(name, ModelConfig(dim=8), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), 30, 4)
    q = torch.rand((3, model.state_dim))
    calls = []
    monkeypatch.setattr(kops, "betae_kl", lambda *a, **k: calls.append(a))
    with torch.no_grad():
        got = model.score_all(params, q)
    assert calls == [] and got.shape == (3, 30)


@pytest.mark.parametrize("B,N,d", [(16, 14951, 400), (64, 4096, 400), (0, 10, 8), (3, 0, 8)])
def test_betae_kl_on_meta_reckons_and_launches_nothing(B, N, d):
    seen = []
    saved, reckon.HOOK = reckon.HOOK, lambda *a: seen.append(a)
    before = kops.betae_kl.launches
    try:
        out = kops.betae_kl(torch.empty((B, 2 * d), device="meta"),
                            torch.empty((N, d), device="meta"), 12.0)
    finally:
        reckon.HOOK = saved
    assert out.device.type == "meta" and out.shape == (B, N) and out.dtype == torch.float32
    assert seen == [("betae_kl", float(4 * B * N * d),
                     float((B * 2 * d + N * d) * 4 + B * N * 4))]
    assert kops.betae_kl.launches == before


@pytest.mark.parametrize("q_shape,ev_shape", [((4, 16), (5, 16)), ((4, 16, 1), (5, 8)),
                                              ((4, 0), (5, 0)), ((4, 17), (5, 8))])
def test_betae_kl_rejects_shapes_it_does_not_take(q_shape, ev_shape):
    with pytest.raises(ValueError, match="q \\[B, 2d\\] and ev \\[N, d\\]"):
        kops.betae_kl(torch.zeros(q_shape), torch.zeros(ev_shape))


def test_betae_kl_empty_batch_on_cpu():
    ev = torch.randn(9, 8)
    assert kops.betae_kl(torch.zeros((0, 16)), ev).shape == (0, 9)
    assert kops.betae_kl(torch.rand((3, 16)), ev[:0]).shape == (3, 0)
