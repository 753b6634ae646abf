"""The port's CUDA kernels and GPU serving path on the card. Every test here
needs a CUDA device and skips without one; this file imports no JAX, so it
runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.base import glorot

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    """The card; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,d", [(1, 14951, 400), (16, 14951, 400), (70, 333, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dot", "l1"])
def test_scoring_kernel_matches_plain(dev, B, N, d, dtype, mode):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, d), generator=g, device=dev).to(dtype)
    e = torch.randn((N, d), generator=g, device=dev).to(dtype)
    before = kops.scoring.launches
    got = kops.scoring(q, e, gamma=12.0, mode=mode)
    torch.cuda.synchronize()
    assert kops.scoring.launches == before + 1
    want = kops.scoring_ref(q, e, gamma=12.0, mode=mode)
    # Both sides take the same (bf16-rounded) inputs and sum in fp32, so bf16
    # is held to the fp32 tolerance too.
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d)


@pytest.mark.parametrize("n,k,d,hd", [(16, 2, 800, 800), (256, 3, 800, 800),
                                      (100, 3, 64, 128), (5, 8, 96, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intersect_kernel_matches_plain(dev, n, k, d, hd, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    # BetaE-like inputs: positive Beta parameters, the model's initializer.
    x = (torch.nn.functional.softplus(
        torch.randn((n, k, d), generator=g, device=dev) / 10) + 0.05).to(dtype)
    w1, w2 = glorot((d, hd), g, dev), glorot((hd, 1), g, dev)
    b1 = 0.1 * torch.randn((hd,), generator=g, device=dev)
    b2 = torch.zeros((1,), device=dev)
    before = kops.intersect.launches
    got = kops.intersect(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert kops.intersect.launches == before + 1
    want = kops.intersect_ref(x, w1, b1, w2, b2)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_kernels_reject_what_they_do_not_take(dev):
    q = torch.randn(4, 8, device=dev)
    with pytest.raises(TypeError):
        kops.scoring(q, torch.randn(5, 8, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        kops.scoring(q, torch.randn(8, 5, device=dev).T)       # not contiguous
    with pytest.raises(ValueError):
        kops.scoring(q, torch.randn(5, 8))                      # mixed devices
    w1, b1 = torch.randn(8, 4, device=dev), torch.randn(4, device=dev)
    w2, b2 = torch.randn(4, 1, device=dev), torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        kops.intersect(torch.randn(3, 9, 8, device=dev), w1, b1, w2, b2)  # k > 8


@pytest.mark.parametrize("name", ["betae", "gqe", "complex"])
def test_engine_on_gpu_matches_cpu_plain_path(dev, name):
    """A small GPU engine run replays identically through serve_batch and
    agrees with the same weights served on the CPU through the plain
    versions."""
    from repro_torch.core import PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import ModelConfig, make_model, params_from_numpy
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     check_against_offline, make_workload)

    kg = generate_synthetic_kg(300, 12, 3000, seed=0)
    cfg = ModelConfig(dim=32)
    model = make_model(name, cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               kg.n_entities, kg.n_relations)
    ex = PooledExecutor(model, b_max=16, device=dev)
    queries = make_workload(kg, 40, seed=3)
    kops.scoring.launches = kops.intersect.launches = 0
    with ServingEngine(model, params, executor=ex, device=dev,
                       cfg=ServingConfig(max_batch=8, record_batches=True)) as eng:
        results = [f.result(timeout=120) for f in eng.submit_many(queries)]
    launched = kops.intersect.launches if name == "betae" else kops.scoring.launches
    assert launched > 0
    check_against_offline(eng.batch_log, lambda qs: serve_batch(
        model, params, ex, qs, top_k=10, device=dev)[0])
    cpu_model = make_model(name, cfg, device="cpu")
    cpu_params = params_from_numpy(cpu_model, {k: v.cpu().numpy()
                                               for k, v in params.items()})
    cpu_res, _ = serve_batch(cpu_model, cpu_params,
                             PooledExecutor(cpu_model, b_max=16, device="cpu"),
                             queries, top_k=10, device="cpu")
    for got, want in zip(results, cpu_res):
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   rtol=1e-4, atol=2e-3)
