"""The port's kernel wrappers against the JAX package's Pallas kernels (in
interpret mode), at the shapes of tests/test_kernels.py, and the dispatch and
guard rules of the wrappers. The CUDA kernels themselves are tested on the
card by tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

SCORING_SHAPES = [(8, 64, 32), (70, 333, 96), (128, 256, 128)]
INTERSECT_SHAPES = [(16, 2, 32, 64), (100, 3, 64, 128), (64, 4, 128, 128)]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "float32":
        return jnp.asarray(a), torch.from_numpy(a)
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _intersect_inputs(n, k, d, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k, d)).astype(np.float32),
            (rng.normal(size=(d, hd)) * 0.2).astype(np.float32),
            (rng.normal(size=(hd,)) * 0.1).astype(np.float32),
            (rng.normal(size=(hd, 1)) * 0.2).astype(np.float32),
            np.zeros((1,), np.float32))


@pytest.mark.parametrize("B,N,d", SCORING_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dot", "l1"])
def test_scoring_matches_pallas(B, N, d, dtype, mode):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(B, d)).astype(np.float32), dtype)
    je, te = _pair(rng.normal(size=(N, d)).astype(np.float32), dtype)
    want = np.asarray(jops.scoring(jq, je, gamma=1.5, mode=mode, interpret=True))
    before = tops.scoring.launches
    got = tops.scoring(tq, te, gamma=1.5, mode=mode)
    assert tops.scoring.launches == before  # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == (B, N)
    # The Pallas kernel and the port both upcast the same (bf16-rounded)
    # inputs and sum in fp32, so bf16 is held to the fp32 tolerance too.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * d)


@pytest.mark.parametrize("n,k,d,hd", INTERSECT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_intersect_matches_pallas(n, k, d, hd, dtype):
    x, w1, b1, w2, b2 = _intersect_inputs(n, k, d, hd)
    jx, tx = _pair(x, dtype)
    want = np.asarray(jops.intersect(jx, jnp.asarray(w1), jnp.asarray(b1),
                                     jnp.asarray(w2), jnp.asarray(b2),
                                     interpret=True), np.float32)
    before = tops.intersect.launches
    got = tops.intersect(tx, *map(torch.from_numpy, (w1, b1, w2, b2)))
    assert tops.intersect.launches == before
    assert got.dtype == tx.dtype and got.shape == (n, d)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["scoring", "intersect"])
def test_wrapper_rejects_tensors_off_cpu_and_cuda(kernel):
    meta = torch.empty((4, 2, 8), device="meta")
    if kernel == "scoring":
        with pytest.raises(ValueError):
            tops.scoring(meta[:, 0], torch.zeros(5, 8))
    else:
        w1, b1, w2, b2 = (torch.zeros(8, 16), torch.zeros(16),
                          torch.zeros(16, 1), torch.zeros(1))
        with pytest.raises(ValueError):
            tops.intersect(meta, w1, b1, w2, b2)


@pytest.mark.parametrize("kernel", ["scoring", "intersect"])
def test_wrapper_on_cuda_tensors_raises_without_cuda(kernel):
    """A wrapper handed CUDA tensors (fake ones: this machine has no card)
    asks for its kernel and raises; it never takes the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    before = (tops.scoring.launches, tops.intersect.launches)
    with FakeTensorMode(), pytest.raises(RuntimeError, match="CUDA is not available"):
        if kernel == "scoring":
            tops.scoring(torch.empty(4, 8, device="cuda"),
                         torch.empty(5, 8, device="cuda"), 1.0, "l1")
        else:
            tops.intersect(torch.empty(3, 2, 8, device="cuda"),
                           torch.empty(8, 16, device="cuda"),
                           torch.empty(16, device="cuda"),
                           torch.empty(16, 1, device="cuda"),
                           torch.empty(1, device="cuda"))
    assert (tops.scoring.launches, tops.intersect.launches) == before


def test_kernel_library_needs_cuda():
    """Asking for the CUDA kernels on a machine without CUDA raises; the
    wrappers never fall back to the plain version for a CUDA request."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.load_library()


def test_library_path_keyed_by_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("librepro_kernels_") and path.suffix == ".so"
    assert {s.name for s in build.sources()} >= {"scoring.cu", "intersect.cu",
                                                 "common.cuh"}

