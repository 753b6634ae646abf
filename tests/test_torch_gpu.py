"""The port's CUDA kernels and GPU serving path on the card. Every test here
needs a CUDA device and skips without one; this file imports no JAX, so it
runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gather_fuse as gf
from repro_torch.kernels import ops as kops
from repro_torch.kernels.intersect import backward_shares
from repro_torch.kernels.scoring import TILES
from repro_torch.kernels.timing import fuse_backward_inputs, intersect_inputs, stream_read
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


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """The same values as a contiguous tensor whose storage starts one
    element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# (B, N, d, misaligned): the serving shapes (one query, a micro-batch of 16,
# a 4,096-row store chunk), several query tiles, ragged d, and tables the
# 16-byte copies cannot take (d = 33; a table one element off a boundary).
SCORING_SHAPES = [(1, 14951, 400, False), (16, 14951, 400, False),
                  (16, 4096, 400, False), (70, 333, 96, False), (5, 333, 33, False),
                  (16, 333, 33, True), (16, 4096, 400, True)]


@pytest.mark.parametrize("B,N,d,misaligned", SCORING_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dot", "l1"])
def test_scoring_kernel_matches_plain(dev, B, N, d, misaligned, dtype, mode):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, d), generator=g, device=dev).to(dtype)
    e = torch.randn((N, d), generator=g, device=dev).to(dtype)
    if misaligned:
        e = _misaligned(e)
        assert not kops.scoring_aligned(e)
    elif d % (16 // e.element_size()) == 0:
        assert kops.scoring_aligned(e)
    before = kops.scoring.launches
    got = kops.scoring(q, e, gamma=12.0, mode=mode)
    torch.cuda.synchronize()
    assert kops.scoring.launches == before + 1
    want = kops.scoring_ref(q, e, gamma=12.0, mode=mode)
    # Both sides take the same (bf16-rounded) inputs and sum in fp32, so bf16
    # is held to the fp32 tolerance too.
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dot", "l1"])
def test_scoring_rows_do_not_depend_on_their_launch(dev, dtype, mode):
    """A score's bits depend only on its query row, its entity row, d and
    the dtype: a 4,096-row chunk (as the out-of-core path scores) equals
    those columns of the all-entity launch under either tiling and from a
    table off 16-byte boundaries (the element-load variant), and a query
    scored alone equals its row in a batch of 16."""
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((16, 400), generator=g, device=dev).to(dtype)
    e = torch.randn((14951, 400), generator=g, device=dev).to(dtype)
    full = kops.scoring(q, e, gamma=12.0, mode=mode)
    for tile in TILES:
        assert torch.equal(kops.scoring(q, e, 12.0, mode, tile=tile), full)
    for lo in (0, 8192, 12288):
        hi = min(lo + 4096, e.shape[0])
        chunk = kops.scoring(q, e[lo:hi], gamma=12.0, mode=mode)
        assert torch.equal(chunk, full[:, lo:hi])
        for tile in TILES:
            assert torch.equal(kops.scoring(q, e[lo:hi], 12.0, mode, tile=tile),
                               full[:, lo:hi])
        off = _misaligned(e[lo:hi])
        assert not kops.scoring_aligned(off)
        assert torch.equal(kops.scoring(q, off, gamma=12.0, mode=mode), full[:, lo:hi])
    for b in (0, 5, 15):
        alone = kops.scoring(q[b:b + 1].contiguous(), e, gamma=12.0, mode=mode)
        assert torch.equal(alone, full[b:b + 1])


@pytest.mark.parametrize("B,N,d,misaligned", [(70, 333, 96, False), (5, 333, 33, False),
                                              (16, 333, 33, True), (16, 4096, 400, False),
                                              (16, 14951, 400, True)])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dot", "l1"])
def test_scoring_each_tiling_matches_plain(dev, B, N, d, misaligned, tile, dtype, mode):
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((B, d), generator=g, device=dev).to(dtype)
    e = torch.randn((N, d), generator=g, device=dev).to(dtype)
    if misaligned:
        e = _misaligned(e)
    got = kops.scoring(q, e, 12.0, mode, tile=tile)
    torch.cuda.synchronize()
    want = kops.scoring_ref(q, e, gamma=12.0, mode=mode)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d)


@pytest.mark.parametrize("N", [333, 4096, 8448, 8449, 14951])
def test_scoring_tile_follows_rows_per_block(dev, N):
    """The narrow tiling where one block per SM would own at most 64 rows
    (a 4,096-row store chunk), the wide one above (the all-entity launch)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = 4 if -(-N // sms) <= 64 else 16
    assert kops.scoring_tile(torch.empty((N, 8), device=dev)) == want


@pytest.mark.parametrize("n", [0, 4, 4096 * 400, 14951 * 400])
def test_stream_read_sums_every_element(dev, n):
    """The read floor's kernel reads each element once: its partial sums
    add up to the tensor's sum, and an empty tensor gives zeros."""
    g = torch.Generator(device=dev).manual_seed(3)
    t = torch.rand((n + 4,), generator=g, device=dev)[:n]
    part = stream_read(t)
    assert part.shape == (torch.cuda.get_device_properties(dev).multi_processor_count,)
    torch.testing.assert_close(part.double().sum(), t.double().sum(), rtol=1e-5, atol=1e-6)
    if n:  # an empty tensor reads nothing, wherever it starts
        with pytest.raises(ValueError):
            stream_read(torch.rand((n + 4,), generator=g, device=dev)[1:n + 1])


def _intersect_inputs(dev, n, k, d, hd, dtype, seed=0):
    """BetaE-like inputs: positive Beta parameters, the model's initializer."""
    return intersect_inputs(n, k, d, hd, dtype, torch.Generator(device=dev).manual_seed(seed))


def _intersect_tol(dtype):
    # tests/test_kernels.py:32: fp32 1e-5; bf16 1e-2, a few bf16 steps of an
    # output near 1 (both sides take the same bf16 x and compute in fp32).
    return 1e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.parametrize("n,k,d,hd", [(16, 2, 800, 800), (256, 3, 800, 800),
                                      (100, 3, 64, 128), (5, 8, 96, 40),
                                      (8, 2, 800, 800), (512, 3, 800, 800)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intersect_kernel_matches_plain(dev, n, k, d, hd, dtype):
    x, w1, b1, w2, b2 = _intersect_inputs(dev, n, k, d, hd, dtype)
    before = kops.intersect.launches
    got = kops.intersect(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert kops.intersect.launches == before + 1
    want = kops.intersect_ref(x, w1, b1, w2, b2)
    tol = _intersect_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 12])
@pytest.mark.parametrize("n,d,hd", [(16, 800, 800), (300, 800, 800), (7, 33, 40),
                                    (70, 96, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intersect_any_k_matches_plain(dev, k, n, d, hd, dtype):
    """Any k (beyond 8 too; beyond a 64-row group at n = 300, k = 12),
    ragged d and hd (no 16-byte copies: d = 33) and hidden widths that end
    inside a tile."""
    x, w1, b1, w2, b2 = _intersect_inputs(dev, n, k, d, hd, dtype, seed=k)
    before = kops.intersect.launches
    got = kops.intersect(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert kops.intersect.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    want = kops.intersect_ref(x, w1, b1, w2, b2)
    tol = _intersect_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intersect_rows_do_not_depend_on_their_pool(dev, k, dtype):
    """A row's bits depend only on its own k inputs and the MLP: the row
    alone equals the same row first, in the middle and last of pools of
    1, 8, 16, 256 and 512 rows."""
    d = hd = 800
    pool, w1, b1, w2, b2 = _intersect_inputs(dev, 512, k, d, hd, dtype)
    row = pool[:1].clone()
    alone = kops.intersect(row, w1, b1, w2, b2)
    for n in (1, 8, 16, 256, 512):
        for place in sorted({0, n // 2, n - 1}):
            x = pool[:n].clone()
            x[place] = row[0]
            got = kops.intersect(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            assert torch.equal(got[place:place + 1], alone), (n, place)


@pytest.mark.parametrize("n,k,d,hd", [(8, 2, 800, 800), (512, 3, 800, 800), (7, 12, 33, 40),
                                      (70, 3, 96, 72)])
def test_intersect_bf16_is_the_fp32_result_rounded_once(dev, n, k, d, hd):
    """bf16 x loads exactly into fp32 and takes the fp32 arithmetic, so the
    bf16 output is the fp32 kernel's output on the same (bf16-rounded) x,
    rounded once to bf16."""
    x, w1, b1, w2, b2 = _intersect_inputs(dev, n, k, d, hd, torch.bfloat16)
    got = kops.intersect(x, w1, b1, w2, b2)
    want = kops.intersect(x.float(), w1, b1, w2, b2).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_intersect_empty_pool_launches_nothing(dev):
    _, w1, b1, w2, b2 = _intersect_inputs(dev, 1, 2, 800, 800, torch.float32)
    before = kops.intersect.launches
    out = kops.intersect(torch.empty((0, 2, 800), device=dev), w1, b1, w2, b2)
    assert out.shape == (0, 800) and kops.intersect.launches == before


def test_intersect_leaves_its_arrival_counters_zero(dev):
    """The last arrival of each row group resets its counter, so the
    stream's counter buffer is all zero after any mix of launches."""
    from repro_torch.kernels import intersect as its
    for n, k in ((8, 2), (512, 3), (300, 12), (3, 70)):
        args = _intersect_inputs(dev, n, k, 96, 64, torch.float32)
        kops.intersect(*args)
        torch.cuda.synchronize()
        counters = its._counters[(dev.index or 0, torch.cuda.current_stream().cuda_stream)]
        assert int(counters.abs().sum()) == 0, (n, k)


def test_intersect_refuses_a_row_whose_logits_do_not_fit(dev):
    """A pool row's k logits must fit a block's shared memory: k = 80,000
    is refused by the launch, and nothing is counted."""
    _, w1, b1, w2, b2 = _intersect_inputs(dev, 1, 1, 8, 4, torch.float32)
    before = kops.intersect.launches
    with pytest.raises(RuntimeError, match="intersect"):
        kops.intersect(torch.rand((1, 80_000, 8), device=dev), w1, b1, w2, b2)
    assert kops.intersect.launches == before


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
    x = torch.rand(3, 9, 8, device=dev)  # k = 9: taken, as on the CPU
    torch.testing.assert_close(kops.intersect(x, w1, b1, w2, b2),
                               kops.intersect_ref(x, w1, b1, w2, b2), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="k, d and hd"):
        kops.intersect(torch.randn(3, 0, 8, device=dev), w1, b1, w2, b2)


# The backward's shapes: the pools BetaE training gives it (n = 32 to 512;
# k = 2, 3; d = hd = 800), a ragged n, k = 1 and k = 12, a pool row wider than
# a 64-row group (k = 70), and widths that end inside a tile (d = 33: no
# 16-byte loads).
BACKWARD_SHAPES = [(32, 2, 800, 800), (64, 2, 800, 800), (64, 3, 800, 800),
                   (128, 2, 800, 800), (128, 3, 800, 800), (256, 2, 800, 800),
                   (256, 3, 800, 800), (512, 2, 800, 800), (512, 3, 800, 800),
                   (77, 3, 800, 800), (16, 1, 800, 800), (16, 12, 800, 800),
                   (70, 3, 96, 72), (5, 2, 33, 40), (3, 70, 96, 64)]


def _backward_inputs(dev, n, k, d, hd, seed=0):
    x, w1, b1, w2, b2 = _intersect_inputs(dev, n, k, d, hd, torch.float32, seed=seed)
    g = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(seed + 1),
                    device=dev)
    return x, w1, b1, w2, b2, g


@pytest.mark.parametrize("n,k,d,hd", BACKWARD_SHAPES)
def test_intersect_backward_matches_plain(dev, n, k, d, hd):
    """Each gradient against the plain version on fp64 inputs within
    1e-4·|exact| + the allowance of ``intersect_backward_allowance`` an
    element (1e-5 of the magnitudes of the terms it adds up, and what a relu
    within rounding of 0 may add: sums of dL/dlogit cancel, so an fp32
    backward's error is no small share of the result's own size)."""
    args = _backward_inputs(dev, n, k, d, hd)
    before = kops.intersect_backward.launches
    got = kops.intersect_backward(*args)
    torch.cuda.synchronize()
    assert kops.intersect_backward.launches == before + 1
    exact = kops.intersect_backward_ref(*(t.double() for t in args))
    allowed = kops.intersect_backward_allowance(*args)
    for name, a, e, al in zip(("dx", "dw1", "db1", "dw2", "db2"), got, exact, allowed):
        assert a.shape == e.shape and a.dtype == torch.float32, name
        excess = (a.double() - e).abs() - (1e-4 * e.abs() + al)
        assert float(excess.max()) <= 0, (name, float(excess.max()))


@pytest.mark.parametrize("n,k", [(512, 3), (77, 3), (16, 12)])
def test_intersect_backward_repeats_bitwise(dev, n, k):
    args = _backward_inputs(dev, n, k, 800, 800, seed=3)
    first = kops.intersect_backward(*args)
    second = kops.intersect_backward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [2, 3])
def test_intersect_backward_dx_rows_do_not_depend_on_their_pool(dev, k):
    """A pool row's dx bits depend only on its own k inputs, its row of g and
    the MLP (every sum's chunks are fixed by d and hd): alone, it equals
    itself first, in the middle and last of pools of 64 and 512 rows."""
    x, w1, b1, w2, b2, g = _backward_inputs(dev, 512, k, 800, 800, seed=11)
    alone = kops.intersect_backward(x[:1].clone(), w1, b1, w2, b2, g[:1].clone())[0]
    for n in (64, 512):
        for place in sorted({0, n // 2, n - 1}):
            xs, gs = x[:n].clone(), g[:n].clone()
            xs[place], gs[place] = x[0], g[0]
            dx = kops.intersect_backward(xs, w1, b1, w2, b2, gs)[0]
            torch.cuda.synchronize()
            assert torch.equal(dx[place:place + 1], alone), (n, place)


def _counter_buffers():
    from repro_torch.kernels import intersect as its
    return [*its._counters.values(), *its._backward_counters.values()]


@pytest.mark.parametrize("n,k", [(8, 2), (512, 3), (300, 12), (3, 70)])
def test_intersect_backward_leaves_its_arrival_counters_zero(dev, n, k):
    """The last cluster of each row group resets its counter: after any
    launch every counter buffer, the backward's and the forward's, is zero."""
    kops.intersect_backward(*_backward_inputs(dev, n, k, 96, 64))
    torch.cuda.synchronize()
    assert all(int(b.abs().sum()) == 0 for b in _counter_buffers())


def test_intersect_backward_on_two_streams_matches_serial(dev):
    """The backward on two streams at once, with the forward interleaved on
    both, gives the bits of serial calls on one stream, and leaves every
    counter buffer (per stream, the forward's and the backward's) at zero."""
    cases = [_backward_inputs(dev, n, k, 800, 800, seed=7 + i)
             for i, (n, k) in enumerate(((64, 2), (128, 3)))]
    serial = [(kops.intersect(*c[:5]), kops.intersect_backward(*c)) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    runs = []
    for _ in range(4):
        for s, c in zip(streams, cases):
            with torch.cuda.stream(s):
                runs.append((kops.intersect(*c[:5]), kops.intersect_backward(*c)))
    torch.cuda.synchronize()
    for i, (fwd, grads) in enumerate(runs):
        want_fwd, want_grads = serial[i % len(cases)]
        assert torch.equal(fwd, want_fwd), i
        for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want_grads):
            assert torch.equal(a, b), (i, name)
    assert all(int(b.abs().sum()) == 0 for b in _counter_buffers())


def test_intersect_autograd_runs_both_kernels(dev):
    """On the card, autograd through ``intersect`` launches the forward
    kernel once and the backward kernel once, and its gradients are the
    backward kernel's."""
    x, w1, b1, w2, b2, g = _backward_inputs(dev, 64, 3, 800, 800, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    f0, b0 = kops.intersect.launches, kops.intersect_backward.launches
    out = kops.intersect(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (kops.intersect.launches - f0, kops.intersect_backward.launches - b0) == (1, 1)
    for a, b in zip(grads, kops.intersect_backward(x, w1, b1, w2, b2, g)):
        assert torch.equal(a, b)


def test_intersect_backward_rejects_what_it_does_not_take(dev):
    x, w1, b1, w2, b2, g = _backward_inputs(dev, 8, 2, 64, 32)
    before = kops.intersect_backward.launches
    with pytest.raises(TypeError, match="float32"):
        kops.intersect_backward(x.bfloat16(), w1, b1, w2, b2, g)
    with pytest.raises(TypeError, match="float32"):
        kops.intersect_backward(x, w1, b1, w2, b2, g.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        kops.intersect_backward(x.transpose(0, 1).contiguous().transpose(0, 1),
                                w1, b1, w2, b2, g)
    with pytest.raises(ValueError, match="contiguous"):
        kops.intersect_backward(x, w1, b1, w2, b2, g.T.contiguous().T)
    with pytest.raises(ValueError, match="one CUDA device"):
        kops.intersect_backward(x, w1, b1, w2, b2, g.cpu())
    with pytest.raises(ValueError, match=r"need g \[8, 64\]"):
        kops.intersect_backward(x, w1, b1, w2, b2, g[:4])
    assert kops.intersect_backward.launches == before
    # bf16 x trains nothing: its forward runs, its backward raises.
    xb = x.bfloat16().requires_grad_(True)
    with pytest.raises(TypeError, match="float32"):
        kops.intersect(xb, w1, b1, w2, b2).float().sum().backward()


def _fuse_inputs(dev, E, d, dl, dp, n, table_dtype=torch.float32, seed=0):
    """Tables, ids and the model's own initializers for gather_fuse."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, E, (n,), generator=g, device=dev)
    h_str = (torch.randn((E, d), generator=g, device=dev) / d ** 0.5).to(table_dtype)
    h_sem = torch.nn.functional.normalize(
        torch.randn((E, dl), generator=g, device=dev), dim=1).to(table_dtype)
    wp, wf = glorot((dl, dp), g, dev), glorot((d + dp, d), g, dev)
    bp = 0.1 * torch.randn((dp,), generator=g, device=dev)
    bf = 0.1 * torch.randn((d,), generator=g, device=dev)
    return ids, h_str, h_sem, wp, bp, wf, bf


# (E, d, dl, dp, n): all-entity fusion, a store chunk, the last (2,663-row)
# chunk of FB15k, 48 anchor rows, one row, ragged.
FUSE_SHAPES = [(14951, 400, 1024, 64, 14951), (4096, 400, 1024, 64, 4096),
               (14951, 400, 1024, 64, 2663), (14951, 400, 1024, 64, 48),
               (14951, 400, 1024, 64, 1), (100, 64, 128, 32, 33),
               (40, 16, 32, 16, 8)]


@pytest.mark.parametrize("E,d,dl,dp,n", FUSE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_fuse_kernel_matches_plain(dev, E, d, dl, dp, n, dtype):
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, d, dl, dp, n, dtype)
    before = kops.gather_fuse.launches
    got = kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf)
    torch.cuda.synchronize()
    assert kops.gather_fuse.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    want = kops.gather_fuse_ref(ids, h_str, h_sem, wp, bp, wf, bf)
    # fp32: tests/test_kernels.py:51. bf16 tables: both sides sum the same
    # bf16 inputs in fp32 and round the output in [-1, 1] to bf16, so they
    # may differ by one bf16 step (2**-8 just below 1).
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_gather_fuse_rows_do_not_depend_on_their_batch(dev):
    """A row's bits are the same whatever rows share its launch, and whether
    its semantic row comes from the full table, from hot-set slots or from a
    streamed chunk. All of FB15k's rows take the kernel whose blocks share
    one stream of weights between two row tiles; the 48-row launches and
    the chunks take the one whose two consumers split a tile's work."""
    E, d, dl, dp = 14951, 400, 1024, 64
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, d, dl, dp, E)
    full = kops.gather_fuse(torch.arange(E, device=dev), h_str, h_sem, wp, bp, wf, bf)
    lo, hi = 8192, 8192 + 4096
    chunk = kops.gather_fuse(torch.arange(lo, hi, device=dev), h_str,
                             h_sem[lo:hi].clone(), wp, bp, wf, bf,
                             sem_ids=torch.arange(hi - lo, device=dev))
    last = E - 2663  # FB15k's last 4,096-row chunk holds 2,663 rows
    tail = kops.gather_fuse(torch.arange(last, E, device=dev), h_str,
                            h_sem[last:].clone(), wp, bp, wf, bf,
                            sem_ids=torch.arange(E - last, device=dev))
    some = ids[:48]
    alone = kops.gather_fuse(some, h_str, h_sem, wp, bp, wf, bf)
    # A hot set holding those rows at other slots, in another order.
    slots = torch.randperm(64, device=dev)[:48]
    cache = torch.zeros((64, dl), device=dev)
    cache[slots] = h_sem[some]
    cached = kops.gather_fuse(some, h_str, cache, wp, bp, wf, bf, sem_ids=slots)
    torch.cuda.synchronize()
    assert torch.equal(alone, full[some])
    assert torch.equal(cached, full[some])
    assert torch.equal(chunk, full[lo:hi])
    assert torch.equal(tail, full[last:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_fuse_rows_do_not_depend_on_their_place_in_a_tile(dev, dtype):
    """The kernel multiplies 16-row fragments on the tensor cores. Shifting
    the ids by 1..15 puts every row at each place inside its fragment (and
    the 48-row launches split the columns over blocks): its bits stay those
    of the all-entity launch."""
    E, d, dl, dp = 14951, 400, 1024, 64
    _, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, d, dl, dp, 1, dtype)
    full = kops.gather_fuse(torch.arange(E, device=dev), h_str, h_sem, wp, bp, wf, bf)
    for shift in range(1, 16):
        ids = torch.arange(shift, E, device=dev)
        few = torch.arange(1000 + shift, 1048 + shift, device=dev)
        got = kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf)
        got_few = kops.gather_fuse(few, h_str, h_sem, wp, bp, wf, bf)
        torch.cuda.synchronize()
        assert torch.equal(got, full[shift:]), shift
        assert torch.equal(got_few, full[few]), shift


def test_gather_fuse_out_of_range_id_gives_a_nan_row(dev):
    """An id outside its table (either index) gives a NaN row; the other rows
    keep the bits they have in the all-entity launch."""
    E, d, dl, dp = 14951, 400, 1024, 64
    _, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, d, dl, dp, 1)
    full = kops.gather_fuse(torch.arange(E, device=dev), h_str, h_sem, wp, bp, wf, bf)
    ids = torch.arange(100, 170, device=dev)
    sem_ids = ids.clone()
    ids[3], ids[40] = E + 5, -1
    sem_ids[17] = E
    got = kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=sem_ids)
    torch.cuda.synchronize()
    bad = torch.zeros(70, dtype=torch.bool, device=dev)
    bad[[3, 17, 40]] = True
    assert torch.isnan(got[bad]).all()
    assert torch.equal(got[~bad], full[100:170][~bad])


def test_gather_fuse_entry_takes_a_null_zp(dev):
    """The C entry takes a null zp (serving) or a buffer that receives each
    row's zp (training): the output has the same bits either way."""
    from repro_torch.kernels import build
    E, d, dl, dp, n = 14951, 400, 1024, 64, 4096
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, d, dl, dp, n)
    lib = build.load_library()
    outs = []
    for zp in (None, torch.empty((n, dp), device=dev)):
        out = torch.empty((n, d), device=dev)
        err = lib.repro_gather_fuse(
            ids.data_ptr(), ids.data_ptr(), h_str.data_ptr(), h_sem.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), wf.data_ptr(), bf.data_ptr(),
            None if zp is None else zp.data_ptr(), out.data_ptr(), n, E, E, d, dl,
            dp, 0, 0, build.stream_handle(ids))
        build.check(lib, err, "gather_fuse")
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf))


@pytest.mark.parametrize("n,layout", [(14951, "resident"), (4096, "cache"), (48, "cache"),
                                      (1, "resident")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_fuse_stores_zp_without_changing_out(dev, n, layout, dtype):
    """Given a zp buffer, both forward kernels (two row tiles a block at
    n = E; the split kernel's column pass 0 below) store each row's zp: within
    1e-5 of the plain h_sem[sem_ids]·Wp + bp (on the same table values), and
    the output has the bits of the call without the buffer."""
    E, d, dl, dp = 14951, 400, 1024, 64
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, d, dl, dp, n, dtype)
    sem_ids = None
    if layout == "cache":
        sem_ids = torch.randperm(E, generator=torch.Generator(device=dev).manual_seed(1),
                                 device=dev)[ids]
        h_sem = h_sem.clone()
        h_sem[sem_ids] = h_sem[ids].clone()
    with torch.no_grad():
        plain_out = kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=sem_ids)
    before = kops.gather_fuse.launches
    out, zp = gf.gather_fuse_and_zp(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=sem_ids)
    torch.cuda.synchronize()
    assert kops.gather_fuse.launches == before + 1
    assert torch.equal(out, plain_out)
    rows = h_sem[ids if sem_ids is None else sem_ids].float()
    assert zp.shape == (n, dp) and zp.dtype == torch.float32
    torch.testing.assert_close(zp, rows @ wp + bp, rtol=1e-5, atol=1e-5)


def test_gather_fuse_rejects_what_it_does_not_take(dev):
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, 50, 16, 32, 8, 10)
    with pytest.raises(ValueError, match="fuse weight rows"):
        kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf[:-1], bf)
    with pytest.raises(ValueError, match="sem_ids shape"):
        kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=ids[:5])
    with pytest.raises(TypeError):
        kops.gather_fuse(ids, h_str.double(), h_sem, wp, bp, wf, bf)
    with pytest.raises(TypeError):
        kops.gather_fuse(ids, h_str, h_sem.bfloat16(), wp, bp, wf, bf)  # mixed
    with pytest.raises(TypeError):
        kops.gather_fuse(ids, h_str, h_sem, wp.double(), bp, wf, bf)
    with pytest.raises(ValueError, match="contiguous"):
        kops.gather_fuse(ids, h_str.T.contiguous().T, h_sem, wp, bp, wf, bf)
    with pytest.raises(ValueError, match="one CUDA device"):
        kops.gather_fuse(ids, h_str, h_sem.cpu(), wp, bp, wf, bf)


# ------------------------------------------------------ gather_fuse backward


def _fuse_backward_inputs(dev, n, layout, seed=0, E=14951, d=400, dl=1024, dp=64):
    """``kernels.timing.fuse_backward_inputs`` (as chip_smoke.py and
    time_kernels take them) from a seeded generator on the card."""
    return fuse_backward_inputs(n, layout, E, d, dl, dp,
                                torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("with_zp", [True, False])
@pytest.mark.parametrize("n,layout,saved", [(48, "resident", True), (48, "cache", True),
                                            (1024, "resident", True), (1024, "cache", False),
                                            (33280, "resident", True), (33280, "cache", True),
                                            (32, "resident", True), (64, "resident", True),
                                            (128, "resident", True), (256, "resident", True),
                                            (512, "resident", True)])
def test_gather_fuse_backward_matches_plain(dev, n, layout, saved, with_zp):
    """Each gradient against the plain version (autograd through
    ``gather_fuse_ref``) on fp64 inputs within 1e-4·|exact| + the allowance
    of ``gather_fuse_backward_allowance`` an element, at 48 anchors, the
    EMBED pools of semantic training (32 to 512 rows), 1,024 rows and the
    loss's 33,280 (512 queries × 65 candidates), H_sem resident or through
    hot-set slots, from the forward's saved output or with it recomputed,
    and from its saved zp or with zp recomputed."""
    args, g, sem_ids, out, zp = _fuse_backward_inputs(dev, n, layout)
    before = kops.gather_fuse_backward.launches
    got = kops.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out if saved else None,
                                    zp=zp if with_zp else None)
    torch.cuda.synchronize()
    assert kops.gather_fuse_backward.launches == before + 1
    exact = kops.gather_fuse_backward_ref(args[0], *(t.double() for t in (*args[1:], g)),
                                          sem_ids=sem_ids)
    allowed = kops.gather_fuse_backward_allowance(*args, g, sem_ids=sem_ids)
    shares = backward_shares(got, exact, allowed, names=gf.GRADIENTS)
    for a, e in zip(got, exact):
        assert a.shape == e.shape and a.dtype == torch.float32
    assert max(shares.values()) <= 1, shares
    untouched = torch.ones(args[1].shape[0], dtype=torch.bool, device=dev)
    untouched[args[0]] = False
    assert not got[0][untouched].any()


def test_gather_fuse_backward_repeats_bitwise(dev):
    """Two calls on the same inputs, and calls on two streams at once (with
    the forward interleaved), give the same bits as serial calls."""
    cases = [_fuse_backward_inputs(dev, n, layout, seed=s)
             for s, (n, layout) in enumerate(((33280, "resident"), (1024, "cache"),
                                              (128, "resident")))]
    serial = [kops.gather_fuse_backward(*a, g, sem_ids=s, out=o, zp=z)
              for a, g, s, o, z in cases]
    a, g, s, o, z = cases[0]
    again = kops.gather_fuse_backward(*a, g, sem_ids=s, out=o, zp=z)
    torch.cuda.synchronize()
    for a, b in zip(serial[0], again):
        assert torch.equal(a, b)
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    runs = []
    for _ in range(3):
        for st, (a, g, s, o, z) in zip(streams, cases):
            with torch.cuda.stream(st):
                kops.gather_fuse(*a, sem_ids=s)
                runs.append(kops.gather_fuse_backward(*a, g, sem_ids=s, out=o, zp=z))
    torch.cuda.synchronize()
    for i, grads in enumerate(runs):
        for name, a, b in zip(gf.GRADIENTS, grads, serial[i % len(cases)]):
            assert torch.equal(a, b), (i, name)


def test_gather_fuse_autograd_runs_both_kernels(dev):
    """On the card, autograd through ``gather_fuse`` launches the forward
    kernel once and the backward kernel once; its gradients are the backward
    kernel's from the saved output and zp, and H_sem and the ids get none."""
    (ids, h_str, h_sem, wp, bp, wf, bf), g, sem_ids, _, _ = _fuse_backward_inputs(
        dev, 1024, "cache")
    leaves = [t.clone().requires_grad_(True) for t in (h_str, wp, bp, wf, bf)]
    f0, b0 = kops.gather_fuse.launches, kops.gather_fuse_backward.launches
    out = kops.gather_fuse(ids, leaves[0], h_sem, *leaves[1:], sem_ids=sem_ids)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (kops.gather_fuse.launches - f0, kops.gather_fuse_backward.launches - b0) == (1, 1)
    _, zp = gf.gather_fuse_and_zp(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=sem_ids)
    want = kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g, sem_ids=sem_ids,
                                     out=out.detach(), zp=zp)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


def test_gather_fuse_backward_rejects_what_it_does_not_take(dev):
    (ids, h_str, h_sem, wp, bp, wf, bf), g, _, _, zp = _fuse_backward_inputs(
        dev, 10, "resident", E=50, d=16, dl=32, dp=8)
    before = kops.gather_fuse_backward.launches
    with pytest.raises(TypeError, match="float32"):
        kops.gather_fuse_backward(ids, h_str.bfloat16(), h_sem.bfloat16(), wp, bp, wf, bf, g)
    with pytest.raises(TypeError, match="float32"):
        kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g.bfloat16())
    with pytest.raises(ValueError, match="one CUDA device"):
        kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g.T.contiguous().T)
    with pytest.raises(ValueError, match=r"need g and out \[10, 16\]"):
        kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g[:4])
    with pytest.raises(ValueError, match=r"need zp \[10, 8\]"):
        kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g, zp=zp[:4])
    with pytest.raises(TypeError, match="float32"):
        kops.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g, zp=zp.double())
    assert kops.gather_fuse_backward.launches == before
    f0 = kops.gather_fuse.launches
    # H_sem is frozen: a semantic table that asks for a gradient raises.
    with pytest.raises(ValueError, match="frozen"):
        kops.gather_fuse(ids, h_str, h_sem.clone().requires_grad_(True), wp, bp, wf, bf)
    # bf16 tables train nothing: under autograd the forward raises.
    with pytest.raises(TypeError, match="float32"):
        kops.gather_fuse(ids, h_str.bfloat16().requires_grad_(True), h_sem.bfloat16(),
                         wp, bp, wf, bf)
    assert kops.gather_fuse.launches == f0
    with torch.no_grad():  # serving bf16 tables still runs
        kops.gather_fuse(ids, h_str.bfloat16().requires_grad_(True), h_sem.bfloat16(),
                         wp, bp, wf, bf)
    assert kops.gather_fuse.launches == f0 + 1


def test_gather_fuse_backward_out_of_range_id_writes_nothing_outside(dev):
    """An id outside its table (either index) writes no row outside the
    h_str gradient: its gradient lies between guard rows of one buffer,
    which stay zero; the rows of the ids in range are bitwise those of a call
    without the bad rows."""
    from repro_torch.kernels import build
    (ids, h_str, h_sem, wp, bp, wf, bf), g, _, _, _ = _fuse_backward_inputs(
        dev, 2048, "resident")
    E, d, dl, dp = h_str.shape[0], h_str.shape[1], h_sem.shape[1], wp.shape[1]
    sem_ids = ids.clone()
    bad = torch.zeros(len(ids), dtype=torch.bool, device=dev)
    bad[[3, 700, 2047]] = True
    ids[3], ids[700], sem_ids[2047] = E + 7, -2, E
    out = kops.gather_fuse(ids[~bad], h_str, h_sem, wp, bp, wf, bf, sem_ids=sem_ids[~bad])
    want = kops.gather_fuse_backward(ids[~bad], h_str, h_sem, wp, bp, wf, bf, g[~bad],
                                     sem_ids=sem_ids[~bad], out=out)
    full_out = torch.zeros((len(ids), d), device=dev)
    full_out[~bad] = out
    guard = 64
    buf = torch.zeros((E + 2 * guard, d), device=dev)
    dh = buf[guard:guard + E]
    grads = [torch.empty_like(t) for t in (wp, bp, wf, bf)]
    sorted_ids, order = torch.sort(ids, stable=True)
    lib = build.load_library()
    scratch = torch.empty(lib.repro_gather_fuse_backward_scratch(len(ids), d, dl, dp),
                          device=dev)
    err = lib.repro_gather_fuse_backward(  # zp null: recomputed from the bad rows too
        ids.data_ptr(), sem_ids.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
        h_str.data_ptr(), h_sem.data_ptr(), wp.data_ptr(), bp.data_ptr(), wf.data_ptr(),
        bf.data_ptr(), None, full_out.data_ptr(), g.data_ptr(), scratch.data_ptr(), dh.data_ptr(),
        *(t.data_ptr() for t in grads), len(ids), E, E, d, dl, dp, build.stream_handle(ids))
    build.check(lib, err, "gather_fuse_backward")
    torch.cuda.synchronize()
    assert not buf[:guard].any() and not buf[guard + E:].any()
    # Row 2047's id is in range (its sem_id is not): its entity's row adds
    # that row's gradient too.
    good = ids[~bad]
    good = good[good != ids[2047]]
    assert torch.equal(dh[good], want[0][good])


@pytest.mark.parametrize("n", [48, 1024, 4096])
def test_gather_fuse_backward_segment_sum_with_and_without_the_sort(dev, n):
    """Up to ``UNSORTED_ROWS`` the wrapper passes no sorted ids and the
    segment sum scans the ids for each id's rows; given the ids sorted
    stably, it walks their runs: both add the same rows in the same order,
    so every gradient has the same bits."""
    from repro_torch.kernels import build
    assert n <= gf.UNSORTED_ROWS
    args, g, sem_ids, out, zp = _fuse_backward_inputs(dev, n, "cache")
    ids, h_str, h_sem, wp, bp, wf, bf = args
    E, d, dl, dp = h_str.shape[0], h_str.shape[1], h_sem.shape[1], wp.shape[1]
    want = kops.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out, zp=zp)
    sorted_ids, order = torch.sort(ids, stable=True)
    grads = [torch.zeros_like(h_str), *(torch.empty_like(t) for t in (wp, bp, wf, bf))]
    lib = build.load_library()
    scratch = torch.empty(lib.repro_gather_fuse_backward_scratch(n, d, dl, dp), device=dev)
    err = lib.repro_gather_fuse_backward(
        ids.data_ptr(), sem_ids.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
        h_str.data_ptr(), h_sem.data_ptr(), wp.data_ptr(), bp.data_ptr(), wf.data_ptr(),
        bf.data_ptr(), zp.data_ptr(), out.data_ptr(), g.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in grads), n, E, h_sem.shape[0], d, dl, dp,
        build.stream_handle(ids))
    build.check(lib, err, "gather_fuse_backward")
    torch.cuda.synchronize()
    for name, a, b in zip(gf.GRADIENTS, grads, want):
        assert torch.equal(a, b), name


def test_semantic_training_step_on_gpu_matches_cpu(dev):
    """One semantic GQE training step on the card, H_sem behind a hot set:
    ``gather_fuse`` and its backward launch once per EMBED op and once for
    the loss, and the loss and every gradient agree with the CPU path on the
    same parameters, hot set and batch (the CPU parity tests' tolerance:
    rtol 1e-4, atol 1e-6·max|g|)."""
    from repro_torch.core import OpType
    from repro_torch.data import batch_entity_ids, generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.sampling import OnlineSampler
    from repro_torch.semantic import SemanticCache
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(300, 12, 3000, seed=0)
    table = torch.nn.functional.normalize(torch.randn((300, 64), generator=torch.Generator()
                                                      .manual_seed(0)), dim=1).numpy()
    mcfg = ModelConfig(dim=32, semantic_dim=64, semantic_proj_dim=16)
    cfg = TrainConfig(batch_size=64, n_negatives=8, b_max=32, adam=AdamConfig(lr=3e-3))
    cache = SemanticCache(table, budget_rows=280, device=dev)
    gpu = NGDBTrainer(make_model("gqe", mcfg, device=dev), kg, cfg, semantic_cache=cache)
    cpu = NGDBTrainer(make_model("gqe", mcfg, device="cpu"), kg, cfg, semantic_table=table)
    batch = OnlineSampler(kg, seed=3).sample_batch(64)
    queries, pos, neg = OnlineSampler(kg, seed=4).to_training_arrays(batch, 8)
    cache.apply_to(gpu.params, cache.plan(batch_entity_ids(queries, pos, neg)))
    cpu.load_params({k: v.cpu().numpy() for k, v in gpu.params.items()})
    plan = gpu.executor.prepare(queries)
    embeds = sum(op == int(OpType.EMBED) for op, _, _ in plan.meta)
    f0, b0 = kops.gather_fuse.launches, kops.gather_fuse_backward.launches
    loss, _, grads = gpu.loss_and_grads(plan, pos[plan.order], neg[plan.order])
    torch.cuda.synchronize()
    assert embeds > 0
    assert (kops.gather_fuse.launches - f0,
            kops.gather_fuse_backward.launches - b0) == (embeds + 1, embeds + 1)
    cplan = cpu.executor.prepare(queries)
    closs, _, cgrads = cpu.loss_and_grads(cplan, pos[cplan.order], neg[cplan.order])
    np.testing.assert_allclose(float(loss), float(closs), rtol=1e-4)
    for k, want in cgrads.items():
        torch.testing.assert_close(grads[k].cpu(), want, rtol=1e-4,
                                   atol=1e-6 * float(want.abs().max()) + 1e-30,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("name", ["betae", "gqe", "complex", "q2b", "q2p", "fuzzqe"])
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
    if name in ("betae", "gqe", "complex"):
        # BetaE's set operators run intersect; GQE and ComplEx score with
        # scoring; the other families reach no kernel.
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


def test_betae_training_step_on_gpu_matches_cpu(dev):
    """One BetaE training step on the card through the forward and backward
    ``intersect`` kernels: one launch of each per intersection or union op of
    the plan, and the loss and every gradient agree with the CPU path on the
    same parameters and batch (the CPU parity tests' BetaE tolerance: rtol
    1e-3, atol 1e-4·max|g|; the softmax-shift-invariant biases, whose exact
    gradient is 0, within 1e-6 of the largest gradient)."""
    from repro_torch.core import OpType
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.sampling import OnlineSampler
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(300, 12, 3000, seed=0)
    cfg = TrainConfig(batch_size=64, n_negatives=8, b_max=32, adam=AdamConfig(lr=3e-3))
    gpu = NGDBTrainer(make_model("betae", ModelConfig(dim=32), device=dev), kg, cfg)
    cpu = NGDBTrainer(make_model("betae", ModelConfig(dim=32), device="cpu"), kg, cfg)
    cpu.load_params({k: v.cpu().numpy() for k, v in gpu.params.items()})
    batch = OnlineSampler(kg, seed=3).sample_batch(64)
    queries, pos, neg = OnlineSampler(kg, seed=4).to_training_arrays(batch, 8)
    plan = gpu.executor.prepare(queries)
    attn = sum(op in (int(OpType.INTERSECT), int(OpType.UNION)) for op, _, _ in plan.meta)
    f0, b0 = kops.intersect.launches, kops.intersect_backward.launches
    loss, _, grads = gpu.loss_and_grads(plan, pos[plan.order], neg[plan.order])
    torch.cuda.synchronize()
    assert attn > 0
    assert (kops.intersect.launches - f0, kops.intersect_backward.launches - b0) == (attn, attn)
    cplan = cpu.executor.prepare(queries)
    closs, _, cgrads = cpu.loss_and_grads(cplan, pos[cplan.order], neg[cplan.order])
    np.testing.assert_allclose(float(loss), float(closs), rtol=1e-4)
    top = max(float(g.abs().max()) for g in cgrads.values())
    for k, want in cgrads.items():
        got = grads[k].cpu()
        if k in ("att_b1", "uatt_b1"):
            assert float(got.abs().max()) <= 1e-6 * top, k
            continue
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * float(want.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")
    rec_gpu, rec_cpu = gpu.train_step(batch), cpu.train_step(batch)
    assert rec_gpu["loss"] == pytest.approx(rec_cpu["loss"], rel=1e-4)


# ------------------------------------------------------ pipelined training
def _pipelined_pair(dev, family):
    """A sync and a pipelined trainer on the card at narrow widths: BetaE
    (``intersect`` and its backward) or GQE+H_sem behind a hot set below the
    graph (``gather_fuse`` and its backward, rows staged through the side
    stream), with five fixed batches."""
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.sampling import OnlineSampler
    from repro_torch.semantic import SemanticCache
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(300, 12, 3000, seed=0)
    mcfg, table = ModelConfig(dim=32), None
    if family == "gqe+semantic":
        mcfg = ModelConfig(dim=32, semantic_dim=64, semantic_proj_dim=16)
        table = torch.nn.functional.normalize(torch.randn(
            (300, 64), generator=torch.Generator().manual_seed(0)), dim=1).numpy()

    def trainer(pipeline):
        sem = {} if table is None else {
            "semantic_cache": SemanticCache(table, budget_rows=280, device=dev)}
        cfg = TrainConfig(batch_size=32, n_negatives=8, b_max=32, pipeline=pipeline,
                          adam=AdamConfig(lr=3e-3))
        return NGDBTrainer(make_model(family.split("+")[0], mcfg, device=dev), kg, cfg, **sem)

    src = OnlineSampler(kg, seed=3)
    return trainer(False), trainer(True), [src.sample_batch(32) for _ in range(5)]


_COUNTED = ("intersect", "intersect_backward", "gather_fuse", "gather_fuse_backward")


@pytest.mark.parametrize("family", ["betae", "gqe+semantic"])
def test_pipelined_training_on_gpu_matches_sync_bitwise(dev, family):
    """Five pipelined steps on the card: the sync run's losses and
    parameters bit for bit, through the same kernel launches; a hot set
    staged entirely in the background."""
    sync, pipe, batches = _pipelined_pair(dev, family)
    runs = []
    for tr in (sync, pipe):
        before = [getattr(kops, k).launches for k in _COUNTED]
        tr.train(5, log_every=0, batches=batches)
        torch.cuda.synchronize()
        runs.append([getattr(kops, k).launches - b for k, b in zip(_COUNTED, before)])
    assert runs[0] == runs[1] and sum(runs[1]) > 0
    assert [r["loss"] for r in sync.history] == [r["loss"] for r in pipe.history]
    for k in sync.params:
        assert torch.equal(sync.params[k], pipe.params[k]), k
    if pipe.sem_cache is not None:
        st = pipe.sem_cache.stats()
        assert st["stages_background"] == st["stages"] > 0
        assert st["prefetch_overlap_frac"] == 1.0


@pytest.mark.parametrize("family", ["betae", "gqe+semantic"])
def test_pipelined_dispatch_takes_no_host_sync(dev, family):
    """A warm pipelined dispatch (hot-set apply, encode, loss, backward,
    Adam) under ``set_sync_debug_mode("error")`` raises nothing, with the
    scheduler thread preparing the next item beside it."""
    _, tr, batches = _pipelined_pair(dev, family)
    tr.train(2, log_every=0, batches=batches)
    pf = tr._prefetcher(batches)
    try:
        item = pf.next(timeout=120)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, _ = tr._dispatch(item)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pf.next(timeout=120)   # raises if the scheduler thread failed meanwhile
    finally:
        pf.close()
    assert np.isfinite(float(loss))


# -------------------------------------------------------------- telemetry
@pytest.mark.parametrize("family", ["betae", "gqe+semantic"])
def test_traced_pipelined_training_on_gpu_is_bitwise_untraced(dev, family):
    """Tracing on, with the ``record_function`` bridge, changes no loss or
    parameter bit of a pipelined run on the card; the trace validates and
    holds the run's spans on both threads' lanes."""
    from repro_torch.obs import TRACER, validate_trace

    _, plain, batches = _pipelined_pair(dev, family)
    _, traced, _ = _pipelined_pair(dev, family)
    plain.train(5, log_every=0, batches=batches)
    TRACER.enable()
    try:
        traced.train(5, log_every=0, batches=batches)
        obj = TRACER.to_json()
    finally:
        TRACER.disable()
    assert [r["loss"] for r in traced.history] == [r["loss"] for r in plain.history]
    for k in plain.params:
        assert torch.equal(traced.params[k], plain.params[k]), k
    s = validate_trace(obj)
    assert {"main dispatch", "pipeline scheduler"} <= set(s["lanes"])
    want = {"pipeline_wait", "dispatch", "retire", "sample", "schedule", "transfer"}
    if family == "gqe+semantic":
        want |= {"sem_prefetch", "sem_apply", "store_io"}
    assert want <= set(s["names"])


@pytest.mark.parametrize("family", ["betae", "gqe+semantic"])
def test_traced_pipelined_dispatch_takes_no_host_sync(dev, family):
    """With tracing on, a warm pipelined dispatch still takes no host sync:
    the spans time the host's enqueue and never wait for the card."""
    from repro_torch.obs import TRACER

    _, tr, batches = _pipelined_pair(dev, family)
    tr.train(2, log_every=0, batches=batches)
    TRACER.enable()
    pf = tr._prefetcher(batches)
    try:
        item = pf.next(timeout=120)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss, _ = tr._dispatch(item)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pf.next(timeout=120)
    finally:
        pf.close()
        TRACER.disable()
    assert np.isfinite(float(loss))
    assert "dispatch" in {e["name"] for e in TRACER.to_json()["traceEvents"]}


def test_disabled_span_costs_under_2us_on_the_gpu_host(dev):
    """A disabled ``TRACER.span()`` is one attribute read and the shared null
    context: under 2 µs a call on the GPU's host (the JAX package's gate)."""
    import time

    from repro_torch.obs import TRACER

    TRACER.disable()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with TRACER.span("probe"):
            pass
    ns = (time.perf_counter() - t0) / n * 1e9
    assert ns < 2000, f"{ns:.0f} ns a disabled span"


def test_pipelined_item_is_copied_on_the_side_stream(dev, monkeypatch):
    """Every copy of a work item and of its hot-set stage runs on the
    scheduler thread's side stream, with an event; the main stream waits on
    each event and marks each buffer as used before the step's launches."""
    _, tr, batches = _pipelined_pair(dev, "gqe+semantic")
    pf = tr._prefetcher(batches)
    try:
        item = pf.next(timeout=120)
    finally:
        pf.close()
    main = torch.cuda.current_stream(dev)
    assert pf.stream is not None and pf.stream.cuda_stream != main.cuda_stream
    assert pf.stream.cuda_stream != torch.cuda.default_stream(dev).cuda_stream
    stage = item.sem_stage
    assert item.event is not None and stage is not None and stage.event is not None
    assert all(t.is_pinned() for t in item.host + stage.host)
    waits, marks = [], []
    real_wait, real_mark = torch.cuda.Stream.wait_event, torch.Tensor.record_stream
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", lambda s, e: (
        waits.append((s.cuda_stream, e)), real_wait(s, e))[1])
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: (
        marks.append((t.data_ptr(), s.cuda_stream)), real_mark(t, s))[1])
    tr._dispatch(item)
    torch.cuda.synchronize()
    assert (main.cuda_stream, item.event) in waits
    assert (main.cuda_stream, stage.event) in waits
    for t in (*item.buffers, stage.rows, stage.slots, stage.ids):
        assert (t.data_ptr(), main.cuda_stream) in marks
    tr.sem_cache.reconcile()


# ------------------------------------------------------------ live serving tier
def _live_setup(dev, name="gqe", n_entities=61, **cfg):
    from repro_torch.core import PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model

    kg = generate_synthetic_kg(n_entities, 4, 300, seed=3)
    model = make_model(name, ModelConfig(dim=16, gamma=6.0, **cfg), device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               kg.n_entities, kg.n_relations)
    return kg, model, params, PooledExecutor(model, b_max=64, device=dev)


def _payload(r):
    return {k: v for k, v in r.items() if k not in ("latency_ms", "batch_size")}


@pytest.mark.parametrize("name", ["gqe", "complex", "betae", "q2b", "q2p", "fuzzqe"])
def test_materialized_rows_on_gpu(dev, name):
    """Rows served from the materialized cache on the card against a fresh
    no-cache encode of the same queries in other pools: bitwise for the
    families whose operators are the port's kernels or elementwise; the
    families with plain torch.matmul projections are held to the encode
    tolerance (cuBLAS may pick another algorithm for another row count),
    and their largest difference is printed."""
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.sampling import OnlineSampler

    kg, model, params, _ = _live_setup(dev, name)
    mat = MaterializedSubqueryCache(256)
    ex = PooledExecutor(model, b_max=64, device=dev, mat_cache=mat)
    fresh = PooledExecutor(model, b_max=64, device=dev)
    pool = [s.query for s in OnlineSampler(kg, seed=11).sample_batch(48)]
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(6):
        qs = [pool[i] for i in rng.integers(len(pool), size=int(rng.integers(3, 20)))]
        got = ex.encode(params, qs)
        want = fresh.encode(params, qs)
        if name in ("gqe", "complex"):
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        worst = max(worst, float((got - want).abs().max()))
    assert mat.stats()["hits"] > 0
    print(f"{name}: largest |cached - fresh| {worst:.3g}")


def test_pinned_replay_through_growth_on_gpu(dev):
    """entity_pad = 8: growth claims pad rows without reallocating; a replay
    pinned to the version before it keeps that version's mask (the engine
    scores with the entity count it retained), bitwise."""
    from repro_torch.launch.serve import serve_batch
    from repro_torch.core import PooledExecutor, QueryInstance
    from repro_torch.serving import LiveNGDB, ServingConfig, ServingEngine

    kg, model, params, ex = _live_setup(dev, entity_pad=8)
    assert params["entity"].shape[0] == 64
    rng = np.random.default_rng(0)
    qs = [QueryInstance("1p", np.array([h]), np.array([r]))
          for h, r in kg.triples[rng.integers(0, len(kg), 6), :2]]
    cfg = ServingConfig(max_batch=8, max_wait_ms=5.0, top_k=63, max_staleness_versions=8)
    with ServingEngine(model, params, executor=ex, cfg=cfg, device=dev, kg=kg) as eng:
        first = [_payload(eng.submit(q, pin_version=0).result(timeout=60)) for q in qs]
        with LiveNGDB(model, kg, eng, finetune_steps=1) as live:
            r = live.write(np.array([[61, 0, 1], [62, 1, 61]]), n_new_entities=2)
            live.flush()
        assert eng.params["entity"].shape[0] == 64 and model.n_entities == 63
        replay = [_payload(eng.submit(q, pin_version=0).result(timeout=60)) for q in qs]
        grown = [_payload(eng.submit(q).result(timeout=60)) for q in qs]
        p_v, n_v = eng.params_at(r.graph_version)
    assert replay == first
    assert all(set(x["top_entities"][:61]) == set(range(61)) for x in first)
    assert all(set(g["top_entities"]) == set(range(63)) for g in grown)
    oracle, _ = serve_batch(model, p_v, PooledExecutor(model, b_max=64, device=dev), qs,
                            top_k=63, device=dev, n_entities=n_v)
    assert grown == [_payload(o) for o in oracle]


@pytest.mark.parametrize("name", ["gqe", "betae"])
def test_background_finetune_on_gpu_matches_sync_bitwise(dev, name):
    """The maintenance thread's fine-tune on the default stream, interleaved
    with the batcher's launches, equals a synchronous rerun bitwise; the
    params it started from are unchanged."""
    from repro_torch.serving import LiveNGDB, ServingConfig, ServingEngine
    from repro_torch.sampling import OnlineSampler
    from repro_torch.training import incremental_finetune

    kg, model, params, ex = _live_setup(dev, name)
    before = {k: v.clone() for k, v in params.items()}
    rng = np.random.default_rng(1)
    cand = np.stack([rng.integers(0, 61, 64), rng.integers(0, 4, 64),
                     rng.integers(0, 61, 64)], axis=1)
    burst = np.unique(cand[~kg.contains(cand)], axis=0)[:8]
    traffic = [s.query for s in OnlineSampler(kg, seed=3).sample_batch(64)]
    cfg = ServingConfig(max_batch=16, max_wait_ms=2.0, max_staleness_versions=8)
    with ServingEngine(model, params, executor=ex, cfg=cfg, device=dev, kg=kg) as eng:
        with LiveNGDB(model, kg, eng, finetune_steps=4, seed=5) as live:
            futs = [eng.submit(q) for q in traffic[:32]]
            r = live.write(burst)
            futs += [eng.submit(q) for q in traffic[32:]]
            live.flush()
            served = eng.params
            assert all(np.isfinite(f.result(timeout=60)["scores"]).all() for f in futs)
    sync, losses = incremental_finetune(model, params, r.fresh_triples, steps=4,
                                        lr=live.finetune_lr, n_negatives=live.n_negatives,
                                        seed=5 + r.graph_version)
    for k in served:
        assert torch.equal(served[k], sync[k]), k
        assert torch.equal(params[k], before[k]), k
    assert np.isfinite(losses).all()


def test_incremental_finetune_leaves_engine_tensors_on_gpu(dev):
    from repro_torch.training import incremental_finetune

    kg, model, params, _ = _live_setup(dev)
    before = {k: v.clone() for k, v in params.items()}
    new, losses = incremental_finetune(model, params, kg.triples[:16], steps=3, lr=1e-2)
    for k in params:
        assert torch.equal(params[k], before[k]), k
        assert new[k].data_ptr() != params[k].data_ptr(), k
    assert not torch.equal(new["entity"], params["entity"])
    assert losses[-1] < losses[0]


# ------------------------------------------------------------- autotuning
@pytest.fixture
def empty_tuner():
    """A fresh, empty process tuner, the previous one restored after."""
    from repro_torch.kernels import autotune as at

    prev = at.set_tuner(at.KernelTuner())
    yield at.get_tuner()
    at.set_tuner(prev)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("N", [333, 4096, 14951])
@pytest.mark.parametrize("mode", ["dot", "l1"])
def test_scoring_every_tile_is_bitwise_the_default(dev, empty_tuner, misaligned, N, mode):
    """Each tiling (the tuner's knob) gives the default launch's bits, on a
    16-byte aligned table and off one (the element-load variant); an empty
    tuner's launch is the default's, one lookup miss a launch."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((16, 400), generator=g, device=dev)
    e = torch.randn((N, 400), generator=g, device=dev)
    e = _misaligned(e) if misaligned else e
    want = kops.scoring(q, e, 12.0, mode, tile=0)
    misses = int(empty_tuner.lookup_misses)
    assert torch.equal(kops.scoring(q, e, 12.0, mode), want)
    assert int(empty_tuner.lookup_misses) == misses + 1
    for tile in TILES:
        assert torch.equal(kops.scoring(q, e, 12.0, mode, tile=tile), want), tile


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intersect_every_row_group_is_bitwise_the_default(dev, empty_tuner, k, dtype):
    """Every row-group size the tuner tries (powers of two up to 64 // k, and
    group_rows(k) itself) gives the default launch's bits, at pools of 1 to
    512 rows; the library's group_rows is the wrapper's."""
    from repro_torch.kernels import build
    from repro_torch.kernels.intersect import group_rows

    assert build.load_library().repro_intersect_group_rows(k, 0) == group_rows(k)
    g = torch.Generator(device=dev).manual_seed(k)
    for n in (1, 2, 3, 7, 8, 16, 21, 31, 64, 100, 256, 300, 512):
        x, w1, b1, w2, b2 = intersect_inputs(n, k, 800, 800, dtype, g)
        want = kops.intersect(x, w1, b1, w2, b2, rows=0)
        assert torch.equal(kops.intersect(x, w1, b1, w2, b2), want)
        r = 1
        while r <= group_rows(k):
            got = kops.intersect(x, w1, b1, w2, b2, rows=r)
            assert torch.equal(got, want), (n, r)
            r *= 2
        assert torch.equal(kops.intersect(x, w1, b1, w2, b2, rows=group_rows(k)), want)


@pytest.mark.parametrize("layout", ["resident", "cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_fuse_pair_and_split_kernels_are_bitwise(dev, empty_tuner, layout, dtype):
    """The pair kernel (128 rows a block) and the split kernel (64 and a
    column pass) give the default launch's out and zp bitwise, for n = 1 to
    E, with H_sem resident and through shuffled hot-set slots."""
    E = 14951
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, E, 400, 1024, 64, E, dtype)
    sem_ids = None
    if layout == "cache":
        slot_of = torch.randperm(E, generator=torch.Generator(device=dev).manual_seed(3),
                                 device=dev)
        cache = torch.empty_like(h_sem)
        cache[slot_of] = h_sem
        h_sem, sem_ids = cache, slot_of[ids]
    for n in (1, 48, 64, 65, 128, 129, 1000, 4096, 8448, 8449, E):
        args = (ids[:n], h_str, h_sem, wp, bp, wf, bf, None if sem_ids is None else sem_ids[:n])
        want = kops.gather_fuse(*args, rows=0)
        assert torch.equal(kops.gather_fuse(*args), want)
        zps = []
        for rows in (0, 128, 64):
            assert torch.equal(kops.gather_fuse(*args, rows=rows), want), (n, rows)
            if dtype == torch.float32:
                out, zp = gf.gather_fuse_and_zp(*args, rows=rows)
                assert torch.equal(out, want)
                zps.append(zp)
        for zp in zps[1:]:
            assert torch.equal(zp, zps[0]), n


def test_a_forced_geometry_that_cannot_launch_raises(dev, empty_tuner):
    """A knob the kernel cannot launch raises; nothing falls back to
    another geometry, and nothing is counted as launched."""
    g = torch.Generator(device=dev).manual_seed(5)
    # intersect: one row group of 20,000 rows × 3 inputs: its logits overflow
    # a block's shared memory; 65,536 groups overflow the grid.
    x, w1, b1, w2, b2 = intersect_inputs(20000, 3, 800, 800, torch.float32, g)
    before = kops.intersect.launches
    with pytest.raises(RuntimeError, match="intersect kernel launch failed"):
        kops.intersect(x, w1, b1, w2, b2, rows=20000)
    mlp = intersect_inputs(1, 2, 8, 8, torch.float32, g)[1:]
    with pytest.raises(ValueError, match="row groups"):
        kops.intersect(torch.zeros((65536, 2, 8), device=dev), *mlp, rows=1)
    assert kops.intersect.launches == before
    # gather_fuse: the pair kernel's zp tile does not fit a block at dp = 192.
    ids, h_str, h_sem, wp, bp, wf, bf = _fuse_inputs(dev, 300, 400, 256, 192, 300)
    before = kops.gather_fuse.launches
    with pytest.raises(RuntimeError, match="gather_fuse kernel launch failed"):
        kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, rows=128)
    assert kops.gather_fuse.launches == before
    with pytest.raises(ValueError, match="rows"):
        kops.gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, rows=32)
    with pytest.raises(ValueError, match="tile"):
        kops.scoring(h_str[:4], h_str, tile=8)


def test_tuner_on_the_card(dev, tmp_path):
    """A sweep on the card: every candidate bitwise the default (no
    rejects), the tuned time at most the default's, the entry keyed and
    stamped with the card's name; the wrapper then takes the tuned knob
    (one lookup hit a launch), and a second tuner on the file sweeps
    nothing."""
    from repro_torch.kernels import autotune as at

    path = str(tmp_path / "tiles.json")
    tuner = at.KernelTuner(path=path)
    buckets = [("intersect", at.intersect_bucket(64, 2, 800, 800)),
               ("scoring", at.scoring_bucket(16, 4096, 400)),
               ("gather_fuse", at.gather_fuse_bucket(128, 400, 1024, 64))]
    for op, bucket in buckets:
        tuner.tune(op, bucket)
    name = torch.cuda.get_device_name(dev)
    assert int(tuner.verify_rejects) == 0 and len(tuner) == 3
    for key, e in tuner.entries().items():
        assert key.endswith("|" + name) and e["device"] == name
        assert e["us"] <= e["default_us"] and e["n_rejected"] == 0
        assert e["default"] is not None and e["n_candidates"] >= 2
    prev = at.set_tuner(tuner)
    try:
        x, w1, b1, w2, b2 = intersect_inputs(64, 2, 800, 800, torch.float32,
                                             torch.Generator(device=dev).manual_seed(0))
        hits = int(tuner.lookup_hits)
        want = kops.intersect(x, w1, b1, w2, b2, rows=0)
        assert torch.equal(kops.intersect(x, w1, b1, w2, b2), want)
        assert int(tuner.lookup_hits) == hits + 1
    finally:
        at.set_tuner(prev)
    again = at.KernelTuner(path=path)
    for op, bucket in buckets:
        again.tune(op, bucket)
    assert int(again.sweeps) == 0 and len(again) == 3


def test_empty_tuner_lookup_costs_under_2us_on_the_gpu_host(dev, empty_tuner):
    """What a wrapper given no knob adds to a launch with an empty tuner:
    under 2 µs a call on the GPU's host, the disabled span's gate."""
    import time

    from repro_torch.kernels import autotune as at

    t = torch.empty(1, device=dev)
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        at.tuned_config("intersect", (64, 2, 800, 800), t)
    ns = (time.perf_counter() - t0) / n * 1e9
    assert ns < 2000, f"{ns:.0f} ns an empty-tuner lookup"


# ------------------------------------------------------ serving a checkpoint
def _trained_checkpoint(directory, family, pad=1, kg=None):
    """A checkpoint of two training steps of ``family`` (dim 32) on ``kg``
    (the reduced FB15k stand-in unless given), written on the card."""
    from repro_torch.data import load_dataset
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.training import NGDBTrainer, TrainConfig

    kg = kg or load_dataset("FB15k")[0]
    tr = NGDBTrainer(make_model(family, ModelConfig(dim=32, entity_pad=pad), device="cuda"), kg,
                     TrainConfig(batch_size=32, n_negatives=8, b_max=32, prefetch=0,
                                 checkpoint_dir=str(directory)))
    tr.train(2, log_every=0)
    return kg


@pytest.mark.parametrize("family", ["betae", "gqe"])
def test_serve_cli_from_a_checkpoint_is_bitwise_serve_batch(dev, tmp_path, capsys, family):
    """``launch.serve --ckpt-dir --answers`` on the card: every micro-batch
    is ``serve_batch``'s on the checkpoint's params, read apart from the
    CLI, bitwise; the kernel of the family was launched."""
    from repro_torch.core import PooledExecutor
    from repro_torch.launch.serve import main, read_answers, serve_batch
    from repro_torch.models import ModelConfig, make_model, params_from_numpy
    from repro_torch.serving import check_against_offline
    from repro_torch.training.checkpoint import load_checkpoint

    kg = _trained_checkpoint(tmp_path / "ck", family)
    path = str(tmp_path / "answers.jsonl")
    kernel = kops.intersect if family == "betae" else kops.scoring
    before = kernel.launches
    main(["--model", family, "--reduced", "--dim", "32", "--requests", "64",
          "--ckpt-dir", str(tmp_path / "ck"), "--answers", path])
    assert "loaded checkpoint step=2" in capsys.readouterr().out
    assert kernel.launches > before
    step, arrays, _ = load_checkpoint(str(tmp_path / "ck"))
    model = make_model(family, ModelConfig(dim=32), device=dev)
    params = params_from_numpy(model, {k[len("params/"):]: v for k, v in arrays.items()
                                       if k.startswith("params/")}, n_entities=kg.n_entities)
    ex = PooledExecutor(model, b_max=256, device=dev)
    log = read_answers(path)
    n = check_against_offline(log, lambda qs: serve_batch(model, params, ex, qs, top_k=5,
                                                          device=dev)[0])
    assert step == 2 and n == sum(r.n_real for r in log) > 0


def test_padded_restore_on_the_card(dev, tmp_path):
    """A 2,049-row checkpoint restored onto a table padded to 2,052 rows:
    the real rows the checkpoint's, the padding rows the template's, and
    the answers bitwise those of the unpadded restore."""
    from repro_torch.core import PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.launch.serve import restore_params, serve_batch
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import make_workload, pad_to_bucket
    from repro_torch.training.checkpoint import load_checkpoint

    kg = _trained_checkpoint(tmp_path, "gqe", kg=generate_synthetic_kg(2049, 10, 9000, seed=0))
    ent = load_checkpoint(str(tmp_path))[1]["params/entity"]
    comp = pad_to_bucket(make_workload(kg, 16, seed=7))[0]
    out = {}
    for pad in (1, 4):
        model = make_model("gqe", ModelConfig(dim=32, entity_pad=pad), device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(5), kg.n_entities,
                                   kg.n_relations)
        template = params["entity"].clone()
        assert restore_params(str(tmp_path), model, params) == 2
        assert params["entity"].shape[0] == model.padded_entities(kg.n_entities)
        np.testing.assert_array_equal(params["entity"][:2049].cpu().numpy(), ent)
        assert torch.equal(params["entity"][2049:], template[2049:])
        ex = PooledExecutor(model, b_max=64, device=dev)
        out[pad] = serve_batch(model, params, ex, comp, top_k=10, device=dev)[0]
    assert out[1] == out[4]
