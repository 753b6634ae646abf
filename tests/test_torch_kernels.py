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
from repro_torch.kernels import gather_fuse as gf
from repro_torch.kernels import intersect as its
from repro_torch.kernels import ops as tops
from repro_torch.kernels.scoring import TILES

torch.set_num_threads(1)

SCORING_SHAPES = [(8, 64, 32), (70, 333, 96), (128, 256, 128)]
# (8, 2, 800, 800): BetaE's serving shape at full width; k = 9: beyond the
# eight inputs the first CUDA kernel took; k = 1: nothing to attend over but
# itself; k = 70: a pool row wider than the CUDA kernel's 64-row group.
INTERSECT_SHAPES = [(16, 2, 32, 64), (100, 3, 64, 128), (64, 4, 128, 128),
                    (8, 2, 800, 800), (6, 9, 64, 48), (5, 1, 24, 16), (3, 70, 16, 8)]
# tests/test_kernels.py:37: (E, d, dl, dp, n); n = 33 is ragged.
GATHER_FUSE_SHAPES = [(40, 16, 32, 16, 8), (100, 64, 128, 32, 33)]


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


@pytest.mark.parametrize("shape,match", [((3, 0, 8), "k, d and hd"),
                                         ((3, 2, 8, 1), "need x"),
                                         ((3, 2, 7), "do not fit")])
def test_intersect_shape_errors(shape, match):
    """The CPU path refuses what the CUDA path refuses: no inputs to attend
    over (k = 0), x not [n, k, d], and an MLP that does not fit d."""
    w1, b1, w2, b2 = torch.zeros(8, 4), torch.zeros(4), torch.zeros(4, 1), torch.zeros(1)
    with pytest.raises(ValueError, match=match):
        tops.intersect(torch.zeros(shape), w1, b1, w2, b2)


@pytest.mark.parametrize("E,d,dl,dp,n", GATHER_FUSE_SHAPES)
@pytest.mark.parametrize("layout", ["resident", "cache"])
def test_gather_fuse_matches_pallas(E, d, dl, dp, n, layout):
    """Resident: h_sem is the full table, indexed by ids. Cache: h_sem is a
    hot set holding those rows at other slots, indexed by sem_ids."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, E, n).astype(np.int32)
    h_str = rng.normal(size=(E, d)).astype(np.float32)
    table = rng.normal(size=(E, dl)).astype(np.float32)
    wp = (rng.normal(size=(dl, dp)) * 0.2).astype(np.float32)
    bp = (rng.normal(size=(dp,)) * 0.1).astype(np.float32)
    wf = (rng.normal(size=(d + dp, d)) * 0.2).astype(np.float32)
    bf = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    if layout == "resident":
        h_sem, sem_ids = table, None
    else:
        sem_ids = rng.permutation(2 * n)[:n].astype(np.int32)
        h_sem = rng.normal(size=(2 * n, dl)).astype(np.float32)
        h_sem[sem_ids] = table[ids]
    args = (ids, h_str, h_sem, wp, bp, wf, bf)
    want = np.asarray(jops.gather_fuse(
        *map(jnp.asarray, args),
        sem_ids=None if sem_ids is None else jnp.asarray(sem_ids),
        interpret=True))
    before = tops.gather_fuse.launches
    got = tops.gather_fuse(*map(torch.from_numpy, args), sem_ids=(
        None if sem_ids is None else torch.from_numpy(sem_ids)))
    assert tops.gather_fuse.launches == before
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gather_fuse_shape_errors():
    """The reference's ValueErrors: fuse weight rows != d + dp, and sem_ids
    shaped unlike ids."""
    ids = torch.zeros(6, dtype=torch.int64)
    h_str, h_sem = torch.zeros(10, 8), torch.zeros(10, 12)
    wp, bp, bf = torch.zeros(12, 4), torch.zeros(4), torch.zeros(8)
    with pytest.raises(ValueError, match="fuse weight rows 11 != d\\+dp"):
        tops.gather_fuse(ids, h_str, h_sem, wp, bp, torch.zeros(11, 8), bf)
    with pytest.raises(ValueError, match="sem_ids shape"):
        tops.gather_fuse(ids, h_str, h_sem, wp, bp, torch.zeros(12, 8), bf,
                         sem_ids=ids[:3])


# A test-only model of csrc/gather_fuse.cu's 3xTF32 arithmetic (no serving
# path uses it): each fp32 operand x splits into hi = tf32(x) and
# lo = tf32(x - hi), rounded to 10 mantissa bits, to nearest, ties away; every
# k8 step adds a_lo·b_hi, then a_hi·b_lo, then a_hi·b_hi to an fp32
# accumulator (each product of 8 terms summed, then rounded to fp32). A bf16
# table value is exact in TF32, so its lo is 0 and its a_lo·b_hi is skipped.
# The projection is two chains over the halves of dl: zp = (p0 + p1) + bp.
def _tf32(x: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: np.ndarray):
    hi = _tf32(x)
    return hi, _tf32(x.astype(np.float32) - hi)


def _mm_3xtf32(a: np.ndarray, b: np.ndarray, exact_k: int) -> np.ndarray:
    """a @ b as one accumulator chain over K; a's first ``exact_k`` columns
    are bf16 table values (lo = 0)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        terms = ([] if k0 < exact_k else [(al, bh)]) + [(ah, bl), (ah, bh)]
        for x, y in terms:
            step = x[:, k].astype(np.float64) @ y[k].astype(np.float64)
            acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_3xtf32_model_holds_the_fp32_tolerance(table_dtype):
    """At the serving widths (d = 400, dl = 1024, dp = 64), 64 rows fused in
    the kernel's 3xTF32 order are within 1e-5 of the plain fp32 version on the
    same (for bf16: bf16-rounded) table values."""
    rng = np.random.default_rng(0)
    n, d, dl, dp = 64, 400, 1024, 64
    h = (rng.normal(size=(n, d)) / d ** 0.5).astype(np.float32)
    z = rng.normal(size=(n, dl))
    z = (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)
    if table_dtype == "bfloat16":
        h = torch.from_numpy(h).bfloat16().float().numpy()
        z = torch.from_numpy(z).bfloat16().float().numpy()
    wp = (rng.normal(size=(dl, dp)) * (2 / (dl + dp)) ** 0.5).astype(np.float32)
    wf = (rng.normal(size=(d + dp, d)) * (2 / (2 * d + dp)) ** 0.5).astype(np.float32)
    bp = (0.1 * rng.normal(size=dp)).astype(np.float32)
    bf = (0.1 * rng.normal(size=d)).astype(np.float32)
    exact = table_dtype == "bfloat16"
    half = dl // 2
    p0 = _mm_3xtf32(z[:, :half], wp[:half], half if exact else 0)
    p1 = _mm_3xtf32(z[:, half:], wp[half:], half if exact else 0)
    zp = ((p0 + p1) + bp).astype(np.float32)
    x = np.concatenate([h, zp], axis=1)  # one chain: h's k8 steps, then zp's
    y = (_mm_3xtf32(x, wf, d if exact else 0) + bf).astype(np.float32)
    got = (np.float32(2) / (np.float32(1) + np.exp(-y)) - np.float32(1)).astype(np.float32)
    ids = torch.arange(n)
    want = tops.gather_fuse_ref(ids, *map(torch.from_numpy, (h, z, wp, bp, wf, bf))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_3xtf32_split():
    """bf16 values split with lo = 0; fp32 values into a hi with its low 13
    bits clear and a lo that carries the rest to within 2^-22 of |x|."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=4096).astype(np.float32) * np.float32(3.0)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    hi, lo = _split(xb)
    assert np.array_equal(hi, xb) and not lo.any()
    hi, lo = _split(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.abs(x - hi).max() <= np.abs(x).max() * 2.0 ** -11
    assert (np.abs(x.astype(np.float64) - hi - lo) <= np.abs(x) * 2.0 ** -22).all()


def _fold(parts):
    """Chunk partials added in order to 0 in fp32, as the clusters fold them."""
    acc = np.zeros_like(parts[0])
    for p in parts:
        acc = (acc + p).astype(np.float32)
    return acc


def _chunked_3xtf32(a: np.ndarray, b: np.ndarray, parts: int) -> np.ndarray:
    """a @ b with the depth cut in ``parts`` chunks of whole k8 steps, each a
    3xTF32 chain, folded in order (csrc/intersect_backward.cu)."""
    depth = a.shape[1]
    ch = -(-(-(-depth // parts)) // 8) * 8
    return _fold([_mm_3xtf32(a[:, c:c + ch], b[c:c + ch], 0)
                  for c in range(0, depth, ch)])


def _backward_model(x, w1, b1, w2, b2, g):
    """A test-only model of csrc/intersect_backward.cu's arithmetic: the
    three products in 3xTF32 with the kernel's depth chunks (x·W1 over 8
    chunks of d, dh·W1ᵀ over 8 of hd, [xᵀ; 1]·dh over S chunks of n·k rows,
    db1 its ones row), the rest in fp32."""
    n, k, d = x.shape
    M, f32 = n * k, np.float32
    xm = x.reshape(M, d)
    pre = (_chunked_3xtf32(xm, w1, 8) + b1).astype(f32)
    logit = ((np.maximum(pre, 0) * w2[:, 0]).astype(f32).sum(1, dtype=f32) + b2).reshape(n, k)
    e = np.exp(logit - logit.max(1, keepdims=True)).astype(f32)
    att = (e / e.sum(1, keepdims=True, dtype=f32)).astype(f32)
    datt = (xm * np.repeat(g, k, axis=0)).sum(1, dtype=f32).reshape(n, k)
    dlogit = (att * (datt - (att * datt).sum(1, keepdims=True, dtype=f32))).astype(f32)
    dl = dlogit.reshape(M)
    dh = np.where(pre > 0, (dl[:, None] * w2[:, 0]).astype(f32), f32(0))
    dx = (att.reshape(M, 1) * np.repeat(g, k, axis=0) + _chunked_3xtf32(dh, w1.T.copy(), 8))
    S = 1
    while S < 8 and -(-M // S) > 1024:
        S *= 2
    xt1 = np.concatenate([xm.T, np.ones((1, M), f32)]).astype(f32)
    dw1 = _chunked_3xtf32(xt1, dh, S)
    return (dx.astype(f32).reshape(n, k, d), dw1[:d], dw1[d],
            (np.maximum(pre, 0) * dl[:, None]).sum(0, dtype=f32)[:, None], dl.sum(dtype=f32)[None])


@pytest.mark.parametrize("n,k", [(64, 2), (128, 3)])
def test_intersect_backward_3xtf32_model_holds_its_allowance(n, k):
    """At BetaE's widths (d = hd = 800) and training pools, gradients taken in
    the backward kernel's 3xTF32 order with its depth chunks stay within
    1e-4·|exact| + ``intersect_backward_allowance`` of the plain version on
    fp64 inputs, using no more than half of it."""
    rng = np.random.default_rng(n + k)
    d = hd = 800
    x = (np.log1p(np.exp(rng.normal(size=(n, k, d)) / 10)) + 0.05).astype(np.float32)
    w1 = (rng.normal(size=(d, hd)) * (2 / (d + hd)) ** 0.5).astype(np.float32)
    b1 = (0.1 * rng.normal(size=hd)).astype(np.float32)
    w2 = (rng.normal(size=(hd, 1)) * (2 / (hd + 1)) ** 0.5).astype(np.float32)
    b2 = np.zeros(1, np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g)]
    got = [torch.from_numpy(np.asarray(t)) for t in _backward_model(x, w1, b1, w2, b2, g)]
    exact = tops.intersect_backward_ref(*(t.double() for t in args))
    shares = its.backward_shares(got, exact, tops.intersect_backward_allowance(*args))
    assert max(shares.values()) <= 0.5, shares


def test_time_kernels_takes_the_backward_against_its_five_launch_baseline():
    """``time_kernels --kernel intersect_backward --baseline DIR`` parses, and
    the baseline library's entry is declared as the five-launch kernel's C
    signature: 14 pointers (x, g, w1, b1, w2, b2, pre, att, dlogit, dx, dw1,
    db1, dw2, db2), n, k, d, hd and the stream; no entry the older library
    lacks is touched."""
    import ctypes
    import types

    from repro_torch.launch import time_kernels as tk

    args = tk.parser().parse_args(["--kernel", "intersect_backward", "--baseline", "b"])
    assert args.kernel == "intersect_backward" and str(args.baseline) == "b"

    class StandIn:  # a library whose entries exist only once declared
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = tk.declare_baseline(StandIn(), "intersect_backward")
    p, i = ctypes.c_void_p, ctypes.c_int
    assert lib.repro_intersect_backward.argtypes == [p] * 14 + [i] * 4 + [p]
    assert lib.repro_intersect_backward.restype is i
    assert set(vars(lib)) == {"repro_intersect_backward", "repro_error_string"}
    assert all((n, 2, 800, 800) in tk.BACKWARD_SHAPES for n in (32, 64, 128, 256, 512))
    assert {(77, 3), (16, 1), (16, 12)} <= {(n, k) for n, k, _, _ in tk.BACKWARD_SHAPES}


def _fuse_backward_model(ids, h_str, z, zp, o, g, wp, wf):
    """A test-only model of csrc/gather_fuse_backward.cu's arithmetic at
    n <= 1,024 (one chunk of rows): t = g·(0.5·(1 − o²)); dX = t·Wfᵀ in
    3xTF32 over depth chunks of d (d / 8 rounded up to whole 32-deep
    slices), folded in order; [dWf; dbf] = [h | zp | 1]ᵀ·t and [dWp; dbp] =
    [z | 1]ᵀ·dzp, each one 3xTF32 chain over the rows; dh_str the rows' dh
    added in id order."""
    f32 = np.float32
    n, d = g.shape
    t = (g * (f32(0.5) * (f32(1) - o * o))).astype(f32)
    ch = -(-(-(-d // 8)) // 32) * 32
    wft = wf.T.copy()
    dx = _fold([_mm_3xtf32(t[:, c:c + ch], wft[c:c + ch], 0) for c in range(0, d, ch)])
    ones = np.ones((n, 1), f32)
    x1 = np.concatenate([h_str[ids], zp, ones], axis=1).astype(f32)
    dwf = _mm_3xtf32(x1.T.copy(), t, 0)
    dwp = _mm_3xtf32(np.concatenate([z, ones], axis=1).T.copy(), dx[:, d:].copy(), 0)
    dh = np.zeros_like(h_str)
    for i in np.argsort(ids, kind="stable"):
        dh[ids[i]] = (dh[ids[i]] + dx[i, :d]).astype(f32)
    return dh, dwp[:-1], dwp[-1], dwf[:-1], dwf[-1]


@pytest.mark.parametrize("n", [48, 256])
def test_gather_fuse_backward_3xtf32_model_holds_its_allowance(n):
    """At semantic training's widths (d = 400, dl = 1024, dp = 64) and EMBED
    pools, gradients taken in the backward kernel's 3xTF32 order with its
    depth chunks, from the forward's zp, stay within 1e-4·|exact| +
    ``gather_fuse_backward_allowance`` of the plain version on fp64 inputs,
    using no more than half of it."""
    rng = np.random.default_rng(n)
    E, d, dl, dp = 300, 400, 1024, 64
    ids = rng.integers(0, E // 2, size=n)
    h_str = (rng.normal(size=(E, d)) / d ** 0.5).astype(np.float32)
    table = rng.normal(size=(E, dl))
    table = (table / np.linalg.norm(table, axis=1, keepdims=True)).astype(np.float32)
    wp = (rng.normal(size=(dl, dp)) * (2 / (dl + dp)) ** 0.5).astype(np.float32)
    wf = (rng.normal(size=(d + dp, d)) * (2 / (2 * d + dp)) ** 0.5).astype(np.float32)
    bp = (0.1 * rng.normal(size=dp)).astype(np.float32)
    bf = (0.1 * rng.normal(size=d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (h_str, table, wp, bp, wf, bf)]
    tid = torch.from_numpy(ids)
    out, zp = (t.numpy() for t in gf.gather_fuse_and_zp(tid, *args))
    got = [torch.from_numpy(np.asarray(a)) for a in
           _fuse_backward_model(ids, h_str, table[ids], zp.astype(np.float32), out, g, wp, wf)]
    tg = torch.from_numpy(g)
    exact = tops.gather_fuse_backward_ref(tid, *(a.double() for a in args), tg.double())
    allowed = tops.gather_fuse_backward_allowance(tid, *args, tg)
    shares = its.backward_shares(got, exact, allowed, names=gf.GRADIENTS)
    assert max(shares.values()) <= 0.5, shares


def test_time_kernels_takes_the_fuse_backward_against_its_parent_entry():
    """``time_kernels --kernel gather_fuse_backward --baseline DIR`` parses, and
    the baseline library's entry is declared as the C signature of the
    backward before the forward saved zp: 18 pointers (ids, sem_ids, sorted
    ids, order, h_str, h_sem, wp, bp, wf, bf, out, g, scratch, dh_str, dwp,
    dbp, dwf, dbf), int n, long long n_str and n_sem, int d, dl, dp and the
    stream, with its scratch size (n, d, dl, dp) -> long long; no entry the
    older library lacks is touched. This checkout's entry takes one pointer
    more (zp, after bf)."""
    import ctypes
    import types

    from repro_torch.launch import time_kernels as tk

    args = tk.parser().parse_args(["--kernel", "gather_fuse_backward", "--baseline", "b"])
    assert args.kernel == "gather_fuse_backward" and str(args.baseline) == "b"

    class StandIn:  # a library whose entries exist only once declared
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = tk.declare_baseline(StandIn(), "gather_fuse_backward")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert lib.repro_gather_fuse_backward.argtypes == [p] * 18 + [i, ll, ll, i, i, i, p]
    assert lib.repro_gather_fuse_backward.restype is i
    assert lib.repro_gather_fuse_backward_scratch.argtypes == [i] * 4
    assert lib.repro_gather_fuse_backward_scratch.restype is ll
    assert set(vars(lib)) == {"repro_gather_fuse_backward",
                              "repro_gather_fuse_backward_scratch", "repro_error_string"}
    assert {512, 256, 128, 64, 32} == set(tk.FUSE_BACKWARD_POOLS)
    assert (33_280, "resident", tk.E, 400, 1024, 64) in tk.FUSE_BACKWARD_SHAPES


def _gather_fuse_args(device):
    return (torch.zeros(6, dtype=torch.int64, device=device),
            torch.empty(10, 8, device=device), torch.empty(10, 12, device=device),
            torch.empty(12, 4, device=device), torch.empty(4, device=device),
            torch.empty(12, 8, device=device), torch.empty(8, device=device))


@pytest.mark.parametrize("kernel", ["scoring", "intersect", "intersect_backward", "gather_fuse"])
def test_wrapper_rejects_tensors_off_cpu_and_cuda(kernel):
    meta = torch.empty((4, 2, 8), device="meta")
    if kernel == "scoring":
        with pytest.raises(ValueError):
            tops.scoring(meta[:, 0], torch.zeros(5, 8))
    elif kernel == "gather_fuse":
        ids, *rest = _gather_fuse_args("cpu")
        with pytest.raises(ValueError):
            tops.gather_fuse(ids, meta[:, 0], *rest[1:])
    else:
        w1, b1, w2, b2 = (torch.zeros(8, 16), torch.zeros(16),
                          torch.zeros(16, 1), torch.zeros(1))
        with pytest.raises(ValueError):
            if kernel == "intersect":
                tops.intersect(meta, w1, b1, w2, b2)
            else:
                tops.intersect_backward(meta, w1, b1, w2, b2, torch.zeros(4, 8))


@pytest.mark.parametrize("kernel", ["scoring", "intersect", "intersect_backward", "gather_fuse"])
def test_wrapper_on_cuda_tensors_raises_without_cuda(kernel):
    """A wrapper handed CUDA tensors (fake ones: this machine has no card)
    asks for its kernel and raises; it never takes the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    before = (tops.scoring.launches, tops.intersect.launches,
              tops.intersect_backward.launches, tops.gather_fuse.launches)
    with FakeTensorMode(), pytest.raises(RuntimeError, match="CUDA is not available"):
        if kernel == "gather_fuse":
            tops.gather_fuse(*_gather_fuse_args("cuda"))
        elif kernel == "scoring":
            tops.scoring(torch.empty(4, 8, device="cuda"),
                         torch.empty(5, 8, device="cuda"), 1.0, "l1")
        else:
            args = (torch.empty(3, 2, 8, device="cuda"), torch.empty(8, 16, device="cuda"),
                    torch.empty(16, device="cuda"), torch.empty(16, 1, device="cuda"),
                    torch.empty(1, device="cuda"))
            if kernel == "intersect":
                tops.intersect(*args)
            else:
                tops.intersect_backward(*args, torch.empty(3, 8, device="cuda"))
    assert (tops.scoring.launches, tops.intersect.launches,
            tops.intersect_backward.launches, tops.gather_fuse.launches) == before


def test_kernel_library_needs_cuda():
    """Asking for the CUDA kernels on a machine without CUDA raises; the
    wrappers never fall back to the plain version for a CUDA request."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.load_library()


def test_scoring_variant_query_needs_cuda():
    """Which variant a table takes is the kernel library's own rule; asking
    without CUDA raises instead of guessing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.scoring_aligned(torch.zeros(5, 8))


def test_library_path_keyed_by_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("librepro_kernels_") and path.suffix == ".so"
    assert {s.name for s in build.sources()} >= {
        "scoring.cu", "intersect.cu", "gather_fuse.cu", "common.cuh"}



def test_scoring_tile_query_needs_cuda():
    """Which tiling the kernel takes for N is the kernel library's own rule;
    asking without CUDA raises instead of guessing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.scoring_tile(torch.zeros(5, 8))


@pytest.mark.parametrize("tile", [None, *TILES])
def test_scoring_takes_a_forced_tile_and_rejects_others(tile):
    """A forced tiling is one of the kernel's two; on the CPU it changes
    nothing (the plain version runs), and any other value is refused before
    anything runs."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(7, 16)).astype(np.float32))
    got = tops.scoring(q, e, 1.5, "l1", tile=tile)
    assert torch.equal(got, tops.scoring_ref(q, e, 1.5, "l1"))
    with pytest.raises(ValueError, match="tile"):
        tops.scoring(q, e, 1.5, "l1", tile=8)


def test_library_path_keyed_by_another_source_dir(tmp_path):
    """Another version's sources (to time against) build a library of their
    own: its name is keyed by those sources, not by this checkout's."""
    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert build.library_path(tmp_path) == build.library_path()
    (tmp_path / "scoring.cu").write_text("// another version\n")
    other = build.library_path(tmp_path)
    assert other != build.library_path() and other.parent == build.BUILD_DIR
    assert [s.name for s in build.sources(tmp_path)] == [s.name for s in build.sources()]
