"""Cardinality-class attention intersection (Eq. 8/9).

Replaces the TPU kernel ``src/repro/kernels/intersect.py::intersect_pallas``
(body ``_intersect_kernel``, wrapper ``src/repro/kernels/ops.py::intersect``)
with the hand-written CUDA kernel of ``csrc/intersect.cu`` for Hopper.

What bounds it on the H100: BetaE's attention MLP is 800→800→1, so each pool
row costs k·d·hd = k·640,000 multiply-adds against W1's 2.56 MB (fp32). At
serving pools (n·k of a few dozen rows) the call is bound by reading W1
once, which only the whole card reads fast; at training pools (n·k in the
thousands) by the fp32 CUDA cores. The kernel is one launch: W1 is cut into
64-unit hidden blocks × 8 depth chunks, and a thread block cluster of 8
blocks takes one hidden block for one row group, each block one chunk, with
register-tiled FMA chains; the cluster folds its chunks through distributed
shared memory into one partial logit per (32-unit tile, row), and the
cluster that arrives last for a row group takes the softmax over k and
writes the weighted combine from the x it holds. h and the logits never
leave the launch except as those partial logits. A thread holds 4 rows × 8
hidden units of the chunk's product in registers, at every pool size.

Every sum runs in an order fixed by d and hd alone (8 depth chunks of
``chunk_len(d)``, each one FMA chain, added in order; 32-unit hidden tiles
summed by a fixed tree; the tiles the same way), so a row's bits do not
depend on the pool's size or the row's place in it. Any
k >= 1. The TPU wrapper pads the logit head to 128 lanes; this one does not
need to.

The pool rows of a row group are the autotuner's knob for it
(``kernels/autotune.py``): ``group_rows(k)`` unless the launch names
another; given none, a launch takes the process tuner's for its shape
bucket. A row's bits do not depend on it.

``intersect`` dispatches on where its inputs lie: CPU tensors take the plain
version ``intersect_ref``; CUDA tensors launch the kernel or raise; meta
tensors (the dry run) launch nothing and are reckoned (``kernels/reckon.py``),
the backward too. On CUDA
it is a ``torch.autograd.Function`` whose backward is the hand-written kernel
of ``csrc/intersect_backward.cu`` (``intersect_backward``, fp32 only): the
JAX package differentiates its jnp path and has no backward kernel to port.
The backward recomputes h and the logits from x and the weights, so the
forward saves only its inputs. It is two launches of thread block clusters
with its products on the tensor cores in 3xTF32: the first recomputes
x·W1 + b1 into scratch and, in the cluster that arrives last for a row
group, the softmax and dL/dlogit; the second takes dW1 (db1 as one more
row; dw2 and db2 in its first row of tiles) and dx. Its arrival counters
are its own, one buffer per (device, stream) apart from the forward's.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import autotune, build, reckon

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RG = 64             # input rows of a default row group (csrc/intersect.cu)
MAX_GROUPS = 65535  # row groups a launch takes: the grid's y

_lock = threading.Lock()
# Arrival counters per (device index, stream): the forward's, and the
# backward's apart from them.
_counters: dict[tuple[int, int], torch.Tensor] = {}
_backward_counters: dict[tuple[int, int], torch.Tensor] = {}


def _compute_dtype(x) -> torch.dtype:
    """fp32, or fp64 for an fp64 x (the exact value the checks compare to)."""
    return torch.promote_types(x.dtype, torch.float32)


def intersect_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: x [n, k, d] -> [n, d] in x's dtype, computed in
    fp32 (fp64 for fp64 x). Attention logits from a 2-layer MLP, softmax over
    k, weighted combine (BetaE/Q2B-style intersection)."""
    dt = _compute_dtype(x)
    xf = x.to(dt)
    h = torch.relu(xf @ w1.to(dt) + b1.to(dt))          # [n, k, hd]
    logits = h @ w2.to(dt) + b2.to(dt)                   # [n, k, 1]
    att = torch.softmax(logits, dim=1)
    return (att * xf).sum(dim=1).to(x.dtype)


def _check_shapes(x, w1, b1, w2, b2):
    """The shapes both paths take: x [n, k, d] with k, d >= 1 and an MLP
    d -> hd -> 1 with hd >= 1. Returns (n, k, d, hd)."""
    if x.dim() != 3:
        raise ValueError(f"intersect: need x [n, k, d], got {tuple(x.shape)}")
    n, k, d = x.shape
    hd = w1.shape[-1]
    if (w1.dim() != 2 or tuple(w1.shape) != (d, hd) or b1.numel() != hd
            or w2.numel() != hd or b2.numel() != 1):
        raise ValueError(
            f"intersect: MLP shapes w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} do not fit d={d}")
    if k < 1 or d < 1 or hd < 1:
        raise ValueError(f"intersect: need k, d and hd >= 1, got k={k}, d={d}, hd={hd}")
    return n, k, d, hd


def group_rows(k: int) -> int:
    """Pool rows of the kernel's own row group for k inputs a row: whole
    rows of at most RG inputs, or one (``csrc/intersect.cu::group_rows``)."""
    return 1 if k >= RG else RG // k


def _check_rows(rows, n: int, k: int) -> None:
    """``rows``: None (the tuner's), 0 (``group_rows(k)``), or the pool rows
    of a row group, whose groups must fit the grid. The kernel refuses, and
    nothing falls back from, a group whose logits overflow shared memory."""
    if rows is None:
        return
    if not isinstance(rows, int) or isinstance(rows, bool) or rows < 0:
        raise ValueError(f"intersect: rows must be None or an int >= 0, got {rows!r}")
    groups = -(-n // (rows or group_rows(k)))
    if groups > MAX_GROUPS:
        raise ValueError(f"intersect: rows={rows} cuts {n} pool rows into {groups} "
                         f"row groups; a launch takes at most {MAX_GROUPS}")


def _arrival_counters(x: torch.Tensor, groups: int, table=_counters) -> torch.Tensor:
    """A kernel's per-row-group arrival counters for PyTorch's current
    stream on x's device, from ``table`` (the forward's or the backward's):
    zero between launches (the last arrival resets its counter), so one
    buffer serves every launch of that kernel on that stream, and launches
    on two streams never share one."""
    key = (x.device.index, build.stream_handle(x))
    with _lock:
        buf = table.get(key)
        if buf is None or buf.numel() < groups:
            size = 1 << max(groups - 1, 0).bit_length()
            buf = table[key] = torch.zeros(size, dtype=torch.int32, device=x.device)
        return buf


def _on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie on
    one CUDA device instead."""
    x = tensors[0]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"intersect: inputs must all lie on the CPU or on "
                         f"one CUDA device, got x on {x.device}")
    return False


def intersect(x, w1, b1, w2, b2, *, rows: int | None = None) -> torch.Tensor:
    """x [n, k, d], MLP (w1 [d, hd], b1 [hd], w2 [hd, 1], b2 [1]) -> [n, d].
    ``rows``: the pool rows of a row group (0: ``group_rows(k)``; None: the
    process tuner's config, ``autotune.tuned_config``); the plain version on
    CPU tensors takes none, but it is checked all the same. Counts each
    launch of the kernel in ``intersect.launches``; under autograd its
    backward launches ``intersect_backward``."""
    n, k, _, _ = _check_shapes(x, w1, b1, w2, b2)
    _check_rows(rows, n, k)
    if reckon.on_meta((x, w1, b1, w2, b2)):
        return _Intersect.apply(x, w1, b1, w2, b2, rows)
    if _on_cpu((x, w1, b1, w2, b2)):
        return intersect_ref(x, w1, b1, w2, b2)
    if x.dtype not in DTYPES or any(p.dtype != torch.float32 for p in (w1, b1, w2, b2)):
        raise TypeError(f"intersect: x must be one of {list(DTYPES)} and the "
                        f"MLP float32, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, w1, b1, w2, b2)):
        raise ValueError("intersect: inputs must be contiguous")
    return _Intersect.apply(x, w1, b1, w2, b2, rows)


class _Intersect(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rows):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2, rows)

    @staticmethod
    def backward(ctx, g):
        grads = intersect_backward(*ctx.saved_tensors, g.contiguous())
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (None,)


def _launch(x, w1, b1, w2, b2, rows) -> torch.Tensor:
    if x.device.type == "meta":
        return reckon.intersect(x, w1)
    n, k, d, hd = x.shape[0], x.shape[1], x.shape[2], w1.shape[1]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    if rows is None:
        rows = autotune.tuned_config("intersect", (n, k, d, hd), x)["rows"]
        _check_rows(rows, n, k)
    lib = build.load_library()
    # Scratch: one partial logit per (hidden tile, input row).
    partial = torch.empty((lib.repro_intersect_tiles(hd), n * k),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        counters = _arrival_counters(x, lib.repro_intersect_groups(n, k, rows))
        err = lib.repro_intersect_fused(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                        w2.data_ptr(), b2.data_ptr(), partial.data_ptr(),
                                        counters.data_ptr(), out.data_ptr(), n, k, d, hd,
                                        DTYPES[x.dtype], rows, build.stream_handle(x))
    build.check(lib, err, "intersect")
    intersect.launches += 1
    return out


intersect.launches = 0


def intersect_backward_ref(x, w1, b1, w2, b2, g):
    """Plain PyTorch version of ``intersect_backward``: autograd through
    ``intersect_ref``. Returns (dx, dw1, db1, dw2, db2) in fp32 (fp64 for
    fp64 x, the value the checks hold a backward to)."""
    dt = _compute_dtype(x)
    with torch.enable_grad():
        leaves = [t.detach().to(dt).requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        return torch.autograd.grad(intersect_ref(*leaves), leaves, g.to(dt))


def intersect_backward_allowance(x, w1, b1, w2, b2, g):
    """For each gradient of ``intersect_backward_ref``, elementwise and in
    fp64, how far an fp32 backward may lie from the exact value on top of
    1e-4 of it. Two parts:

    * 1e-5 of the sum of the magnitudes of the terms the element adds up,
      carried through every intermediate (an fp32 sum's rounding error is a
      small multiple of fp32's epsilon times that, whatever its order). The
      size of an element is no such scale: dL/dlogit_j = att_j (datt_j -
      sum_i att_i datt_i) cancels where a pool row's inputs are alike
      (BetaE's states lie near one another), so the gradients that sum it —
      dw2, db1, dw1, and db2, which is 0 in exact arithmetic — carry rounding
      far above 1e-5 of their own size in any fp32 backward.
    * the whole contribution of each pre-activation within 1e-5 of its
      terms' magnitudes of 0: fp32 may put it on either side of the relu.
    """
    X, W1, B1, W2, B2, G = (t.detach().double() for t in (x, w1, b1, w2, b2, g))
    n, k, d = X.shape
    pre = X @ W1 + B1                                     # [n, k, hd]
    h = torch.relu(pre)
    att = torch.softmax(h @ W2 + B2, dim=1)[..., 0]      # [n, k]
    gx = G[:, None, :] * X
    datt = gx.sum(-1)
    dlogit = att * (datt - (att * datt).sum(1, keepdim=True))
    A = gx.abs().sum(-1)                                  # datt's terms
    Dl = att * (A + (att * A).sum(1, keepdim=True))      # dlogit's, through datt
    H = X.abs() @ W1.abs() + B1.abs()                     # pre's terms
    w2a = W2.abs()[:, 0]
    Dh = Dl[..., None] * w2a * (pre > 0)                  # dh's
    # The dh an uncertain relu may add or drop, whole.
    J = dlogit.abs()[..., None] * w2a * (pre.abs() <= 1e-5 * H)
    Xa, W1a = X.abs().reshape(n * k, d), W1.abs()
    return (
        1e-5 * (att[..., None] * G[:, None, :].abs() + Dh @ W1a.T) + J @ W1a.T,
        1e-5 * (Xa.T @ Dh.reshape(n * k, -1)) + Xa.T @ J.reshape(n * k, -1),
        1e-5 * Dh.sum((0, 1)) + J.sum((0, 1)),
        1e-5 * (h * Dl[..., None] + H * dlogit.abs()[..., None]).sum((0, 1))[:, None],
        1e-5 * Dl.sum().reshape(1),
    )


GRADIENTS = ("dx", "dw1", "db1", "dw2", "db2")


def backward_shares(grads, exact, allowed, names=GRADIENTS) -> dict[str, float]:
    """For each gradient of a backward (named by ``names``: this module's
    ``GRADIENTS``, or ``gather_fuse.GRADIENTS``), the largest |error| /
    (1e-4·|exact| + allowance) over its elements against ``exact`` (the
    plain version on fp64 inputs) and ``allowed`` (the backward's
    ``*_allowance``): the share of its tolerance it uses, at most 1 to
    pass."""
    return {name: float(((t.double() - e).abs() / (1e-4 * e.abs() + al).clamp_min(1e-300)).max())
            for name, t, e, al in zip(names, grads, exact, allowed)}


def intersect_backward(x, w1, b1, w2, b2, g):
    """Gradients of ``intersect`` given g = dL/dout [n, d]: (dx [n, k, d],
    dw1 [d, hd], db1 [hd], dw2 [hd, 1], db2 [1]). CPU tensors take
    ``intersect_backward_ref``; CUDA tensors launch the kernel of
    ``csrc/intersect_backward.cu`` (fp32 and contiguous only) or raise.
    Counts each launch in ``intersect_backward.launches``."""
    n, k, d, hd = _check_shapes(x, w1, b1, w2, b2)
    if tuple(g.shape) != (n, d):
        raise ValueError(f"intersect_backward: need g [{n}, {d}], got {tuple(g.shape)}")
    tensors = (x, w1, b1, w2, b2, g)
    if reckon.on_meta(tensors):
        return reckon.intersect_backward(x, w1, b1, w2, b2)
    if _on_cpu(tensors):
        return intersect_backward_ref(x, w1, b1, w2, b2, g)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"intersect_backward: every input must be float32, got x "
                        f"{x.dtype} and g {g.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("intersect_backward: inputs must be contiguous")
    if n == 0:
        return (torch.empty_like(x), *(torch.zeros_like(t) for t in (w1, b1, w2, b2)))
    # The kernel writes every element of every gradient.
    dx, dw1, db1, dw2, db2 = (torch.empty_like(t) for t in (x, w1, b1, w2, b2))
    lib = build.load_library()
    # Scratch: x·W1 + b1, the partial logits and <g, x> of each depth chunk,
    # attention weights and dL/dlogit.
    scratch = torch.empty(lib.repro_intersect_backward_scratch(n, k, hd),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        counters = _arrival_counters(x, lib.repro_intersect_backward_groups(n, k),
                                     _backward_counters)
        err = lib.repro_intersect_backward(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), scratch.data_ptr(), counters.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), n, k, d, hd,
            build.stream_handle(x))
    build.check(lib, err, "intersect_backward")
    intersect_backward.launches += 1
    return dx, dw1, db1, dw2, db2


intersect_backward.launches = 0
