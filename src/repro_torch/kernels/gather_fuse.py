"""Semantic entity fusion (Eq. 11 + 12):

    e_fused = sigmoid([h_str[ids] ⊕ (h_sem[sem_ids]·Wp + bp)]·Wf + bf)·2 − 1

Replaces the TPU kernel ``src/repro/kernels/gather_fuse.py::
gather_fuse_pallas`` — both its row-gather geometry (``rows=1``, scalar-
prefetched row DMAs) and its blocked one (``rows>1``, XLA-side takes) — and
its wrappers ``src/repro/kernels/ops.py::gather_fuse``/``gather_fuse_params``
with the hand-written CUDA kernels of ``csrc/gather_fuse.cu`` for Hopper
(one launch a call).

What bounds it on the H100: each row carries 2·(dl·dp + (d+dp)·d) flops
(502k at d = 400, dl = 1024, dp = 64) against 7.3 KB of fp32 rows. The
kernel runs them on the tensor cores (wgmma) in 3xTF32: each fp32 operand
split into TF32 hi and lo parts, a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
summed in fp32 in that order (bf16 table rows are exact in TF32 and take the
last two), so the all-entity fusion of ``score_all`` (n = E) is bound by the
card's TF32 rate. One launch a call: a producer warpgroup splits the weights
slice by slice into a shared-memory ring while consumer warpgroups gather
their rows, project z into shared memory and accumulate h·Wf_h + zp·Wf_z in
registers (the concat never exists), with the sigmoid in the epilogue. Each
output is one accumulator chain whose order depends only on d, dl, dp and
the dtype, so a row's bits do not depend on the batch it came in with: the
resident table, the hot-set cache and a streamed chunk give the same row
bitwise.

Which of the two kernels a launch takes (128 rows a block, the pair
kernel, or 64 rows and a column pass a block, the split kernel) is the
autotuner's knob for it (``kernels/autotune.py``): the kernel's own choice
from n and the SM count unless the launch names one; given none, a launch
takes the process tuner's for its shape bucket. Out and zp have the same
bits under either.

``gather_fuse`` dispatches on where its inputs lie: CPU tensors take the
plain version ``gather_fuse_ref`` (and autograd through it); CUDA tensors
launch the kernel or raise; meta tensors (the dry run) launch nothing and are
reckoned (``kernels/reckon.py``), the backward too. On CUDA it is a ``torch.autograd.Function``
whose backward is the hand-written kernel of ``csrc/gather_fuse_backward.cu``
(``gather_fuse_backward``, fp32 only): the JAX package differentiates its
jnp ``fuse_semantic`` and has no backward kernel to port. Gradients go to
``h_str`` and the four weights; H_sem is frozen (as in the reference) and
gets none, and the ids none. The forward saves its output, from which the
backward takes the sigmoid's derivative, and zp = h_sem[sem_ids]·Wp + bp,
which the forward kernel stores from its shared memory as it fuses, so the
backward does not recompute it.

An id outside its table (``ids`` outside h_str's rows, or ``sem_ids``
outside h_sem's): the reference's jnp gathers clamp it to the nearest row;
the CUDA forward writes a NaN row (and reads nothing out of bounds); the CPU
path (``gather_fuse_ref``) raises ``IndexError``; the CUDA backward reads
such a row as zeros and writes no row of the ``h_str`` gradient for it, so
it writes nothing outside the gradients (the weights' gradients then carry
whatever the NaN output gives them).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune, build, reckon

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Rows a block of the two kernels: the pair kernel, the split kernel; 0 is
# the kernel's own choice.
ROWS = (128, 64)
# Up to this many rows the backward's segment sum finds each id's rows by
# scanning the ids (no sort launch); above it the wrapper sorts the ids.
UNSORTED_ROWS = 4096
INDEX_DTYPES = (torch.int32, torch.int64)
# The gradients gather_fuse_backward returns, in order.
GRADIENTS = ("dh_str", "dwp", "dbp", "dwf", "dbf")


def _compute_dtype(t) -> torch.dtype:
    """fp32, or fp64 for an fp64 table (the exact value the checks compare
    to)."""
    return torch.promote_types(t.dtype, torch.float32)


def gather_fuse_ref(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=None) -> torch.Tensor:
    """Plain PyTorch version: ids [n] -> [n, d] in h_str's dtype, computed in
    fp32 (fp64 for an fp64 h_str). ``sem_ids`` indexes ``h_sem`` (cache
    slots); None = ``ids``. Differentiable."""
    sem_ids = ids if sem_ids is None else sem_ids
    dt = _compute_dtype(h_str)
    h = h_str[ids].to(dt)
    z = h_sem[sem_ids].to(dt) @ wp.to(dt) + bp.to(dt)
    x = torch.cat([h, z], dim=-1)
    return (torch.sigmoid(x @ wf.to(dt) + bf.to(dt)) * 2.0 - 1.0).to(h_str.dtype)


def _check_shapes(name, ids, h_str, h_sem, wp, bp, wf, bf, sem_ids):
    """The shapes both paths take. Returns (n, d, dl, dp)."""
    if ids.dim() != 1 or h_str.dim() != 2 or h_sem.dim() != 2:
        raise ValueError(f"{name}: need ids [n], h_str [E, d] and h_sem "
                         f"[rows, dl], got {tuple(ids.shape)}, "
                         f"{tuple(h_str.shape)} and {tuple(h_sem.shape)}")
    n = ids.shape[0]
    d, dl, dp = h_str.shape[1], h_sem.shape[1], wp.shape[-1]
    if wf.dim() != 2 or wf.shape[0] != d + dp:
        raise ValueError(
            f"{name}: fuse weight rows {wf.shape[0]} != d+dp = "
            f"{d}+{dp} = {d + dp}")
    if (tuple(wp.shape) != (dl, dp) or bp.numel() != dp or wf.shape[1] != d
            or bf.numel() != d):
        raise ValueError(
            f"{name}: weights wp {tuple(wp.shape)}, bp {tuple(bp.shape)}, "
            f"wf {tuple(wf.shape)}, bf {tuple(bf.shape)} do not fit d={d}, "
            f"dl={dl}")
    if sem_ids is not None and sem_ids.shape != ids.shape:
        raise ValueError(
            f"{name}: sem_ids shape {tuple(sem_ids.shape)} != ids shape "
            f"{tuple(ids.shape)}")
    return n, d, dl, dp


def _on_cpu(name, tensors) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie on
    one CUDA device instead."""
    ids = tensors[0]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if ids.device.type != "cuda" or any(t.device != ids.device for t in tensors):
        raise ValueError(f"{name}: inputs must all lie on the CPU or on "
                         f"one CUDA device, got ids on {ids.device}")
    return False


def _check_index_dtypes(name, ids, sem_ids):
    if ids.dtype not in INDEX_DTYPES or (
            sem_ids is not None and sem_ids.dtype not in INDEX_DTYPES):
        raise TypeError(f"{name}: ids must be int32 or int64, got "
                        f"{ids.dtype}")


def _check_kernel_inputs(name, tensors, sem_ids):
    """What the forward kernel takes: tables of one dtype in DTYPES, fp32
    weights, int32/int64 ids, everything contiguous. ``tensors`` are
    (ids, h_str, h_sem, wp, bp, wf, bf[, sem_ids])."""
    ids, h_str, h_sem, *weights = tensors[:7]
    if (h_str.dtype not in DTYPES or h_sem.dtype != h_str.dtype
            or any(w.dtype != torch.float32 for w in weights)):
        raise TypeError(f"{name}: the tables must share a dtype in "
                        f"{list(DTYPES)} and the weights be float32, got "
                        f"h_str {h_str.dtype}, h_sem {h_sem.dtype}")
    _check_index_dtypes(name, ids, sem_ids)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_rows(name, rows) -> None:
    if rows is not None and (rows not in (0, *ROWS) or isinstance(rows, bool)):
        raise ValueError(f"{name}: rows must be None, 0 or one of {ROWS}, got {rows!r}")


def gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=None, *,
                rows: int | None = None) -> torch.Tensor:
    """ids [n] (rows of h_str [E, d]) -> fused entity vectors [n, d] in
    h_str's dtype. h_sem is the full H_sem [E, dl] or the hot-set cache
    [budget, dl] with ``sem_ids`` its slots; wp [dl, dp], bp [dp],
    wf [d + dp, d], bf [d]. ``rows`` names the kernel (``ROWS``; 0 the
    kernel's own choice; None the process tuner's config,
    ``autotune.tuned_config``); the plain version on CPU tensors takes none,
    but it is checked all the same. Counts each kernel launch in
    ``gather_fuse.launches``; under autograd its backward launches
    ``gather_fuse_backward`` (fp32 tables only; an h_sem that requires a
    gradient raises, H_sem being frozen)."""
    _check_shapes("gather_fuse", ids, h_str, h_sem, wp, bp, wf, bf, sem_ids)
    _check_rows("gather_fuse", rows)
    tensors = [ids, h_str, h_sem, wp, bp, wf, bf]
    if sem_ids is not None:
        tensors.append(sem_ids)
    if not reckon.on_meta(tensors) and _on_cpu("gather_fuse", tensors):
        return gather_fuse_ref(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids)
    _check_kernel_inputs("gather_fuse", tensors, sem_ids)
    weights = (wp, bp, wf, bf)
    if not torch.is_grad_enabled():
        return _launch(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, rows=rows)
    if h_sem.requires_grad:
        raise ValueError("gather_fuse: h_sem requires a gradient, but H_sem is "
                         "frozen and its backward gives it none")
    if h_str.dtype != torch.float32 and any(t.requires_grad for t in (h_str, *weights)):
        raise TypeError(f"gather_fuse: the backward takes float32 tables only, "
                        f"got {h_str.dtype} under autograd")
    return _GatherFuse.apply(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, rows)


class _GatherFuse(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, rows):
        zp = torch.empty((ids.shape[0], wp.shape[-1]), dtype=torch.float32, device=ids.device)
        out = _launch(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, zp=zp, rows=rows)
        ctx.save_for_backward(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, out, zp)
        return out

    @staticmethod
    def backward(ctx, g):
        ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, out, zp = ctx.saved_tensors
        dh, dwp, dbp, dwf, dbf = gather_fuse_backward(
            ids, h_str, h_sem, wp, bp, wf, bf, g.contiguous(), sem_ids=sem_ids, out=out,
            zp=zp)
        grads = (None, dh, None, dwp, dbp, dwf, dbf, None)
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (None,)


def _launch(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, zp=None, rows=None) -> torch.Tensor:
    """The forward kernel; given ``zp`` ([n, dp] fp32), it also stores each
    row's z·Wp + bp there. ``rows`` as ``gather_fuse`` takes it."""
    if ids.device.type == "meta":
        return reckon.gather_fuse(ids, h_str, h_sem, wp, sem_ids, zp is not None)
    n, d, dl, dp = ids.shape[0], h_str.shape[1], h_sem.shape[1], wp.shape[-1]
    out = torch.empty((n, d), dtype=h_str.dtype, device=ids.device)
    if n == 0:
        return out
    if rows is None:
        rows = autotune.tuned_config("gather_fuse", (n, d, dl, dp), h_str)["rows"]
    ids64 = ids.long()
    sem64 = ids64 if sem_ids is None else sem_ids.long()
    lib = build.load_library()
    with torch.cuda.device(ids.device):
        err = lib.repro_gather_fuse(
            ids64.data_ptr(), sem64.data_ptr(), h_str.data_ptr(),
            h_sem.data_ptr(), wp.data_ptr(), bp.data_ptr(), wf.data_ptr(),
            bf.data_ptr(), None if zp is None else zp.data_ptr(), out.data_ptr(), n,
            h_str.shape[0], h_sem.shape[0], d, dl, dp, DTYPES[h_str.dtype], rows,
            build.stream_handle(ids))
    build.check(lib, err, "gather_fuse")
    gather_fuse.launches += 1
    return out


gather_fuse.launches = 0


def gather_fuse_and_zp(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=None, *,
                       rows: int | None = None):
    """(``gather_fuse``'s output, zp = h_sem[sem_ids]·Wp + bp [n, dp] fp32):
    what training's forward saves for the backward. CPU tensors take the
    plain versions; CUDA tensors launch the forward kernel once (counted in
    ``gather_fuse.launches``; ``rows`` as ``gather_fuse`` takes it), which
    stores zp as it fuses."""
    n, _, _, dp = _check_shapes("gather_fuse_and_zp", ids, h_str, h_sem, wp, bp, wf, bf,
                                sem_ids)
    _check_rows("gather_fuse_and_zp", rows)
    tensors = [ids, h_str, h_sem, wp, bp, wf, bf] + ([] if sem_ids is None else [sem_ids])
    if not reckon.on_meta(tensors) and _on_cpu("gather_fuse_and_zp", tensors):
        dt = _compute_dtype(h_str)
        z = h_sem[ids if sem_ids is None else sem_ids].to(dt)
        return (gather_fuse_ref(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids),
                z @ wp.to(dt) + bp.to(dt))
    _check_kernel_inputs("gather_fuse_and_zp", tensors, sem_ids)
    zp = torch.empty((n, dp), dtype=torch.float32, device=ids.device)
    return _launch(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids, zp=zp, rows=rows), zp


def gather_fuse_backward_ref(ids, h_str, h_sem, wp, bp, wf, bf, g, sem_ids=None,
                             out=None):
    """Plain PyTorch version of ``gather_fuse_backward``: autograd through
    ``gather_fuse_ref`` (``out`` is not needed: it recomputes the forward).
    Returns (dh_str, dwp, dbp, dwf, dbf) in fp32 (fp64 for an fp64 h_str, the
    value the checks hold a backward to)."""
    del out
    dt = _compute_dtype(h_str)
    with torch.enable_grad():
        leaves = [t.detach().to(dt).requires_grad_(True) for t in (h_str, wp, bp, wf, bf)]
        y = gather_fuse_ref(ids, leaves[0], h_sem.detach().to(dt), *leaves[1:], sem_ids=sem_ids)
        return torch.autograd.grad(y, leaves, g.to(dt))


def gather_fuse_backward_allowance(ids, h_str, h_sem, wp, bp, wf, bf, g, sem_ids=None):
    """For each gradient of ``gather_fuse_backward_ref``, elementwise and in
    fp64, how far an fp32 backward may lie from the exact value on top of
    1e-4 of it: 1e-5 of the sum of the magnitudes of the terms the element
    adds up, carried through every intermediate (an fp32 sum's rounding
    error is a small multiple of fp32's epsilon times that, whatever its
    order). So |X|ᵀ·|dpre| for dWf, with X = h ⊕ zp and dpre the gradient
    at the sigmoid's input, t = g·(1 − o²)/2 for o the output. t's terms are
    |g|·(1 + o²)/2, and it also carries the rounding of the forward's
    pre-activation y through o (|dt/dy| times y's terms): near o = ±1 the
    factor 1 − o² cancels, so no tolerance on t's own size holds."""
    sem_ids = ids if sem_ids is None else sem_ids
    H = h_str.detach().double()[ids]
    Z = h_sem.detach().double()[sem_ids]
    Wp, Bp, Wf, Bf, G = (t.detach().double() for t in (wp, bp, wf, bf, g))
    d = H.shape[1]
    Bp, Bf = Bp.reshape(-1), Bf.reshape(-1)
    o = torch.sigmoid(torch.cat([H, Z @ Wp + Bp], -1) @ Wf + Bf) * 2 - 1
    Zm = Z.abs() @ Wp.abs() + Bp.abs()                 # zp's terms
    Xm = torch.cat([H.abs(), Zm], -1)                   # X's
    Ym = Xm @ Wf.abs() + Bf.abs()                       # y's
    Ga = G.abs()
    Dt = Ga * (1 + o * o) / 2 + Ga * o.abs() * (1 - o * o) / 2 * Ym
    DX = Dt @ Wf.abs().T                                # dX's: dh, then dzp
    dh = torch.zeros(h_str.shape, dtype=torch.float64, device=H.device)
    dh.index_add_(0, ids.long(), DX[:, :d])
    return (1e-5 * dh, 1e-5 * (Z.abs().T @ DX[:, d:]),
            1e-5 * DX[:, d:].sum(0).reshape(bp.shape), 1e-5 * (Xm.T @ Dt),
            1e-5 * Dt.sum(0).reshape(bf.shape))


def gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, g, sem_ids=None, out=None,
                         zp=None):
    """Gradients of ``gather_fuse`` given g = dL/dout [n, d]: (dh_str
    [E, d], dwp [dl, dp], dbp [dp], dwf [d + dp, d], dbf [d]). dh_str is
    zero but in the rows ``ids`` name, each the sum of its rows' gradients in
    the order they come in ``ids``. ``out`` is the forward's output and
    ``zp`` [n, dp] its h_sem[sem_ids]·Wp + bp (``gather_fuse_and_zp``, as
    training saves them): without ``zp`` the kernels recompute it; without
    ``out`` the forward kernel runs first (counted in ``gather_fuse.launches``)
    and gives both. CPU tensors take ``gather_fuse_backward_ref``; CUDA
    tensors launch the kernels of ``csrc/gather_fuse_backward.cu`` (fp32 and
    contiguous only) or raise. Counts each call in
    ``gather_fuse_backward.launches``."""
    n, d, dl, dp = _check_shapes("gather_fuse_backward", ids, h_str, h_sem, wp, bp, wf,
                                 bf, sem_ids)
    if tuple(g.shape) != (n, d) or (out is not None and tuple(out.shape) != (n, d)):
        raise ValueError(f"gather_fuse_backward: need g and out [{n}, {d}], got "
                         f"{tuple(g.shape)} and "
                         f"{None if out is None else tuple(out.shape)}")
    if zp is not None and tuple(zp.shape) != (n, dp):
        raise ValueError(f"gather_fuse_backward: need zp [{n}, {dp}], got {tuple(zp.shape)}")
    tensors = [ids, h_str, h_sem, wp, bp, wf, bf, g]
    tensors += [t for t in (sem_ids, out, zp) if t is not None]
    if reckon.on_meta(tensors):
        return reckon.gather_fuse_backward(ids, h_str, h_sem, wp, bp, wf, bf, UNSORTED_ROWS)
    if _on_cpu("gather_fuse_backward", tensors):
        return gather_fuse_backward_ref(ids, h_str, h_sem, wp, bp, wf, bf, g, sem_ids)
    floats = [t for t in tensors if t is not ids and t is not sem_ids]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"gather_fuse_backward: tables, weights, g, out and zp must be "
                        f"float32, got h_str {h_str.dtype}, h_sem {h_sem.dtype} and "
                        f"g {g.dtype}")
    _check_index_dtypes("gather_fuse_backward", ids, sem_ids)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_fuse_backward: inputs must be contiguous")
    # dh_str is zero outside the rows the ids name; the kernels write every
    # element of the others.
    grads = (torch.zeros_like(h_str), *(torch.empty_like(t) for t in (wp, bp, wf, bf)))
    if n == 0:
        return (grads[0], *(t.zero_() for t in grads[1:]))
    if out is None:
        out, zp = gather_fuse_and_zp(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids)
    ids64 = ids.long()
    sem64 = ids64 if sem_ids is None else sem_ids.long()
    # The order in which dh_str's segment sums add a row's repeats: the order
    # they come in (small n: the kernel scans the ids for them).
    sorted_ids = order = None
    if n > UNSORTED_ROWS:
        sorted_ids, order = torch.sort(ids64, stable=True)
    lib = build.load_library()
    # Scratch: Wf and Wpᵀ split, zp (when recomputed), dh, tᵀ and dzpᵀ split,
    # and the weight gradients' chunk partials.
    scratch = torch.empty(lib.repro_gather_fuse_backward_scratch(n, d, dl, dp),
                          dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        err = lib.repro_gather_fuse_backward(
            ids64.data_ptr(), sem64.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (sorted_ids, order)),
            h_str.data_ptr(), h_sem.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            wf.data_ptr(), bf.data_ptr(), None if zp is None else zp.data_ptr(),
            out.data_ptr(), g.data_ptr(), scratch.data_ptr(),
            *(t.data_ptr() for t in grads), n, h_str.shape[0], h_sem.shape[0], d, dl, dp,
            build.stream_handle(ids))
    build.check(lib, err, "gather_fuse_backward")
    gather_fuse_backward.launches += 1
    return grads


gather_fuse_backward.launches = 0


def semantic_source(params, ids):
    """(h_sem, sem_ids) for ``ids`` in whichever semantic layout a model
    params mapping carries: the resident ``sem_table`` (sem_ids None = ids),
    or the hot-set ``sem_cache`` through the ``sem_slot`` indirection. The
    one place the layout is resolved."""
    if "sem_slot" in params:
        return params["sem_cache"], params["sem_slot"][ids]
    return params["sem_table"], None


def gather_fuse_params(params, ids, rows=None) -> torch.Tensor:
    """Fuse ``ids`` straight from a model params mapping, in either semantic
    layout (``semantic_source``). ``rows`` are the ids' rows of ``entity``
    (and of a resident ``sem_table``) where the table holds only some ids'
    rows; ``ids`` by default."""
    h_sem, sem_ids = semantic_source(params, ids)
    return gather_fuse(ids if rows is None else rows, params["entity"], h_sem,
                       params["sem_proj_w"], params["sem_proj_b"],
                       params["fuse_w"], params["fuse_b"], sem_ids=sem_ids)
