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

``gather_fuse`` dispatches on where its inputs lie: CPU tensors take the
plain version ``gather_fuse_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INDEX_DTYPES = (torch.int32, torch.int64)


def gather_fuse_ref(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=None) -> torch.Tensor:
    """Plain PyTorch version: ids [n] -> [n, d] in h_str's dtype, computed in
    fp32. ``sem_ids`` indexes ``h_sem`` (cache slots); None = ``ids``."""
    sem_ids = ids if sem_ids is None else sem_ids
    h = h_str[ids].float()
    z = h_sem[sem_ids].float() @ wp.float() + bp.float()
    x = torch.cat([h, z], dim=-1)
    return (torch.sigmoid(x @ wf.float() + bf.float()) * 2.0 - 1.0).to(h_str.dtype)


def gather_fuse(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=None) -> torch.Tensor:
    """ids [n] (rows of h_str [E, d]) -> fused entity vectors [n, d] in
    h_str's dtype. h_sem is the full H_sem [E, dl] or the hot-set cache
    [budget, dl] with ``sem_ids`` its slots; wp [dl, dp], bp [dp],
    wf [d + dp, d], bf [d]. Counts each kernel launch in
    ``gather_fuse.launches``."""
    if ids.dim() != 1 or h_str.dim() != 2 or h_sem.dim() != 2:
        raise ValueError(f"gather_fuse: need ids [n], h_str [E, d] and h_sem "
                         f"[rows, dl], got {tuple(ids.shape)}, "
                         f"{tuple(h_str.shape)} and {tuple(h_sem.shape)}")
    n = ids.shape[0]
    d, dl, dp = h_str.shape[1], h_sem.shape[1], wp.shape[-1]
    if wf.dim() != 2 or wf.shape[0] != d + dp:
        raise ValueError(
            f"gather_fuse: fuse weight rows {wf.shape[0]} != d+dp = "
            f"{d}+{dp} = {d + dp}")
    if (tuple(wp.shape) != (dl, dp) or bp.numel() != dp or wf.shape[1] != d
            or bf.numel() != d):
        raise ValueError(
            f"gather_fuse: weights wp {tuple(wp.shape)}, bp {tuple(bp.shape)}, "
            f"wf {tuple(wf.shape)}, bf {tuple(bf.shape)} do not fit d={d}, "
            f"dl={dl}")
    if sem_ids is not None and sem_ids.shape != ids.shape:
        raise ValueError(
            f"gather_fuse: sem_ids shape {tuple(sem_ids.shape)} != ids shape "
            f"{tuple(ids.shape)}")
    tensors = [ids, h_str, h_sem, wp, bp, wf, bf]
    if sem_ids is not None:
        tensors.append(sem_ids)
    if all(t.device.type == "cpu" for t in tensors):
        return gather_fuse_ref(ids, h_str, h_sem, wp, bp, wf, bf, sem_ids)
    if ids.device.type != "cuda" or any(t.device != ids.device for t in tensors):
        raise ValueError(f"gather_fuse: inputs must all lie on the CPU or on "
                         f"one CUDA device, got ids on {ids.device}")
    weights = (wp, bp, wf, bf)
    if (h_str.dtype not in DTYPES or h_sem.dtype != h_str.dtype
            or any(w.dtype != torch.float32 for w in weights)):
        raise TypeError(f"gather_fuse: the tables must share a dtype in "
                        f"{list(DTYPES)} and the weights be float32, got "
                        f"h_str {h_str.dtype}, h_sem {h_sem.dtype}")
    if ids.dtype not in INDEX_DTYPES or (
            sem_ids is not None and sem_ids.dtype not in INDEX_DTYPES):
        raise TypeError(f"gather_fuse: ids must be int32 or int64, got "
                        f"{ids.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_fuse: inputs must be contiguous")
    out = torch.empty((n, d), dtype=h_str.dtype, device=ids.device)
    if n == 0:
        return out
    ids64 = ids.long()
    sem64 = ids64 if sem_ids is None else sem_ids.long()
    lib = build.load_library()
    # zp (the C interface's [n, dp] scratch) is null: the kernel projects
    # each block's rows into its shared memory.
    with torch.cuda.device(ids.device):
        err = lib.repro_gather_fuse(
            ids64.data_ptr(), sem64.data_ptr(), h_str.data_ptr(),
            h_sem.data_ptr(), wp.data_ptr(), bp.data_ptr(), wf.data_ptr(),
            bf.data_ptr(), None, out.data_ptr(), n, h_str.shape[0],
            h_sem.shape[0], d, dl, dp, DTYPES[h_str.dtype],
            build.stream_handle(ids))
    build.check(lib, err, "gather_fuse")
    gather_fuse.launches += 1
    return out


gather_fuse.launches = 0


def semantic_source(params, ids):
    """(h_sem, sem_ids) for ``ids`` in whichever semantic layout a model
    params mapping carries: the resident ``sem_table`` (sem_ids None = ids),
    or the hot-set ``sem_cache`` through the ``sem_slot`` indirection. The
    one place the layout is resolved."""
    if "sem_slot" in params:
        return params["sem_cache"], params["sem_slot"][ids]
    return params["sem_table"], None


def gather_fuse_params(params, ids) -> torch.Tensor:
    """Fuse ``ids`` straight from a model params mapping, in either semantic
    layout (``semantic_source``)."""
    h_sem, sem_ids = semantic_source(params, ids)
    return gather_fuse(ids, params["entity"], h_sem, params["sem_proj_w"],
                       params["sem_proj_b"], params["fuse_w"],
                       params["fuse_b"], sem_ids=sem_ids)
