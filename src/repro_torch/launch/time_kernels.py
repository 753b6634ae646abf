"""Times one of this checkout's kernels against another version of it, in
one process on one card.

    PYTHONPATH=src python -m repro_torch.launch.time_kernels \\
        --kernel scoring|gather_fuse|intersect|intersect_backward|gather_fuse_backward \\
        --baseline DIR

DIR is the root of another checkout of the repository (for example a
``git archive`` of the parent commit, unpacked): its
``src/repro_torch/kernels/csrc`` is compiled into a library of its own, and
its entry point (the same C interface) is called on the same tensors. At each
shape the two kernels are timed in the order baseline, this, this, baseline,
with ``chip_smoke.py``'s protocol (``kernels.timing.time_ms``: CUDA events,
512 MB flush zeroed before each run, median of 25), and the plain version
once beside them. Both kernels are held to the plain version first.

- ``scoring`` (fp32, d = 400, each mode): the all-entity batch of 16, one
  query, a 4,096-row store chunk; this checkout's kernel is also timed with
  each of its tilings forced.
- ``gather_fuse`` (fp32 and bf16 tables, d = 400, dl = 1024, dp = 64, as
  the serving path calls it, with a null zp): all 14,951 entities from the
  resident table, a 4,096-row and the last 2,663-row store chunk, 48 anchors
  through a hot set; beside it, this checkout's kernel once more storing zp
  (``gather_fuse_and_zp``, as training's forward calls it), which must give
  the same output bits.
- ``intersect`` (fp32 and bf16 x, d = hd = 800, BetaE's attention MLP):
  every (n, k) BetaE serving gives it (n = 1 to 16, k = 2 or 3), n = 256
  and 512 pool rows of k = 2 or 3 inputs; beside ``stream_read(w1)``, a
  plain read of W1 under the same protocol (the floor for a call that reads
  W1 once). The baseline is called through the
  parent's C entry ``repro_intersect`` (two launches, ``partial`` sized
  [repro_intersect_tiles(hd), n·k]), as that checkout has it.
- ``intersect_backward`` (fp32): every shape of ``BACKWARD_SHAPES``, the
  list ``chip_smoke.py`` checks too (every pool BetaE training gives it,
  ragged and narrow ones). Both kernels are first held to the plain version
  on fp64 inputs within 1e-4·|exact| + ``intersect_backward_allowance``.
  Each row also splits one call of this checkout's kernel by launch
  (``torch.profiler``, L2 warm). The baseline is called through the
  five-launch C entry of the commits before the cluster design (14
  pointers with ``pre`` [n·k, hd], ``att`` and ``dlogit`` [n·k] as its
  scratch, 4 ints and the stream).
- ``gather_fuse_backward`` (fp32): every shape of ``FUSE_BACKWARD_SHAPES``
  (the loss's 33,280 rows in both layouts, 1,024 rows, 48 anchors, narrow
  widths; the list ``chip_smoke.py`` checks too) and the EMBED pools
  semantic GQE training gives it (``FUSE_BACKWARD_POOLS``). The baseline is
  called through the C entry of the commits before the forward saved zp
  (18 pointers — ids, sem_ids, sorted ids, order, h_str, h_sem, wp, bp, wf,
  bf, out, g, scratch, dh_str, dwp, dbp, dwf, dbf —, n, n_str, n_sem, d,
  dl, dp and the stream; scratch sized by that checkout's
  ``repro_gather_fuse_backward_scratch(n, d, dl, dp)``); this checkout's
  kernel is given the forward's zp, as training calls it, and is also timed
  once without it (zp recomputed). The composition, autograd through the
  plain version (cuBLAS in full fp32), is timed once beside them. Both
  kernels are first held to the plain version on fp64 inputs within
  1e-4·|exact| + ``gather_fuse_backward_allowance``, and each row splits
  one call of this checkout's kernel by launch (``torch.profiler``, L2
  warm).

Prints the card's name and power limit, one line per shape, and one JSON
line with every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import gather_fuse as gf
from repro_torch.kernels import intersect as its
from repro_torch.kernels.scoring import (DTYPES, MODES, TILES, scoring,
                                         scoring_ref, scoring_tile)
from repro_torch.kernels.timing import (flush_buffer, fuse_backward_inputs, intersect_inputs,
                                        stream_read, time_ms)
from repro_torch.models.base import glorot

SCORING_SHAPES = ((16, 14_951, 400), (1, 14_951, 400), (16, 4_096, 400))
E = 14_951
# (n, layout): all entities, a store chunk, the last chunk, EMBED anchors.
FUSE_SHAPES = ((E, "resident"), (4_096, "chunk"), (2_663, "chunk"), (48, "cache"))
FUSE_DIMS = (400, 1024, 64)  # d, dl (PTEConfig().d_l), dp
SEM_BUDGET = 2048
# (n, k) at d = hd = 800: every pool BetaE serving gives the kernel (its most
# common first), chip_smoke's large pools, and the training executor's cap
# (b_max = 512).
INTERSECT_SHAPES = ((8, 2), (4, 2), (1, 2), (2, 2), (4, 3), (1, 3), (2, 3), (16, 2), (8, 3),
                    (16, 3), (256, 2), (256, 3), (512, 3))
INTERSECT_DIMS = (800, 800)  # d = 2·dim (BetaE's state), hd = dim·hidden_mult
# (n, k, d, hd) at which chip_smoke.py and this CLI check and time the
# intersect backward: every pool BetaE training gives it at d = hd = 800
# (n = 32 to 512, k = 2 or 3), a ragged n, k = 1 and k = 12, and widths that
# end inside a tile (d = 33: no 16-byte loads).
BACKWARD_SHAPES = ((32, 2, 800, 800), (64, 2, 800, 800), (64, 3, 800, 800), (128, 2, 800, 800),
                   (128, 3, 800, 800), (256, 2, 800, 800), (256, 3, 800, 800),
                   (512, 2, 800, 800), (512, 3, 800, 800), (77, 3, 800, 800),
                   (16, 1, 800, 800), (16, 12, 800, 800), (70, 3, 96, 72), (5, 2, 33, 40))
# (n, layout, E, d, dl, dp) at which chip_smoke.py and this CLI check and time
# the gather_fuse backward: the loss's 33,280 rows (512 queries × 65
# candidates) with H_sem resident and through hot-set slots, 1,024 rows, 48
# anchors through a hot set, and narrow widths.
FUSE_BACKWARD_SHAPES = ((33_280, "resident", E, 400, 1024, 64),
                        (33_280, "cache", E, 400, 1024, 64),
                        (1_024, "resident", E, 400, 1024, 64),
                        (48, "cache", E, 400, 1024, 64),
                        (33, "resident", 100, 64, 128, 32))
# The EMBED pools of semantic GQE training at TrainConfig() (pooled 256 and
# 512, query-level 32 to 256; chip_smoke.py phase 5b).
FUSE_BACKWARD_POOLS = (512, 256, 128, 64, 32)


def declare_baseline(lib, kernel: str):
    """Declare the C signatures of the other library's entry for ``kernel``
    (only those: an older checkout lacks the newer entries) and of its
    error string."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    if kernel == "scoring":
        lib.repro_scoring.argtypes = [p, p, p, i, i, i, f, i, i, p]
        lib.repro_scoring.restype = i
    elif kernel == "gather_fuse":
        # Since the autotuner the entry takes the kernel's rows before the
        # stream (0: the kernel's own choice); ``repro_gather_fuse_rows``
        # came with it.
        rows = [i] if hasattr(lib, "repro_gather_fuse_rows") else []
        lib.repro_gather_fuse.argtypes = [p] * 10 + [i, ll, ll, i, i, i, i] + rows + [p]
        lib.repro_gather_fuse.restype = i
    elif kernel == "intersect":
        lib.repro_intersect.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.repro_intersect.restype = i
        lib.repro_intersect_tiles.argtypes = [i]
        lib.repro_intersect_tiles.restype = i
    elif kernel == "intersect_backward":  # the five-launch backward: x, g, w1,
        # b1, w2, b2, pre, att, dlogit, dx, dw1, db1, dw2, db2; n, k, d, hd; the stream
        lib.repro_intersect_backward.argtypes = [p] * 14 + [i] * 4 + [p]
        lib.repro_intersect_backward.restype = i
    else:  # the gather_fuse backward before the forward saved zp: 18 pointers,
        # n, n_str, n_sem, d, dl, dp, the stream
        lib.repro_gather_fuse_backward.argtypes = [p] * 18 + [i, ll, ll, i, i, i, p]
        lib.repro_gather_fuse_backward.restype = i
        lib.repro_gather_fuse_backward_scratch.argtypes = [i, i, i, i]
        lib.repro_gather_fuse_backward_scratch.restype = ll
    lib.repro_error_string.argtypes = [i]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def load_baseline(root: Path, kernel: str) -> ctypes.CDLL:
    """The other checkout's kernel library, built from its sources."""
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    return declare_baseline(ctypes.CDLL(str(build.build_library(csrc))), kernel)


def baseline_scoring(lib, q, e, gamma, mode):
    out = torch.empty((q.shape[0], e.shape[0]), dtype=torch.float32, device=q.device)
    err = lib.repro_scoring(q.data_ptr(), e.data_ptr(), out.data_ptr(), q.shape[0],
                            e.shape[0], q.shape[1], float(gamma), MODES[mode],
                            DTYPES[q.dtype], build.stream_handle(q))
    build.check(lib, err, "baseline scoring")
    return out


def baseline_gather_fuse(lib, ids, h_str, h_sem, wp, bp, wf, bf, sem_ids=None):
    """The other library's kernel through the unchanged C entry; its zp
    scratch is allocated, as versions that project in a launch of their own
    need it."""
    n, d = ids.shape[0], h_str.shape[1]
    sem = ids if sem_ids is None else sem_ids
    out = torch.empty((n, d), dtype=h_str.dtype, device=ids.device)
    zp = torch.empty((n, wp.shape[1]), dtype=torch.float32, device=ids.device)
    rows = [0] if hasattr(lib, "repro_gather_fuse_rows") else []
    err = lib.repro_gather_fuse(
        ids.data_ptr(), sem.data_ptr(), h_str.data_ptr(), h_sem.data_ptr(), wp.data_ptr(),
        bp.data_ptr(), wf.data_ptr(), bf.data_ptr(), zp.data_ptr(), out.data_ptr(), n,
        h_str.shape[0], h_sem.shape[0], d, h_sem.shape[1], wp.shape[1],
        gf.DTYPES[h_str.dtype], *rows, build.stream_handle(ids))
    build.check(lib, err, "baseline gather_fuse")
    return out


def baseline_intersect(lib, x, w1, b1, w2, b2):
    """The other library's kernel through the parent's C entry, with its
    scratch of one partial logit per (hidden tile, input row)."""
    n, k, d = x.shape
    hd = w1.shape[1]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    partial = torch.empty((lib.repro_intersect_tiles(hd), n * k), dtype=torch.float32,
                          device=x.device)
    err = lib.repro_intersect(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                              b2.data_ptr(), partial.data_ptr(), out.data_ptr(), n, k, d, hd,
                              its.DTYPES[x.dtype], build.stream_handle(x))
    build.check(lib, err, "baseline intersect")
    return out


def baseline_intersect_backward(lib, x, w1, b1, w2, b2, g):
    """The other library's backward through the five-launch C entry, with
    its scratch pre [n·k, hd], att and dlogit [n·k]."""
    n, k, d = x.shape
    hd = w1.shape[1]
    dx = torch.empty_like(x)
    dw1, db1, dw2, db2 = (torch.zeros_like(t) for t in (w1, b1, w2, b2))
    pre = torch.empty((n * k, hd), dtype=torch.float32, device=x.device)
    att, dlogit = (torch.empty(n * k, dtype=torch.float32, device=x.device) for _ in range(2))
    err = lib.repro_intersect_backward(
        x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        pre.data_ptr(), att.data_ptr(), dlogit.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), n, k, d, hd, build.stream_handle(x))
    build.check(lib, err, "baseline intersect_backward")
    return dx, dw1, db1, dw2, db2


def baseline_gather_fuse_backward(lib, ids, h_str, h_sem, wp, bp, wf, bf, g, sem_ids, out):
    """The other library's backward through its C entry (no zp argument),
    with the id sort and zeroed dh_str the wrapper gives it."""
    n, d, dl, dp = ids.shape[0], h_str.shape[1], h_sem.shape[1], wp.shape[1]
    ids64 = ids.long()
    sem64 = ids64 if sem_ids is None else sem_ids.long()
    sorted_ids, order = torch.sort(ids64, stable=True)
    grads = (torch.zeros_like(h_str), *(torch.empty_like(t) for t in (wp, bp, wf, bf)))
    scratch = torch.empty(lib.repro_gather_fuse_backward_scratch(n, d, dl, dp),
                          dtype=torch.float32, device=ids.device)
    err = lib.repro_gather_fuse_backward(
        ids64.data_ptr(), sem64.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
        h_str.data_ptr(), h_sem.data_ptr(), wp.data_ptr(), bp.data_ptr(), wf.data_ptr(),
        bf.data_ptr(), out.data_ptr(), g.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in grads), n, h_str.shape[0], h_sem.shape[0], d, dl, dp,
        build.stream_handle(ids))
    build.check(lib, err, "baseline gather_fuse_backward")
    return grads


def ab(fn_base, fn_this, flush, reps):
    """Times in the order baseline, this, this, baseline."""
    times = {"baseline": [], "this": []}
    for name, fn in (("baseline", fn_base), ("this", fn_this), ("this", fn_this),
                     ("baseline", fn_base)):
        times[name].append(time_ms(fn, flush, reps))
    return times


def time_scoring(base, flush, gen, dev, reps):
    rows = []
    for B, N, d in SCORING_SHAPES:
        q = torch.randn((B, d), generator=gen, device=dev)
        e = torch.randn((N, d), generator=gen, device=dev)
        for mode in ("dot", "l1"):
            want = scoring_ref(q, e, 12.0, mode)
            for name, got in (("baseline", baseline_scoring(base, q, e, 12.0, mode)),
                              ("this", scoring(q, e, 12.0, mode))):
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d,
                                           msg=lambda m: f"{name} {mode} {(B, N, d)}: {m}")
            times = ab(lambda: baseline_scoring(base, q, e, 12.0, mode),  # noqa: B023
                       lambda: scoring(q, e, 12.0, mode), flush, reps)  # noqa: B023
            by_tile = {str(t): time_ms(lambda: scoring(q, e, 12.0, mode, tile=t),  # noqa: B023
                                       flush, reps) for t in TILES}
            row = {"mode": mode, "B": B, "N": N, "d": d, "dtype": "float32",
                   "baseline_ms": times["baseline"], "ms": times["this"],
                   "tile": scoring_tile(e), "ms_by_tile": by_tile}
            rows.append(row)
            print(f"scoring[{mode}] {(B, N, d)}: baseline {times['baseline']} ms, "
                  f"this {times['this']} ms, by tile {by_tile} (the kernel takes "
                  f"{row['tile']})")
    return rows


def fuse_inputs(n, layout, dtype, gen, dev):
    """gather_fuse's arguments as the serving path gives them: ids into the
    resident table, a streamed chunk of H_sem with local sem_ids, or ids
    through the slots of a SEM_BUDGET-row hot set."""
    d, dl, dp = FUSE_DIMS
    h_str = (torch.randn((E, d), generator=gen, device=dev) / d ** 0.5).to(dtype)
    table = torch.nn.functional.normalize(torch.randn((E, dl), generator=gen, device=dev), dim=1)
    wp, wf = glorot((dl, dp), gen, dev), glorot((d + dp, d), gen, dev)
    bp = 0.1 * torch.randn((dp,), generator=gen, device=dev)
    bf = 0.1 * torch.randn((d,), generator=gen, device=dev)
    sem_ids = None
    if layout == "resident":
        ids, h_sem = torch.arange(E, device=dev), table
    elif layout == "chunk":
        ids = torch.arange(E - n, E, device=dev)
        h_sem, sem_ids = table[E - n:].clone(), torch.arange(n, device=dev)
    else:
        ids = torch.randperm(E, generator=gen, device=dev)[:n]
        sem_ids = torch.randperm(SEM_BUDGET, generator=gen, device=dev)[:n]
        h_sem = torch.zeros((SEM_BUDGET, dl), device=dev)
        h_sem[sem_ids] = table[ids]
    return (ids, h_str, h_sem.to(dtype), wp, bp, wf, bf), sem_ids


def time_gather_fuse(base, flush, gen, dev, reps):
    rows = []

    def serve(args, sem_ids):  # the serving call: no autograd, a null zp
        with torch.no_grad():
            return gf.gather_fuse(*args, sem_ids=sem_ids)

    for dtype in (torch.float32, torch.bfloat16):
        for n, layout in FUSE_SHAPES:
            args, sem_ids = fuse_inputs(n, layout, dtype, gen, dev)
            want = gf.gather_fuse_ref(*args, sem_ids=sem_ids).float()
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            got = {"baseline": baseline_gather_fuse(base, *args, sem_ids=sem_ids),
                   "this": serve(args, sem_ids)}
            for name, out in got.items():
                torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol,
                                           msg=lambda m: f"{name} {n} {dtype}: {m}")
            with_zp = lambda: gf.gather_fuse_and_zp(*args, sem_ids=sem_ids)  # noqa: E731,B023
            if not torch.equal(with_zp()[0], got["this"]):
                raise SystemExit(f"time_kernels: gather_fuse {n} {dtype}: the output differs "
                                 f"with a zp buffer")
            times = ab(lambda: baseline_gather_fuse(base, *args, sem_ids=sem_ids),  # noqa: B023
                       lambda: serve(args, sem_ids), flush, reps)  # noqa: B023
            plain = time_ms(lambda: gf.gather_fuse_ref(*args, sem_ids=sem_ids),  # noqa: B023
                            flush, reps)
            zp_ms = time_ms(with_zp, flush, reps)
            row = {"n": n, "layout": layout, "d": FUSE_DIMS[0], "dl": FUSE_DIMS[1],
                   "dp": FUSE_DIMS[2], "dtype": str(dtype).split(".")[-1],
                   "baseline_ms": times["baseline"], "ms": times["this"],
                   "ms_storing_zp": zp_ms, "plain_ms": plain,
                   "bitwise_equal_to_baseline": torch.equal(got["baseline"], got["this"])}
            rows.append(row)
            print(f"gather_fuse n={n} {layout} {row['dtype']}: baseline "
                  f"{times['baseline']} ms, this {times['this']} ms (storing zp "
                  f"{zp_ms:.4f}), plain {plain:.4f} ms, bits equal to the baseline's: "
                  f"{row['bitwise_equal_to_baseline']}")
    return rows


def time_intersect(base, flush, gen, dev, reps):
    rows = []
    d, hd = INTERSECT_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        for n, k in INTERSECT_SHAPES:
            args = intersect_inputs(n, k, d, hd, dtype, gen)
            want = its.intersect_ref(*args).float()
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            got = {"baseline": baseline_intersect(base, *args), "this": its.intersect(*args)}
            for name, out in got.items():
                torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol,
                                           msg=lambda m: f"{name} {(n, k)} {dtype}: {m}")
            times = ab(lambda: baseline_intersect(base, *args),  # noqa: B023
                       lambda: its.intersect(*args), flush, reps)  # noqa: B023
            plain = time_ms(lambda: its.intersect_ref(*args), flush, reps)  # noqa: B023
            read_w1 = time_ms(lambda: stream_read(args[1]), flush, reps)  # noqa: B023
            row = {"n": n, "k": k, "d": d, "hd": hd, "dtype": str(dtype).split(".")[-1],
                   "baseline_ms": times["baseline"], "ms": times["this"],
                   "plain_ms": plain, "read_w1_ms": read_w1,
                   "max_abs_err": float((got["this"].float() - want).abs().max())}
            rows.append(row)
            print(f"intersect {(n, k, d, hd)} {row['dtype']}: baseline {times['baseline']} "
                  f"ms, this {times['this']} ms, plain {plain:.4f} ms, stream_read(w1) "
                  f"{read_w1:.4f} ms")
    return rows


def kernel_split(fn, reps: int) -> dict[str, float]:
    """Device ms of each kernel one call of ``fn`` launches (by name), from
    a ``torch.profiler`` trace of ``reps`` calls back to back (L2 warm: no
    flush between them)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:  # "void (anonymous namespace)::gemm_kernel<true, ...>(...)" ->
            #         "gemm_kernel<true, ...>"; names that still agree add up
            key = e.key.split("namespace)::", 1)[-1]
            name = (key.split("(", 1)[0] if "(" in key[1:] else key)[:64].strip()
            split[name] = split.get(name, 0.0) + us / 1e3 / reps
    return split


def time_intersect_backward(base, flush, gen, dev, reps):
    rows = []
    for n, k, d, hd in BACKWARD_SHAPES:
        args = intersect_inputs(n, k, d, hd, torch.float32, gen)
        g = torch.randn((n, d), generator=gen, device=dev)
        exact = its.intersect_backward_ref(*(t.double() for t in (*args, g)))
        allowed = its.intersect_backward_allowance(*args, g)
        shares = {}
        for name, grads in (("baseline", baseline_intersect_backward(base, *args, g)),
                            ("this", its.intersect_backward(*args, g))):
            shares[name] = its.backward_shares(grads, exact, allowed)
            worst = max(shares[name], key=shares[name].get)
            if shares[name][worst] > 1:
                raise SystemExit(f"time_kernels: {name} intersect_backward {(n, k, d, hd)}: "
                                 f"{worst} uses {shares[name][worst]:.3g} of its tolerance")
        times = ab(lambda: baseline_intersect_backward(base, *args, g),  # noqa: B023
                   lambda: its.intersect_backward(*args, g), flush, reps)  # noqa: B023
        plain = time_ms(lambda: its.intersect_backward_ref(*args, g), flush, reps)  # noqa: B023
        split = kernel_split(lambda: its.intersect_backward(*args, g), reps)  # noqa: B023
        row = {"n": n, "k": k, "d": d, "hd": hd, "dtype": "float32",
               "baseline_ms": times["baseline"], "ms": times["this"], "plain_ms": plain,
               "share_of_allowance": shares, "kernels_ms_l2_warm": split}
        rows.append(row)
        print(f"intersect_backward {(n, k, d, hd)}: baseline {times['baseline']} ms, this "
              f"{times['this']} ms, plain {plain:.4f} ms, share of allowance "
              f"{max(shares['this'].values()):.3g} (baseline "
              f"{max(shares['baseline'].values()):.3g}); per kernel, L2 warm: "
              + ", ".join(f"{name} {v:.4f}" for name, v in split.items()))
    return rows


def time_gather_fuse_backward(base, flush, gen, dev, reps):
    del dev
    rows = []
    shapes = (list(FUSE_BACKWARD_SHAPES)
              + [(n, "resident", E, 400, 1024, 64) for n in FUSE_BACKWARD_POOLS])
    for n, layout, rows_e, d, dl, dp in shapes:
        args, g, sem_ids, out, zp = fuse_backward_inputs(n, layout, rows_e, d, dl, dp, gen)
        kernel = lambda: gf.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out, zp=zp)  # noqa: E731,B023
        no_zp = lambda: gf.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out)  # noqa: E731,B023
        parent = lambda: baseline_gather_fuse_backward(base, *args, g, sem_ids, out)  # noqa: E731,B023
        composition = lambda: gf.gather_fuse_backward_ref(*args, g, sem_ids=sem_ids)  # noqa: E731,B023
        exact = gf.gather_fuse_backward_ref(args[0], *(t.double() for t in args[1:]),
                                            g.double(), sem_ids=sem_ids)
        allowed = gf.gather_fuse_backward_allowance(*args, g, sem_ids=sem_ids)
        shares = {name: its.backward_shares(fn(), exact, allowed, names=gf.GRADIENTS)
                  for name, fn in (("baseline", parent), ("this", kernel), ("this_no_zp", no_zp))}
        del exact, allowed
        for name, used in shares.items():
            worst = max(used, key=used.get)
            if used[worst] > 1:
                raise SystemExit(f"time_kernels: {name} gather_fuse_backward "
                                 f"{(n, layout, d, dl, dp)}: {worst} uses {used[worst]:.3g} "
                                 f"of its tolerance")
        times = ab(parent, kernel, flush, reps)
        plain = time_ms(composition, flush, reps)
        this_no_zp = time_ms(no_zp, flush, reps)
        split = kernel_split(kernel, reps)
        row = {"n": n, "layout": layout, "E": rows_e, "d": d, "dl": dl, "dp": dp,
               "dtype": "float32", "baseline_ms": times["baseline"], "ms": times["this"],
               "ms_without_zp": this_no_zp, "composition_ms": plain,
               "share_of_allowance": shares, "kernels_ms_l2_warm": split}
        rows.append(row)
        print(f"gather_fuse_backward {(n, layout, d, dl, dp)}: baseline {times['baseline']} "
              f"ms, this {times['this']} ms (without zp {this_no_zp:.4f}), composition "
              f"{plain:.4f} ms, share of allowance "
              f"{max(shares['this'].values()):.3g} (without zp "
              f"{max(shares['this_no_zp'].values()):.3g}, baseline "
              f"{max(shares['baseline'].values()):.3g}); per kernel, L2 warm: "
              + ", ".join(f"{name} {v:.4f}" for name, v in split.items()))
    return rows


TIMERS = {"scoring": time_scoring, "gather_fuse": time_gather_fuse, "intersect": time_intersect,
          "intersect_backward": time_intersect_backward,
          "gather_fuse_backward": time_gather_fuse_backward}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(TIMERS), required=True)
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout whose kernel is timed against this one")
    ap.add_argument("--reps", type=int, default=25)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    base = load_baseline(args.baseline.resolve(), args.kernel)
    build.load_library()
    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = TIMERS[args.kernel](base, flush, gen, dev, args.reps)
    print(json.dumps({"card": card, args.kernel: rows}))


if __name__ == "__main__":
    main()
