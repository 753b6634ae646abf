#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

from the repository root, on a machine with one NVIDIA Hopper GPU and the
CUDA toolkit. It imports nothing of JAX or of the JAX package, and exits
non-zero (printing no result) on any failed check:

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: compiles the port's CUDA kernels from ``src/repro_torch/kernels/
   csrc`` and prints the build seconds.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and one ragged shape, in fp32 and bf16, with the
   tolerances of the JAX package's kernel tests; kernel, plain and library
   device times (CUDA events, median over 25 runs, L2 flushed before each
   run) beside each kernel's bound. ``scoring`` also runs a 4,096-row store
   chunk and a table off 16-byte boundaries (its element-load variant), and
   shows that a chunk's scores equal those columns of the all-entity launch
   under either tiling and from either variant, and a query alone its row in
   a batch of 16, bitwise. At its fp32 serving shapes it is also timed with
   each tiling forced, and beside the floors of the timing protocol: a
   launch that reads nothing, and a plain read of the same table
   (``csrc/stream_read.cu``), with the flush buffer zeroed as for every
   time, and again with it read instead, which leaves L2 clean.
   ``gather_fuse`` runs all entities, a 4,096-row and the last (2,663-row)
   store chunk, 48 anchors through a hot set and one row, with the bound of
   its route (3xTF32 on the tensor cores) and the fp32 CUDA-core bound
   beside it, and shows that rows fused from a staged hot set, in a 4,096-row
   chunk and in a 48-row launch are bitwise equal to the all-entity
   launch's. ``intersect`` runs serving's and training's pools (n = 8 to
   512, k = 2 or 3, d = hd = 800) and a ragged one, k = 1, 8 and 12 too,
   with the bound of 3xTF32 on the tensor cores and the fp32 CUDA-core bound
   beside it; it shows that a row's output is bitwise the same alone and
   first, in the middle or last of pools of 1, 8, 16, 256 and 512 rows, and
   that a bf16 output is the fp32 kernel's output on the same x rounded once;
   its main path entry is timed beside a plain read of W1 (``stream_read``).
   The ``intersect`` backward (``csrc/intersect_backward.cu``) runs
   every pool BetaE training gives it (n = 32 to 512, k = 2 and 3, d = hd =
   800), a ragged n, k = 1, k = 12 and narrow widths
   (``launch/time_kernels.py::BACKWARD_SHAPES``) against autograd through the
   plain version on fp64 inputs (each element within 1e-4·|exact| +
   ``intersect_backward_allowance``: sums of dL/dlogit cancel and relus
   within rounding of 0 flip, so no tolerance on a gradient's own size
   holds in fp32), repeats bitwise across two calls, and is timed beside its
   bound and the fp32 plain version's time. The ``gather_fuse`` backward
   (``csrc/gather_fuse_backward.cu``) runs the loss's 33,280 rows with H_sem
   resident and through hot-set slots, 1,024 rows, 48 anchors and narrow
   widths (``launch/time_kernels.py::FUSE_BACKWARD_SHAPES``), ids repeated
   as the loss repeats them, against autograd through the plain version on
   fp64 inputs (each element within 1e-4·|exact| +
   ``gather_fuse_backward_allowance``) from the forward's saved zp and with
   zp recomputed, repeats bitwise across two calls, and is timed both ways
   beside its 3xTF32 and CUDA-core bounds (and the 3xTF32 bound of a
   backward that recomputes zp) and the composition (autograd through the
   plain version, cuBLAS in full fp32).
4. Serve: all six families (BetaE, GQE, ComplEx, Q2B, Q2P, FuzzQE) at full
   width (dim 400) on a synthetic graph with FB15k's Table 4 shape, through
   ``ServingEngine.submit``: one warm-up window, then five timed closed-loop
   windows of fresh requests (QPS, p50 and p99 over all of them, and the
   spread between windows). Every result has top-k finite scores, every
   recorded micro-batch replays identically through ``serve_batch``, the
   first batch agrees with the plain path on the CPU, and the kernels'
   launch counts (zeroed just before the timed windows) show the path went
   through them (BetaE ``intersect``; GQE, ComplEx ``scoring``; the other
   three reach no kernel and launch none). Each family's score phase (one
   ``score_all`` of 16 queries against every entity) is timed.
4b. Semantic serving: builds H_sem for the graph with the stub PTE
   (PTEConfig(): d_l 1024) into a temporary fp32 store, then serves GQE at
   ModelConfig(semantic_dim=1024) from two layouts with phase 4's windows —
   resident (the whole table on the card) and out-of-core (a 2,048-row hot
   set staged per micro-batch, all-entity scoring streamed from the store in
   4,096-row chunks). Each layout replays identically through
   ``serve_batch`` (out-of-core with a fresh cache), the first resident batch
   agrees with the CPU plain path, the first out-of-core batch agrees with
   the resident layout within 1e-5, and the ``gather_fuse`` and ``scoring``
   launches equal what the recorded batches call for.
5. Train at ``ModelConfig()`` with ``TrainConfig()``'s defaults (batch 512,
   64 negatives, b_max 512, all 14 patterns, lr 1e-4) on phase 4's graph.
   BetaE and GQE: the first step's loss (rtol 1e-4) and gradients (the CPU
   parity tests' rtol, norm-wise against the CPU path's fp64 step) against
   the CPU path on the same parameters and batch, then two warm-up and 20
   timed fresh steps pooled and 20 query-level (steps/s,
   queries/s, losses, all finite), with the ``intersect`` forward and
   backward launches equal to what the prepared plans call for, and the
   backward's device ms a BetaE step, pooled and query-level (calls × phase
   3's time at each pool of the timed run, over its steps); then
   ``evaluate`` on 256 sampled queries (GQE's ``scoring`` launches equal its
   eval batches). Whether two runs of one seed give the same loss bits is
   reported (not a gate). ComplEx, Q2B, Q2P and FuzzQE: three pooled steps
   with finite losses.
5b. Semantic training: GQE at ModelConfig(semantic_dim=1024) with
   ``TrainConfig()`` on phase 4b's H_sem, three runs — resident pooled,
   resident query-level, and pooled through a hot set of the reference
   launcher's budget, staged every step. Each: the first step as in
   phase 5, norm-wise against the CPU path's fp64 step; two warm-up and
   20 timed steps (steps/s, losses, all finite); ``gather_fuse`` and
   ``gather_fuse_backward`` launches each equal to the plans' EMBED ops plus
   one loss call a plan; ``evaluate`` on 256 queries (resident through
   ``score_all``, the hot set through ``score_all_chunked``). The backward is
   also checked and timed at the commonest EMBED pool, and its device ms a
   step is printed for each run: every n the run called it at, timed alone,
   times its calls. BetaE+H_sem: three
   pooled steps, twice from one seed (whether the loss bits agree is
   reported).
5c. Pipelined training: ``TrainConfig(pipeline=True)`` for BetaE, GQE and
   GQE+H_sem behind the hot set (pooled, full width), each one
   ``train(22, batches=...)`` call on the batches of that model's sync run
   in phase 5 or 5b, timed from the retire of step 2 to that of step 22.
   Gates: the losses bitwise the sync run's (held to 1e-6 relative instead,
   with the reason printed, only where two sync runs of one seed differ
   bitwise), all finite; ``intersect``/``gather_fuse`` and their backwards
   launched as often as the plans call for; the hot set staged entirely in
   the background (``stages_background == stages``, no sync stage,
   ``prefetch_overlap_frac`` 1.0); one more dispatch under
   ``torch.cuda.set_sync_debug_mode("error")`` raises nothing, with the
   scheduler thread running beside it. Printed: steps/s and queries/s beside
   the sync run's, the bubble (``pipeline_wait``) and retire shares of the
   wall, both threads' median phases and CPU time a step. GQE is evaluated
   after it (``scoring`` launches equal its eval batches). Its launches are
   added to the training entries of the kernels line.
6. A ``{"kernels": [...]}`` line with each kernel's numbers at the shape the
   main path gave it most often, launches of phase 7 included; ``scoring`` has one entry for each path
   that launches it (GQE, ComplEx, GQE+H_sem resident and out of core, and
   GQE's ``evaluate``), ``gather_fuse`` one for each semantic serving
   layout and one for training, ``intersect`` one for serving and one for
   training, beside ``intersect_backward`` and ``gather_fuse_backward`` for
   training, each with its own launches.
7. The live serving tier (runs after 5c; the kernels line of 6 is printed
   after it), at ``ModelConfig()`` on phase 4's graph, which it writes to.
   (a) GQE behind ``ServingEngine(kg=, mat_cache=MaterializedSubqueryCache
   (2048), max_staleness_versions=4)`` and ``LiveNGDB(finetune_steps=4,
   n_negatives=8)``: a closed loop of 32 over 1,498 requests, a quarter
   pinned up to 6 versions behind, while a writer thread lands 8 bursts of
   64 fresh triples (burst 4 adds 16 entities). Gates: every request served
   or shed with ``StaleVersionError``; fresh queries pinned to the version
   after burst 4 replay bitwise through ``serve_batch`` on the params and
   entity count retained for it, and again from the cache's rows bitwise;
   the cache's rows within the encode tolerance of a fresh encode (largest
   difference printed); the params after ``flush()`` bitwise a sync
   ``incremental_finetune`` of burst 8 from the recorded inputs; ``scoring``
   launched. Printed: QPS, p50/p99 through the writes, version-lag counts,
   stale sheds, fine-tune ms a burst, the cache's hit rate on a
   duplicate-heavy replay. (b) BetaE, 2 bursts: the pinned replay, the row
   check, ``intersect`` launched. (c) GQE with resident H_sem (d_l 1024,
   random rows in a store of its own): one burst grows 16 entities with
   their rows (``append_rows``; rows read before it read bitwise the same),
   a second burst's background fine-tune is bitwise a sync rerun, and
   ``gather_fuse`` and its backward launch. (d) ``ReplicaPool(2)`` behind a
   ``Router`` (a high-priority and a low-priority tenant): a warm replay
   with no retrace; ``update_params`` between two halves of a high-priority
   stream while the low-priority tenant floods: requests admitted before the
   swap served on the old params, after it on the new, every batch bitwise
   ``serve_batch`` on its params, low-priority sheds typed ``ShedError``;
   each replica's and the aggregate QPS printed.
8. Telemetry (runs after 7, before the kernels line of 6), each CLI through
   its ``main(argv)`` in this process so the launch counters see it, on the
   Table 4 FB15k graph the CLIs generate (phase 4's, split), at
   ``ModelConfig()`` width with ``TrainConfig()``'s batch, negatives and lr.
   (a) ``launch.train --pipeline`` for BetaE (12 steps with ``--trace`` and
   ``--metrics``, then 16 more resumed from its ``--ckpt-dir``) and for
   GQE+H_sem through the hot set of phase 4b's store (8, then 4): each
   dispatch launches what its plan calls for, the second run resumes where
   the first stopped, the trace validates with both threads' lanes and the
   reference's span names, the metrics hold one pipelined step record a
   step (``bubble_frac`` in [0, 1]) and a snapshot whose hit/miss pairs
   ``cache_tables`` prints, and ``python -m repro_torch.obs.report`` prints
   all three sections. (b) Phase 5c's BetaE and hot-set runs again with
   tracing on: losses bitwise 5c's, one traced dispatch under
   ``set_sync_debug_mode("error")``; a disabled span under 2 µs a call.
   (c) ``launch.serve`` out of core (448 requests, a 256-row hot set) and
   with two replicas and two tenants, each traced: the traces validate,
   one request span a request that reached an engine, every ``route``,
   each replica's batcher lane, ``scoring`` and ``gather_fuse`` launched.
   (d) Printed: the enabled overhead (median of 6 paired on/off ratios of
   10-step pipelined BetaE passes through one warmed trainer, annotations
   off), and the device ms under each span name of a sync BetaE step and a
   GQE micro-batch under ``torch.profiler`` (the span names must be among
   its annotations).
9. The last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import collections
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet (dense): HBM bandwidth, fp32 on CUDA cores, bf16
# and TF32 on tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
FB15K = (14_951, 1_345, 483_142)  # Table 4: entities, relations, train triples
WARMUP_PER_PATTERN = 8     # warm-up window: requests of each of the 14 patterns
WINDOWS = 5                # timed closed-loop windows, fresh requests in each
WINDOW_PER_PATTERN = 32    # requests of each pattern in one timed window
TOP_K = 10
SEM_DIM = 1024             # PTEConfig().d_l: Qwen3-Embedding-0.6B's width
SEM_BUDGET = 2048          # out-of-core hot-set rows
CHUNK = 4096               # score_all_chunked's default chunk
FAMILIES = ("betae", "gqe", "complex", "q2b", "q2p", "fuzzqe")
TRAIN_WARMUP = 2           # warm-up steps before each timed training run
TRAIN_STEPS = 20           # timed steps, pooled and query-level
EVAL_QUERIES = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))

    from repro_torch.core import TEMPLATES, OpType, PooledExecutor, QueryLevelExecutor
    from repro_torch.data import batch_entity_ids, generate_synthetic_kg
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gather_fuse import GRADIENTS as FUSE_GRADIENTS
    from repro_torch.kernels.gather_fuse import UNSORTED_ROWS
    from repro_torch.kernels.intersect import GRADIENTS, backward_shares
    from repro_torch.kernels.scoring import TILES
    from repro_torch.kernels.timing import (flush_buffer, fuse_backward_inputs, intersect_inputs,
                                            stream_read, time_ms)
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.time_kernels import BACKWARD_SHAPES, FUSE_BACKWARD_SHAPES
    from repro_torch.models import ModelConfig, make_model, params_from_numpy
    from repro_torch.models.base import glorot
    from repro_torch.sampling import OnlineSampler
    from repro_torch.semantic import (PTEConfig, SemanticCache, StubPTE,
                                      precompute_semantic_table_to_store,
                                      training_budget_rows)
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     check_against_offline, latency_summary,
                                     run_closed_loop)
    from repro_torch.training import NGDBTrainer, TrainConfig, evaluate

    # ------------------------------------------------------------ 1. device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)   # name and power limit, as nvidia-smi gives them
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}")

    # ----------------------------------------------------------- 3. kernels
    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fp = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def bound(nbytes: float, flops: float, dtype: str):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def measure_scoring(mode: str, B: int, N: int, d: int, dtype: str,
                        misaligned: bool = False, detail: bool = False) -> dict:
        """``misaligned``: ``e`` is ``table[1:]`` of a contiguous [N + 1, d]
        table, so its storage starts d elements past the table's. ``detail``
        adds the time under each tiling, the protocol's floors (a launch that
        reads nothing; a plain read of ``e``), and the kernel and the read
        with L2 left clean by the flush."""
        q = torch.randn((B, d), generator=gen, device=dev).to(fp[dtype])
        e = torch.randn((N + misaligned, d), generator=gen, device=dev).to(fp[dtype])
        e = e[1:] if misaligned else e
        if kops.scoring_aligned(e) == misaligned:
            fail(f"scoring {(B, N, d)} {dtype}: a table {'off' if misaligned else 'on'} "
                 f"16-byte boundaries took the other variant")
        got = kops.scoring(q, e, gamma=12.0, mode=mode)
        want = kops.scoring_ref(q, e, gamma=12.0, mode=mode)
        torch.cuda.synchronize()
        # Both sides take the same (bf16-rounded) inputs and sum in fp32, so
        # bf16 is held to the fp32 tolerance too.
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d)
        if mode == "dot":
            library = lambda: 12.0 + q @ e.T  # noqa: E731
        elif dtype == "float32":
            library = lambda: 12.0 - torch.cdist(q, e, p=1)  # noqa: E731
        else:
            library = None  # torch.cdist takes no bf16 on CUDA
        elt = q.element_size()
        flops = (2 if mode == "dot" else 3) * B * N * d
        # l1 has no tensor-core form: its sub-abs-add runs on CUDA cores.
        b_ms, b_by = bound((B * d + N * d) * elt + B * N * 4, flops,
                           dtype if mode == "dot" else "float32")
        kernel = lambda: kops.scoring(q, e, 12.0, mode)  # noqa: E731
        r = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": time_ms(kernel, flush),
            "plain_ms": time_ms(lambda: kops.scoring_ref(q, e, 12.0, mode), flush),
            "library_ms": library and time_ms(library, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "N": N, "d": d, **({"e": "table[1:]"} if misaligned else {})},
            "dtype": dtype, "tile": kops.scoring_tile(e),
        }
        if detail:
            r["ms_by_tile"] = {str(t): time_ms(  # noqa: B023
                lambda: kops.scoring(q, e, 12.0, mode, tile=t), flush) for t in TILES}
            r["launch_floor_ms"] = time_ms(lambda: stream_read(e[:0]), flush)
            r["read_floor_ms"] = time_ms(lambda: stream_read(e), flush)
            r["ms_clean_l2"] = time_ms(kernel, flush, clean=True)
            r["read_floor_ms_clean_l2"] = time_ms(lambda: stream_read(e), flush, clean=True)
        return r

    def check_scoring_bitwise(mode: str, dtype: str) -> None:
        """A score's bits depend only on its query row, its entity row, d and
        the dtype: a 4,096-row chunk (as the out-of-core path scores) equals
        those columns of the all-entity launch under either tiling and
        from a table off 16-byte boundaries (the element-load variant), and a
        query scored alone equals its row in a batch of 16."""
        q = torch.randn((16, 400), generator=gen, device=dev).to(fp[dtype])
        e = torch.randn((E, 400), generator=gen, device=dev).to(fp[dtype])
        full = kops.scoring(q, e, gamma=12.0, mode=mode)
        cols = full[:, CHUNK:2 * CHUNK]
        flat = torch.empty(CHUNK * 400 + 1, dtype=e.dtype, device=dev)
        off = flat[1:].view(CHUNK, 400)  # one element past a 16-byte boundary
        off.copy_(e[CHUNK:2 * CHUNK])
        if kops.scoring_aligned(off):
            fail(f"scoring {dtype}: a table off 16-byte boundaries took the 16-byte copies")
        chunks = {f"tile {t}": kops.scoring(q, e[CHUNK:2 * CHUNK], 12.0, mode, tile=t)
                  for t in TILES}
        chunks["element-load variant"] = kops.scoring(q, off, gamma=12.0, mode=mode)
        alone = kops.scoring(q[5:6].contiguous(), e, gamma=12.0, mode=mode)
        torch.cuda.synchronize()
        for how, chunk in chunks.items():
            if not torch.equal(chunk, cols):
                fail(f"scoring[{mode}] {dtype}: a {CHUNK}-row chunk ({how}) differs "
                     f"from the all-entity launch's columns")
        for t in TILES:
            if not torch.equal(kops.scoring(q, e, 12.0, mode, tile=t), full):
                fail(f"scoring[{mode}] {dtype}: the all-entity launch under tile {t} "
                     f"differs from the kernel's own choice")
        if not torch.equal(alone, full[5:6]):
            fail(f"scoring[{mode}] {dtype}: a query scored alone differs from its "
                 f"row in a batch of 16")

    def check_intersect(args, dtype: str) -> float:
        got = kops.intersect(*args)
        want = kops.intersect_ref(*args)
        torch.cuda.synchronize()
        # fp32: tests/test_kernels.py:32. bf16: a few bf16 steps of an output
        # near 1 (both sides take the same bf16 x and compute in fp32).
        tol = 1e-5 if dtype == "float32" else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if dtype == "bfloat16":
            # bf16 x loads exactly into fp32 and takes the fp32 arithmetic, so
            # the output is the fp32 kernel's on the same x, rounded once.
            once = kops.intersect(args[0].float(), *args[1:]).to(torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(got, once):
                fail(f"intersect bf16 {tuple(args[0].shape)}: the output differs from the "
                     f"fp32 kernel's rounded once by "
                     f"{(got.float() - once.float()).abs().max():.3g}")
        return float((got.float() - want.float()).abs().max())

    def measure_intersect(n: int, k: int, d: int, hd: int, dtype: str,
                          detail: bool = False) -> dict:
        """``detail`` adds the floor of a call that reads W1 once (a plain
        read of it)."""
        args = intersect_inputs(n, k, d, hd, fp[dtype], gen)
        err = check_intersect(args, dtype)
        elt = args[0].element_size()
        nbytes = (n * k * d + n * d) * elt + (d * hd + 2 * hd + 1) * 4
        # x·W1, the head (b1, relu, w2) and the softmax-weighted sum.
        flops = n * k * (2 * d * hd + 4 * hd + 2 * d)
        # The card's fastest route for x·W1 at fp32 accuracy: 3xTF32 on the
        # tensor cores, three TF32 products a multiply-add (two for bf16 x,
        # exact in TF32, whose lo part is 0); the rest at the same rate.
        products = 3 if dtype == "float32" else 2
        tf32_flops = n * k * (products * 2 * d * hd + 4 * hd + 2 * d)
        b_ms, b_by = bound(nbytes, tf32_flops, "tf32")
        # The same work as fp32 FMAs on the CUDA cores (the kernel's route).
        b32_ms, b32_by = bound(nbytes, flops, "float32")
        r = {
            "max_abs_err": err,
            "ms": time_ms(lambda: kops.intersect(*args), flush),
            "plain_ms": time_ms(lambda: kops.intersect_ref(*args), flush),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_cuda_cores_ms": b32_ms, "bound_fp32_cuda_cores_by": b32_by,
            "shape": {"n": n, "k": k, "d": d, "hd": hd}, "dtype": dtype,
        }
        if detail:
            r["read_floor_ms"] = time_ms(lambda: stream_read(args[1]), flush)
        return r

    def check_intersect_bitwise(dtype: str) -> None:
        """A row's bits depend only on its own k inputs and the MLP: alone,
        it equals itself first, in the middle and last of pools of 1, 8, 16,
        256 and 512 rows; k = 1, 8 and 12 hold to the plain version."""
        for k in (2, 3):
            pool, w1, b1, w2, b2 = intersect_inputs(512, k, 800, 800, fp[dtype], gen)
            row = pool[:1].clone()
            alone = kops.intersect(row, w1, b1, w2, b2)
            for n in (1, 8, 16, 256, 512):
                for place in sorted({0, n // 2, n - 1}):
                    x = pool[:n].clone()
                    x[place] = row[0]
                    got = kops.intersect(x, w1, b1, w2, b2)
                    torch.cuda.synchronize()
                    if not torch.equal(got[place:place + 1], alone):
                        fail(f"intersect {dtype} k={k}: a row placed {place} of {n} "
                             f"differs from the row alone by "
                             f"{(got[place].float() - alone[0].float()).abs().max():.3g}")
        for k in (1, 8, 12):
            check_intersect(intersect_inputs(16, k, 800, 800, fp[dtype], gen), dtype)

    def measure_intersect_backward(n: int, k: int, d: int, hd: int) -> dict:
        """The backward kernel against the plain version (autograd through
        ``intersect_ref``) on fp64 inputs: each element within 1e-4·|exact|
        + its allowance (``intersect_backward_allowance``: 1e-5 of the
        magnitudes of the terms it adds up, and what a relu within rounding
        of 0 may add; sums of dL/dlogit cancel, so an fp32 backward's error
        is no small share of the result's own size). Two calls give the same
        bits. ``max_abs_err`` is against the fp32 plain version;
        ``share_of_allowance`` the largest |error| / (1e-4·|exact| +
        allowance) of the kernel and of the fp32 plain version."""
        args = intersect_inputs(n, k, d, hd, torch.float32, gen)
        g = torch.randn((n, d), generator=gen, device=dev)
        got = kops.intersect_backward(*args, g)
        again = kops.intersect_backward(*args, g)
        plain = kops.intersect_backward_ref(*args, g)
        exact = kops.intersect_backward_ref(*(t.double() for t in (*args, g)))
        allowed = kops.intersect_backward_allowance(*args, g)
        torch.cuda.synchronize()
        used = [backward_shares(t, exact, allowed) for t in (got, plain)]
        err, shares = 0.0, {}
        for name, a, p, c in zip(GRADIENTS, got, plain, again):
            share = [used[0][name], used[1][name]]
            if share[0] > 1:
                fail(f"intersect_backward {(n, k, d, hd)}: {name} uses {share[0]:.3g} of "
                     f"its tolerance (the fp32 plain version {share[1]:.3g})")
            if not torch.equal(a, c):
                fail(f"intersect_backward {(n, k, d, hd)}: {name} differs between two "
                     f"calls on the same inputs")
            err = max(err, float((a - p).abs().max()))
            shares[name] = [f"{v:.3g}" for v in share]
        # x, g, dx, W1 and dW1, each once.
        nbytes = (2 * n * k * d + n * d + 2 * d * hd) * 4
        # The recomputed x·W1, dh·W1ᵀ and xᵀ·dh.
        flops = 3 * 2 * n * k * d * hd
        # The card's fastest route at fp32 accuracy, and the kernel's: 3xTF32
        # on the tensor cores (three products a multiply-add); beside it the
        # same work as fp32 FMAs on the CUDA cores.
        b_ms, b_by = bound(nbytes, 3 * flops, "tf32")
        b32_ms, b32_by = bound(nbytes, flops, "float32")
        return {
            "max_abs_err": err,
            "ms": time_ms(lambda: kops.intersect_backward(*args, g), flush),
            "plain_ms": time_ms(lambda: kops.intersect_backward_ref(*args, g), flush),
            "library_ms": None,  # no single PyTorch call computes this function
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_cuda_cores_ms": b32_ms, "bound_fp32_cuda_cores_by": b32_by,
            "shape": {"n": n, "k": k, "d": d, "hd": hd}, "dtype": "float32",
            "share_of_allowance": shares,  # per gradient: [kernel, fp32 plain]
        }

    def measure_gather_fuse(n: int, d: int, dl: int, dp: int, dtype: str,
                            layout: str, E: int) -> dict:
        """Fusion of n rows out of an E-row graph, as the serving path calls
        it: ``resident`` (ids into the full table), ``chunk`` (a streamed
        n-row slice of H_sem with local sem_ids) or ``cache`` (ids through
        the slots of a SEM_BUDGET-row hot set)."""
        h_str = (torch.randn((E, d), generator=gen, device=dev) / d ** 0.5).to(fp[dtype])
        table = torch.nn.functional.normalize(
            torch.randn((E, dl), generator=gen, device=dev), dim=1)
        wp, wf = glorot((dl, dp), gen, dev), glorot((d + dp, d), gen, dev)
        bp = 0.1 * torch.randn((dp,), generator=gen, device=dev)
        bf = 0.1 * torch.randn((d,), generator=gen, device=dev)
        sem_ids = None
        if layout == "resident":
            ids = (torch.arange(E, device=dev) if n == E else
                   torch.randint(0, E, (n,), generator=gen, device=dev))
            h_sem = table
        elif layout == "chunk":
            lo = E - n
            ids = torch.arange(lo, E, device=dev)
            h_sem = table[lo:].clone()
            sem_ids = torch.arange(n, device=dev)
        else:
            ids = torch.randperm(E, generator=gen, device=dev)[:n]
            sem_ids = torch.randperm(SEM_BUDGET, generator=gen, device=dev)[:n]
            h_sem = torch.zeros((SEM_BUDGET, dl), device=dev)
            h_sem[sem_ids] = table[ids]
        h_sem = h_sem.to(fp[dtype])
        args = (ids, h_str, h_sem, wp, bp, wf, bf)
        got = kops.gather_fuse(*args, sem_ids=sem_ids)
        want = kops.gather_fuse_ref(*args, sem_ids=sem_ids)
        torch.cuda.synchronize()
        # fp32: tests/test_kernels.py:51. bf16 tables: one bf16 step of an
        # output in [-1, 1] (both sides sum the same inputs in fp32).
        tol = 1e-5 if dtype == "float32" else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if layout == "resident" and n == E:
            # The same rows through a staged hot set, in a 4,096-row store
            # chunk and in a 48-row launch are bitwise equal to the
            # all-entity launch's.
            some = torch.randperm(E, generator=gen, device=dev)[:48]
            lo = E // 2
            chunk = kops.gather_fuse(torch.arange(lo, lo + CHUNK, device=dev), h_str,
                                     h_sem[lo:lo + CHUNK].clone(), wp, bp, wf, bf,
                                     sem_ids=torch.arange(CHUNK, device=dev))
            few = kops.gather_fuse(some, h_str, h_sem, wp, bp, wf, bf)
            torch.cuda.synchronize()
            for how, rows, want_rows in (("a 4,096-row chunk", chunk, got[lo:lo + CHUNK]),
                                         ("a 48-row launch", few, got[some])):
                if not torch.equal(rows, want_rows):
                    fail(f"gather_fuse {dtype}: rows fused in {how} differ from the "
                         f"all-entity launch's by "
                         f"{(rows.float() - want_rows.float()).abs().max():.3g}")
            cache = SemanticCache(table.to(fp[dtype]).float().cpu().numpy(),
                                  budget_rows=SEM_BUDGET, device=dev)
            staged = {"sem_cache": cache.buffer, "sem_slot": cache.slot_map}
            cache.apply_to(staged, cache.plan(some.cpu().numpy()))
            via_cache = kops.gather_fuse(some, h_str, cache.buffer.to(fp[dtype]),
                                         wp, bp, wf, bf, sem_ids=cache.slot_map[some])
            torch.cuda.synchronize()
            if not torch.equal(via_cache, got[some]):
                fail(f"gather_fuse {dtype}: rows fused from a staged hot set "
                     f"differ from the resident table's by "
                     f"{(via_cache.float() - got[some].float()).abs().max():.3g}")
        eh, ez = fp[dtype].itemsize, h_sem.element_size()
        nbytes = (2 * n * d * eh + n * dl * ez + n * 8 * (1 if sem_ids is None else 2)
                  + (dl * dp + dp + (d + dp) * d + d) * 4)
        # Both products and the bias adds; the sigmoid epilogue's ~4 ops.
        flops = n * (2 * dl * dp + dp + 2 * (d + dp) * d + d + 4 * d)
        # The kernel's route: 3xTF32 on the tensor cores, three TF32
        # products a multiply-add (two where a bf16 table row is one
        # operand: its lo part is 0); zp·Wf_z always takes three.
        table_products = 3 if dtype == "float32" else 2
        tf32_flops = 2 * n * (table_products * (dl * dp + d * d) + 3 * dp * d)
        b_ms, b_by = bound(nbytes, tf32_flops, "tf32")
        # The same work as fp32 FMAs on the CUDA cores (the parent's route).
        b32_ms, b32_by = bound(nbytes, flops, "float32")
        return {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": time_ms(lambda: kops.gather_fuse(*args, sem_ids=sem_ids), flush),
            "plain_ms": time_ms(lambda: kops.gather_fuse_ref(*args, sem_ids=sem_ids), flush),
            "library_ms": None,  # no single PyTorch call computes Eq. 11 + 12
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_cuda_cores_ms": b32_ms, "bound_fp32_cuda_cores_by": b32_by,
            "shape": {"n": n, "E": E, "d": d, "dl": dl, "dp": dp, "layout": layout},
            "dtype": dtype,
        }

    def measure_gather_fuse_backward(n: int, layout: str, E: int, d: int = 400,
                                     dl: int = SEM_DIM, dp: int = 64,
                                     timing_only: bool = False) -> dict:
        """The backward kernel (from the forward's saved output and zp, as
        training calls it) against the plain version (autograd through
        ``gather_fuse_ref``) on fp64 inputs: each element within
        1e-4·|exact| + ``gather_fuse_backward_allowance`` (1e-5 of the
        magnitudes of the terms it adds up, carried through; the sigmoid's
        1 − o² cancels near ±1), with zp given and with zp recomputed. Two
        calls give the same bits. ``max_abs_err`` is against the fp32 plain
        version, which is also the composition's time (cuBLAS in full fp32);
        ``share_of_allowance`` the largest |error| / (1e-4·|exact| +
        allowance) of the kernel, of the kernel without zp, and of the fp32
        plain version. ``timing_only``: the kernel's time alone."""
        args, g, sem_ids, out, zp = fuse_backward_inputs(n, layout, E, d, dl, dp, gen)
        kernel = lambda: kops.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out, zp=zp)  # noqa: E731
        if timing_only:
            return {"ms": time_ms(kernel, flush, reps=10)}
        got = kernel()
        again = kernel()
        no_zp = kops.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out)
        plain = kops.gather_fuse_backward_ref(*args, g, sem_ids=sem_ids)
        exact = kops.gather_fuse_backward_ref(args[0], *(t.double() for t in args[1:]),
                                              g.double(), sem_ids=sem_ids)
        allowed = kops.gather_fuse_backward_allowance(*args, g, sem_ids=sem_ids)
        torch.cuda.synchronize()
        used = [backward_shares(t, exact, allowed, names=FUSE_GRADIENTS)
                for t in (got, no_zp, plain)]
        err, shares = 0.0, {}
        for name, a, p, c in zip(FUSE_GRADIENTS, got, plain, again):
            share = [u[name] for u in used]
            if max(share[:2]) > 1:
                fail(f"gather_fuse_backward {(n, layout)}: {name} uses {share[0]:.3g} of "
                     f"its tolerance ({share[1]:.3g} without zp; the fp32 plain version "
                     f"{share[2]:.3g})")
            if not torch.equal(a, c):
                fail(f"gather_fuse_backward {(n, layout)}: {name} differs between two "
                     f"calls on the same inputs")
            err = max(err, float((a - p).abs().max()))
            shares[name] = [f"{v:.3g}" for v in share]
        del plain, exact, allowed, again, no_zp
        # Each input read once (ids, sem_ids and, above UNSORTED_ROWS, the
        # sorted ids and their order; h, z, o, g and zp rows; the weights),
        # each gradient written once (dh_str whole).
        weights = 2 * (dl * dp + dp + (d + dp) * d + d) * 4
        index_bytes = n * 8 * (4 if n > UNSORTED_ROWS else 2)
        nbytes = index_bytes + n * (3 * d + dl + dp) * 4 + E * d * 4 + weights
        # t·Wfᵀ, [h ⊕ zp]ᵀ·t, zᵀ·dzp; t and the two bias sums (zp is given).
        flops = n * (2 * dl * dp + 4 * d * (d + dp) + 3 * d + d + dp)
        # The count for a backward that recomputes zp (the kernel before the
        # forward stored it): 2·dl·dp flops a row more, no zp read, the
        # sorted ids always.
        nbytes_rz = n * 8 * 4 + n * (3 * d + dl) * 4 + E * d * 4 + weights
        flops_rz = flops + n * 2 * dl * dp
        # The card's fastest route at fp32 accuracy, 3xTF32 on the tensor
        # cores (three TF32 products a multiply-add), the kernel's route;
        # beside it fp32 FMAs on the CUDA cores.
        b_ms, b_by = bound(nbytes, 3 * flops, "tf32")
        b32_ms, b32_by = bound(nbytes, flops, "float32")
        brz_ms, brz_by = bound(nbytes_rz, 3 * flops_rz, "tf32")
        return {
            "max_abs_err": err,
            "ms": time_ms(kernel, flush),
            "ms_without_zp": time_ms(
                lambda: kops.gather_fuse_backward(*args, g, sem_ids=sem_ids, out=out), flush),
            "plain_ms": time_ms(lambda: kops.gather_fuse_backward_ref(*args, g, sem_ids=sem_ids),
                                flush),
            "library_ms": None,  # no single PyTorch call computes this function
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_cuda_cores_ms": b32_ms, "bound_fp32_cuda_cores_by": b32_by,
            "bound_recomputing_zp_ms": brz_ms, "bound_recomputing_zp_by": brz_by,
            "shape": {"n": n, "E": E, "d": d, "dl": dl, "dp": dp, "layout": layout},
            "dtype": "float32",
            # per gradient: [kernel, kernel without zp, fp32 plain]
            "share_of_allowance": shares,
        }

    def show(name: str, r: dict) -> None:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        more = ""
        if "bound_fp32_cuda_cores_ms" in r:
            more = (f" | fp32 CUDA-core bound {r['bound_fp32_cuda_cores_ms']:.4f} "
                    f"({r['bound_fp32_cuda_cores_by']})")
        if "bound_recomputing_zp_ms" in r:
            more += (f" | without zp {r['ms_without_zp']:.4f} ms | bound of a backward "
                     f"that recomputes zp {r['bound_recomputing_zp_ms']:.4f} "
                     f"({r['bound_recomputing_zp_by']})")
        if "share_of_allowance" in r:
            who = ("kernel, without zp, plain" if "bound_recomputing_zp_ms" in r
                   else "kernel, plain")
            more += (f" | share of tolerance vs fp64 ({who}): "
                     f"{r['share_of_allowance']}")
        if "read_floor_ms" in r and "ms_by_tile" not in r:
            more += f" | read floor (W1) {r['read_floor_ms']:.4f}"
        if "ms_by_tile" in r:
            tiles = ", ".join(f"{t}: {v:.4f}" for t, v in r["ms_by_tile"].items())
            more = (f" | tile {r['tile']} (by tile {tiles}), launch floor "
                    f"{r['launch_floor_ms']:.4f}, read floor {r['read_floor_ms']:.4f}; "
                    f"L2 left clean: kernel_ms {r['ms_clean_l2']:.4f}, read floor "
                    f"{r['read_floor_ms_clean_l2']:.4f}")
        print(f"  {name} {r['shape']} {r['dtype']}: max_abs_err "
              f"{r['max_abs_err']:.3g}, kernel_ms {r['ms']:.4f}, plain_ms "
              f"{r['plain_ms']:.4f}, library_ms {lib}, bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){more}")

    E, R, T = FB15K
    backward_ms = {}  # (n, k) at d = hd = 800 -> the backward's time
    print("kernels against their plain versions:")
    for dtype in ("float32", "bfloat16"):
        for mode in ("l1", "dot"):
            for B, N, d, mis in ((1, E, 400, False), (16, E, 400, False),
                                 (16, CHUNK, 400, False), (5, 333, 96, False),
                                 (16, 333, 33, True)):
                detail = dtype == "float32" and d == 400
                show(f"scoring[{mode}]", measure_scoring(mode, B, N, d, dtype, mis, detail))
            check_scoring_bitwise(mode, dtype)
        print(f"  scoring {dtype}: {CHUNK}-row chunks (either tiling, either "
              f"variant) and single queries bitwise equal to the all-entity "
              f"batch of 16")
        for n, k, d, hd in ((8, 2, 800, 800), (16, 2, 800, 800), (16, 3, 800, 800),
                            (256, 2, 800, 800), (256, 3, 800, 800),
                            (512, 3, 800, 800), (100, 3, 64, 128)):
            show("intersect", measure_intersect(n, k, d, hd, dtype))
        check_intersect_bitwise(dtype)
        print(f"  intersect {dtype}: rows bitwise alike alone and in pools of 1 to "
              f"512 at every place; k = 1, 8, 12 match plain")
        if dtype == "float32":  # training is fp32; the backward takes nothing else
            for n, k, d, hd in BACKWARD_SHAPES:
                r = measure_intersect_backward(n, k, d, hd)
                if (d, hd) == (800, 800):
                    backward_ms[n, k] = r["ms"]
                show("intersect_backward", r)
            print("  intersect_backward: every shape matches plain and repeats bitwise")
            for n, layout, rows, d, dl, dp in FUSE_BACKWARD_SHAPES:
                show("gather_fuse_backward", measure_gather_fuse_backward(n, layout, rows, d, dl, dp))
            print("  gather_fuse_backward: every shape matches plain and repeats bitwise")
        for n, d, dl, dp, layout, rows in ((E, 400, SEM_DIM, 64, "resident", E),
                                           (CHUNK, 400, SEM_DIM, 64, "chunk", E),
                                           (E % CHUNK, 400, SEM_DIM, 64, "chunk", E),
                                           (48, 400, SEM_DIM, 64, "cache", E),
                                           (1, 400, SEM_DIM, 64, "resident", E),
                                           (33, 64, 128, 32, "resident", 100)):
            show("gather_fuse", measure_gather_fuse(n, d, dl, dp, dtype, layout, rows))

    # ------------------------------------------------------------- 4. serve
    t0 = time.perf_counter()
    kg = generate_synthetic_kg(E, R, T, seed=0, name="FB15k-shaped")
    sampler = OnlineSampler(kg, seed=0)
    order = np.random.default_rng(0)

    def mixed(per_pattern: int) -> list:
        qs = [sampler.sample(p).query for p in TEMPLATES for _ in range(per_pattern)]
        return [qs[i] for i in order.permutation(len(qs))]

    warmup = mixed(WARMUP_PER_PATTERN)
    windows = [mixed(WINDOW_PER_PATTERN) for _ in range(WINDOWS)]
    n_timed = sum(map(len, windows))
    print(f"graph: {kg.n_entities} entities, {kg.n_relations} relations, "
          f"{len(kg)} triples; {len(warmup)} warm-up and {WINDOWS} x "
          f"{len(windows[0])} timed requests over {len(TEMPLATES)} patterns "
          f"({time.perf_counter() - t0:.1f} s)")

    cfg = ModelConfig()
    main_path = {}   # kernel name -> (launches, Counter of shapes)
    for family in FAMILIES:
        model = make_model(family, cfg, device=dev)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(1), E, R)
        executor = PooledExecutor(model, b_max=256, device=dev)
        engine = ServingEngine(
            model, params, executor=executor, device=dev,
            cfg=ServingConfig(max_batch=16, top_k=TOP_K, record_batches=True))
        with engine:
            run_closed_loop(engine, warmup, concurrency=32)
            engine.reset_counters()
            kops.scoring.launches = 0
            kops.intersect.launches = 0
            reports = [run_closed_loop(engine, w, concurrency=32) for w in windows]
            torch.cuda.synchronize()
            launches = {"scoring": kops.scoring.launches,
                        "intersect": kops.intersect.launches}
        st = engine.stats()
        results = [res for rep in reports for res in rep.results]
        for res in results:
            s = np.asarray(res["scores"])
            if len(res["top_entities"]) != TOP_K or not np.isfinite(s).all():
                fail(f"{family}: a result lacks {TOP_K} finite scores: {res}")
        if st["failures"]:
            fail(f"{family}: {st['failures']} requests failed")
        checked = check_against_offline(
            engine.batch_log,
            lambda qs: serve_batch(model, params, executor, qs, top_k=TOP_K,
                                   device=dev)[0])
        if checked == 0 or checked != sum(r.n_real for r in engine.batch_log):
            fail(f"{family}: {checked} rows replayed of the recorded batches")

        # The first recorded batch against the plain path on the CPU.
        rec = engine.batch_log[0]
        cpu_model = make_model(family, cfg, device="cpu")
        cpu_params = params_from_numpy(
            cpu_model, {k: v.cpu().numpy() for k, v in params.items()})
        cpu_ex = PooledExecutor(cpu_model, b_max=256, device="cpu")
        with torch.no_grad():
            cpu_scores = cpu_model.score_all(
                cpu_params, cpu_ex.encode(cpu_params, rec.queries)).numpy()
        worst = 0.0
        for i, res in enumerate(rec.results[: rec.n_real]):
            ref = cpu_scores[i, res["top_entities"]]
            err = np.abs(ref - np.asarray(res["scores"]))
            # GPU vs CPU end to end: kernel and library sums in other orders,
            # lgamma/digamma implementations, and results rounded to 3 places.
            if (err > 2e-3 + 1e-4 * np.abs(ref) + 5e-4).any():
                fail(f"{family}: served scores differ from the CPU plain path "
                     f"by {err.max():.3g}")
            worst = max(worst, float(err.max()))

        # The score phase: one score_all of a micro-batch of 16 states.
        with torch.no_grad():
            states = executor.encode(params, engine.batch_log[-1].queries)
            score_ms = time_ms(lambda: model.score_all(params, states), flush)  # noqa: B023
        need = {"betae": "intersect", "gqe": "scoring", "complex": "scoring"}.get(family)
        shapes = collections.Counter()
        for rec in engine.batch_log:
            if family == "betae":
                for op, card, pn in executor.prepare(rec.queries).meta:
                    if op in (int(OpType.INTERSECT), int(OpType.UNION)):
                        shapes[(pn, card)] += 1
            elif need:
                shapes[(len(rec.queries), E)] += 1
        l = latency_summary([res["latency_ms"] for res in results])
        wall = sum(rep.wall_s for rep in reports)
        per_window = ", ".join(f"{rep.qps:.1f} q/s p50 {rep.latency_ms['p50']:.2f} "
                               f"p99 {rep.latency_ms['p99']:.2f}" for rep in reports)
        print(f"serve {family}: {n_timed} requests in {wall:.3f} s, "
              f"{n_timed / wall:.1f} q/s, p50 {l['p50']:.2f} ms, p99 "
              f"{l['p99']:.2f} ms | windows: {per_window} | "
              f"{st['batches']} micro-batches, {st['retraces']} retraces, "
              f"launches {launches}, "
              f"{checked} replayed identically through serve_batch, max "
              f"|GPU - CPU plain| at top-{TOP_K} {worst:.3g} | "
              f"score phase (score_all of {len(states)} queries x {E} entities) "
              f"{score_ms:.4f} ms | kernel shapes {dict(shapes)}")
        if need is None:
            # Q2B, Q2P and FuzzQE reach no kernel, in the reference as here.
            if any(launches.values()):
                fail(f"{family}: launched {launches}, but its operators reach no kernel")
        else:
            if launches[need] == 0:
                fail(f"{family}: the {need} kernel was never launched")
            # One launch per intersect/union op (BetaE) or per micro-batch's
            # score_all (GQE, ComplEx) of the timed windows, and no other.
            if launches[need] != sum(shapes.values()):
                fail(f"{family}: {launches[need]} {need} launches for "
                     f"{sum(shapes.values())} calls in the recorded batches")
            key = "intersect" if family == "betae" else f"scoring[{model.score_mode}]"
            main_path[key] = (launches[need], shapes)
        del engine, executor, model, params, states
        torch.cuda.empty_cache()

    # ------------------------------------------------- 4b. semantic serving
    def serve_semantic(store):
        """GQE with H_sem served from both layouts, with phase 4's windows.
        Returns, for each layout, the ``gather_fuse`` launches of its timed
        run with a Counter of the (kind, n) they were made at, and its
        ``scoring`` launches with a Counter of their (B, N)."""
        sem_cfg = ModelConfig(semantic_dim=SEM_DIM)
        n_chunks = -(-E // CHUNK)
        per_layout, resident = {}, None
        for layout in ("resident", "out-of-core"):
            model = make_model("gqe", sem_cfg, device=dev)
            executor = PooledExecutor(model, b_max=256, device=dev)
            scfg = ServingConfig(max_batch=16, top_k=TOP_K, record_batches=True)
            seeded = lambda: torch.Generator(device=dev).manual_seed(1)  # noqa: E731
            if layout == "resident":
                table = np.concatenate([rows for _, rows in store.iter_shards()])
                params = model.init_params(seeded(), E, R, semantic_table=table)
                del table
                cache, per_batch = None, 1
                engine = ServingEngine(model, params, executor=executor,
                                       device=dev, cfg=scfg)
            else:
                cache, per_batch = SemanticCache(store, SEM_BUDGET, device=dev), n_chunks
                params = model.init_params(seeded(), E, R, semantic_cache=cache)
                engine = ServingEngine(model, params, executor=executor,
                                       device=dev, cfg=scfg, sem_cache=cache,
                                       sem_rows_fn=store.read_rows)
            with engine:
                run_closed_loop(engine, warmup, concurrency=32)
                engine.reset_counters()
                kops.scoring.launches = kops.intersect.launches = 0
                kops.gather_fuse.launches = 0
                reports = [run_closed_loop(engine, w, concurrency=32) for w in windows]
                torch.cuda.synchronize()
                launches = {"gather_fuse": kops.gather_fuse.launches,
                            "scoring": kops.scoring.launches}
            st = engine.stats()
            log = engine.batch_log
            results = [res for rep in reports for res in rep.results]
            for res in results:
                if (len(res["top_entities"]) != TOP_K
                        or not np.isfinite(np.asarray(res["scores"])).all()):
                    fail(f"semantic {layout}: a result lacks {TOP_K} finite scores")
            if st["failures"]:
                fail(f"semantic {layout}: {st['failures']} requests failed")

            # Launches: one per EMBED op, plus the all-entity fusion (one
            # resident launch, or one per streamed chunk) of every batch;
            # scoring once per batch resident, once per chunk out of core.
            embeds, calls, scored = 0, collections.Counter(), collections.Counter()
            for rec in log:
                for op, _card, pn in executor.prepare(rec.queries).meta:
                    if op == int(OpType.EMBED):
                        embeds += 1
                        calls[("resident" if cache is None else "cache", pn)] += 1
                if cache is None:
                    calls[("resident", E)] += 1
                    scored[(len(rec.queries), E)] += 1
                else:
                    for lo in range(0, E, CHUNK):
                        calls[("chunk", min(CHUNK, E - lo))] += 1
                        scored[(len(rec.queries), min(CHUNK, E - lo))] += 1
            want = embeds + per_batch * len(log)
            if launches["gather_fuse"] == 0 or launches["gather_fuse"] != want:
                fail(f"semantic {layout}: {launches['gather_fuse']} gather_fuse "
                     f"launches for {embeds} EMBED ops and {len(log)} batches "
                     f"({want} expected)")
            if launches["scoring"] != per_batch * len(log):
                fail(f"semantic {layout}: {launches['scoring']} scoring launches "
                     f"for {len(log)} batches")
            per_layout[f"gather_fuse[{layout}]"] = (launches["gather_fuse"], calls)
            per_layout[f"scoring[{model.score_mode}][semantic-{layout}]"
                       if layout == "resident" else
                       f"scoring[{model.score_mode}][{layout}]"] = (launches["scoring"], scored)

            # Replay: resident through serve_batch; out-of-core through
            # serve_batch with a fresh cache and params and the chunked scorer.
            if cache is None:
                oracle = lambda qs: serve_batch(  # noqa: E731
                    model, params, executor, qs, top_k=TOP_K, device=dev)[0]
            else:
                cache2 = SemanticCache(store, SEM_BUDGET, device=dev)
                params2 = model.init_params(seeded(), E, R, semantic_cache=cache2)
                ex2 = PooledExecutor(model, b_max=256, device=dev)
                chunked = lambda p, q: model.score_all_chunked(p, q, store.read_rows)  # noqa: E731
                oracle = lambda qs: serve_batch(  # noqa: E731
                    model, params2, ex2, qs, top_k=TOP_K, device=dev,
                    score_all_fn=chunked, sem_cache=cache2)[0]
            checked = check_against_offline(log, oracle)
            if checked == 0 or checked != sum(r.n_real for r in log):
                fail(f"semantic {layout}: {checked} rows replayed of the "
                     f"recorded batches")

            rec = log[0]
            if cache is None:
                # The first batch against the plain path on the CPU.
                cpu_model = make_model("gqe", sem_cfg, device="cpu")
                cpu_params = params_from_numpy(
                    cpu_model, {k: v.cpu().numpy() for k, v in params.items()})
                cpu_ex = PooledExecutor(cpu_model, b_max=256, device="cpu")
                with torch.no_grad():
                    ref = cpu_model.score_all(
                        cpu_params, cpu_ex.encode(cpu_params, rec.queries)).numpy()
                worst = 0.0
                for i, res in enumerate(rec.results[: rec.n_real]):
                    r_i = ref[i, res["top_entities"]]
                    err = np.abs(r_i - np.asarray(res["scores"]))
                    if (err > 2e-3 + 1e-4 * np.abs(r_i) + 5e-4).any():
                        fail(f"semantic resident: served scores differ from the "
                             f"CPU plain path by {err.max():.3g}")
                    worst = max(worst, float(err.max()))
                agree = f"max |GPU - CPU plain| at top-{TOP_K} {worst:.3g}"
                resident = (model, params, executor)
            else:
                # The first batch's unrounded scores against the resident layout.
                cache3 = SemanticCache(store, SEM_BUDGET, device=dev)
                params3 = model.init_params(seeded(), E, R, semantic_cache=cache3)
                ex3 = PooledExecutor(model, b_max=256, device=dev)
                cache3.apply_to(params3, cache3.plan(
                    np.concatenate([q.anchors for q in rec.queries])))
                ooc = model.score_all_chunked(
                    params3, ex3.encode(params3, rec.queries), store.read_rows)
                r_model, r_params, r_ex = resident
                with torch.no_grad():
                    dense = r_model.score_all(
                        r_params, r_ex.encode(r_params, rec.queries)).cpu().numpy()
                worst = 0.0
                for i, res in enumerate(rec.results[: rec.n_real]):
                    ids = res["top_entities"]
                    err = float(np.abs(ooc[i, ids] - dense[i, ids]).max())
                    if err > 1e-5:
                        fail(f"semantic out-of-core: top-{TOP_K} scores differ "
                             f"from the resident layout's by {err:.3g}")
                    worst = max(worst, err)
                agree = f"max |out-of-core - resident| at top-{TOP_K} {worst:.3g}"
            l = latency_summary([res["latency_ms"] for res in results])
            wall = sum(rep.wall_s for rep in reports)
            per_window = ", ".join(
                f"{rep.qps:.1f} q/s p50 {rep.latency_ms['p50']:.2f} p99 "
                f"{rep.latency_ms['p99']:.2f}" for rep in reports)
            cs = st.get("sem_cache")
            hot = ("hot set n/a" if cs is None else
                   f"hot set hit rate {cs['hit_rate']:.2%}, "
                   f"{cs['rows_staged']} rows staged, {cs['evictions']} evictions")
            print(f"serve gqe+semantic [{layout}]: {n_timed} requests in "
                  f"{wall:.3f} s, {n_timed / wall:.1f} q/s, p50 {l['p50']:.2f} ms, "
                  f"p99 {l['p99']:.2f} ms | windows: {per_window} | "
                  f"{st['batches']} micro-batches, {embeds} EMBED ops, launches "
                  f"{launches} | {hot} | {checked} replayed identically through "
                  f"serve_batch, {agree}")
            del engine
        del resident
        torch.cuda.empty_cache()
        return per_layout

    # The store serves phase 4b and semantic training (5b); it is removed
    # when the script exits, whichever way.
    sem_dir = tempfile.mkdtemp(prefix="chip_smoke_semstore_")
    atexit.register(shutil.rmtree, sem_dir, ignore_errors=True)
    t0 = time.perf_counter()
    store = precompute_semantic_table_to_store(
        kg, sem_dir, StubPTE(PTEConfig(), device=dev))
    print(f"semantic store: {store.n_rows} x {store.dim} {store.quant} in "
          f"{len(list(store.iter_shards()))} shard(s), "
          f"{store.disk_nbytes / 1e6:.1f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s (stub PTE on the card, "
          f"normalisation and neighbour smoothing on the host)")
    main_path.update(serve_semantic(store))

    # ------------------------------------------------------------- 5. train
    tcfg = TrainConfig()
    t0 = time.perf_counter()
    batch_sampler = OnlineSampler(kg, patterns=tcfg.patterns, seed=7)
    batches = [batch_sampler.sample_batch(tcfg.batch_size)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    eval_queries = [b.query for b in OnlineSampler(kg, seed=9).sample_batch(EVAL_QUERIES)]
    print(f"training: TrainConfig() (batch {tcfg.batch_size}, {tcfg.n_negatives} negatives, "
          f"b_max {tcfg.b_max}, {len(tcfg.patterns)} patterns, lr {tcfg.adam.lr}) at "
          f"ModelConfig() (dim {cfg.dim}); {len(batches)} batches and {EVAL_QUERIES} eval "
          f"queries sampled in {time.perf_counter() - t0:.1f} s")
    attn_ops = (int(OpType.INTERSECT), int(OpType.UNION))

    def attn_calls(executor, queries) -> list:
        """The (n, k) of every intersection and union op a training step on
        ``queries`` runs: one plan pooled, one per pattern group query-level."""
        if isinstance(executor, QueryLevelExecutor):
            groups, _ = executor.prepare_groups(queries)
            plans = [executor.prepare(g) for g in groups.values()]
        else:
            plans = [executor.prepare(queries)]
        return [(pn, card) for p in plans for op, card, pn in p.meta if op in attn_ops]

    def check_first_step(family: str, trainer, mcfg=cfg, table=None) -> str:
        """The first step's loss and gradients on the card against the CPU
        path on the same parameters and batch. The loss within rtol 1e-4.
        Each parameter's gradient, norm-wise against the exact (fp64) value
        the CPU path computes: within the CPU parity tests' rtol (1e-4;
        BetaE 1e-3) of its norm, or no further from it than four times the
        CPU path's own fp32 gradient is. Two things keep an elementwise
        tolerance from holding at full width: a few of the millions of
        pre-activations fall within rounding of 0 and take the other side of
        a relu on one device, moving the rows they feed; and the attention
        heads' w2 gradients sum dL/dlogit, which cancels where a pool row's
        inputs are alike, so fp32 rounding on either device is a large share
        of them. How many elements lie beyond the tests' elementwise
        tolerance against the CPU fp32 gradient (rtol, atol 1e-6·max|g|;
        BetaE 1e-4·max|g|), and in how many rows, is reported. The
        softmax-shift-invariant biases, whose exact gradient is 0, lie
        within 1e-6 of the largest gradient. A semantic model (``mcfg``,
        H_sem ``table``) has the batch's rows staged first when it trains
        through a hot set, and the CPU path takes the card's hot set."""
        queries, pos, neg = OnlineSampler(kg, seed=8).to_training_arrays(
            batches[0], tcfg.n_negatives)
        if trainer.sem_cache is not None:
            stage = trainer.sem_cache.plan(batch_entity_ids(queries, pos, neg))
            if stage is not None:
                trainer.sem_cache.apply_to(trainer.params, stage)
        cpu_tr = NGDBTrainer(make_model(family, mcfg, device="cpu"), kg, tcfg,
                             **({} if table is None else {"semantic_table": table}))
        cpu_tr.load_params({k: v.cpu().numpy() for k, v in trainer.params.items()})
        out = []
        for tr, dtype in ((trainer, torch.float32), (cpu_tr, torch.float32),
                          (cpu_tr, torch.float64)):
            tr.params = {k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in tr.params.items()}
            plan = tr.executor.prepare(queries)
            loss, _, grads = tr.loss_and_grads(plan, pos[plan.order], neg[plan.order])
            out.append((float(loss), {k: g.cpu().double() for k, g in grads.items()}))
        (loss, grads), (closs, cgrads), (_, exact) = out
        if not (np.isfinite(loss) and abs(loss - closs) <= 1e-4 * abs(closs)):
            fail(f"train {family}: first-step loss {loss!r} on the card, {closs!r} on the CPU")
        rtol, frac = (1e-3, 1e-4) if family == "betae" else (1e-4, 1e-6)
        top = max(float(g.abs().max()) for g in cgrads.values())
        report, worst = [], (0.0, "", 0.0)
        frozen = trainer.model.frozen_param_names()
        for k, want in cgrads.items():
            got = grads[k]
            if k in frozen:  # H_sem: a (1,) zero token, as the reference gives
                if got.shape != (1,) or got.any():
                    fail(f"train {family}: the frozen {k} got a gradient")
                continue
            if k in ("att_b1", "uatt_b1"):
                if float(got.abs().max()) > 1e-6 * top:
                    fail(f"train {family}: {k}'s gradient {float(got.abs().max()):.3g} is "
                         f"not rounding beside the largest gradient {top:.3g}")
                continue
            norm = float(exact[k].norm())
            err, cpu_err = float((got - exact[k]).norm()), float((want - exact[k]).norm())
            if err > max(rtol * norm, 4 * cpu_err):
                fail(f"train {family}: {k}'s gradient lies {err / norm:.3g} of its norm from "
                     f"the fp64 value, the CPU path's fp32 one {cpu_err / norm:.3g}")
            worst = max(worst, (err / norm, k, cpu_err / norm))
            beyond = (got - want).abs() > frac * float(want.abs().max()) + rtol * want.abs()
            if beyond.any():
                rows = beyond.reshape(beyond.shape[0], -1).any(1).sum()
                report.append(f"{k} {int(beyond.sum())} in {int(rows)} row(s)")
        del cpu_tr
        return (f"first step: loss {loss:.9g} (CPU {closs:.9g}); gradients against fp64 "
                f"norm-wise: the furthest {worst[1]} at {worst[0]:.3g} (CPU fp32 "
                f"{worst[2]:.3g}); beyond the elementwise tolerance against the CPU: "
                f"{', '.join(report) or 'none'}")

    def timed_run(family: str, mode: str) -> tuple:
        """A fresh trainer: warm-up, then TRAIN_STEPS timed steps on fresh
        batches (each step draws its negatives and compiles its plan, as in
        training), with the kernels' counts zeroed just before and read just
        after. Returns the trainer, the launches and the intersect/union
        calls the plans call for."""
        trainer = NGDBTrainer(make_model(family, cfg, device=dev), kg,
                              TrainConfig(executor=mode))
        note = check_first_step(family, trainer) if mode == "pooled" else ""
        trainer.train(TRAIN_WARMUP, log_every=0, batches=batches[:TRAIN_WARMUP])
        torch.cuda.synchronize()
        kops.intersect.launches = kops.intersect_backward.launches = 0
        kops.scoring.launches = 0
        t0 = time.perf_counter()
        losses = [trainer.train_step(b)["loss"] for b in batches[TRAIN_WARMUP:]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"intersect": kops.intersect.launches,
                    "intersect_backward": kops.intersect_backward.launches,
                    "scoring": kops.scoring.launches}
        # After the timed steps, so that they compiled their own plans (every
        # batch is fresh); these prepares find them cached.
        calls = [c for b in batches[TRAIN_WARMUP:]
                 for c in attn_calls(trainer.executor, [x.query for x in b])]
        if not np.isfinite(losses).all():
            fail(f"train {family} {mode}: a loss is not finite: {losses}")
        want = len(calls) if family == "betae" else 0
        if (launches["intersect"], launches["intersect_backward"]) != (want, want):
            fail(f"train {family} {mode}: {launches} for {want} intersection and union "
                 f"ops in the plans")
        if launches["scoring"]:
            fail(f"train {family} {mode}: the loss launched scoring {launches['scoring']} times")
        n_q = TRAIN_STEPS * tcfg.batch_size
        sync_runs[family, mode] = ([r["loss"] for r in trainer.history], wall)
        print(f"train {family} [{mode}]: {TRAIN_STEPS} steps in {wall:.3f} s, "
              f"{TRAIN_STEPS / wall:.2f} steps/s, {n_q / wall:.1f} queries/s | losses "
              f"{losses[0]:.6f} -> {losses[-1]:.6f} ({' '.join(f'{l:.6f}' for l in losses)}) "
              f"| launches {launches}" + (f" | {note}" if note else ""))
        return trainer, launches, collections.Counter(calls)

    sync_runs = {}   # (model, mode) -> (the losses of all its steps, wall of the timed ones)
    train_path = {"intersect": [0, collections.Counter()],
                  "intersect_backward": [0, collections.Counter()]}
    for family in ("betae", "gqe"):
        for mode in ("pooled", "query_level"):
            trainer, launches, pools = timed_run(family, mode)
            if family == "betae":
                for name in train_path:
                    train_path[name][0] += launches[name]
                    train_path[name][1].update(pools)
                print(f"  intersect pools (n, k) of betae [{mode}] training: "
                      f"{dict(sorted(pools.items()))}")
                dim2, hid = 2 * cfg.dim, cfg.dim * cfg.hidden_mult
                for n, k in pools:
                    if (n, k) not in backward_ms:
                        backward_ms[n, k] = measure_intersect_backward(n, k, dim2, hid)["ms"]
                step_ms = sum(c * backward_ms[p] for p, c in pools.items()) / TRAIN_STEPS
                print(f"  intersect_backward: {step_ms:.4f} ms of device time a betae "
                      f"[{mode}] step ({sum(pools.values())} calls over {TRAIN_STEPS} steps, "
                      f"each at its pool's time in phase 3)")
            if mode == "pooled":
                kops.scoring.launches = kops.intersect.launches = 0
                t0 = time.perf_counter()
                metrics = evaluate(trainer.model, trainer.params, trainer.executor, kg,
                                   eval_queries, batch_size=64)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_batches = -(-EVAL_QUERIES // 64)
                if not all(np.isfinite(v) for v in metrics.values()):
                    fail(f"evaluate {family}: {metrics}")
                if family == "gqe":
                    if kops.scoring.launches != n_batches:
                        fail(f"evaluate gqe: {kops.scoring.launches} scoring launches for "
                             f"{n_batches} eval batches")
                    main_path["scoring[l1][evaluate]"] = (
                        kops.scoring.launches, collections.Counter({(64, E): n_batches}))
                print(f"evaluate {family}: {EVAL_QUERIES} queries in {wall:.3f} s, mrr "
                      f"{metrics['mrr']:.5f}, hits@1 {metrics['hits@1']:.5f}, hits@10 "
                      f"{metrics['hits@10']:.5f} | launches scoring {kops.scoring.launches}, "
                      f"intersect {kops.intersect.launches}")
            del trainer
            torch.cuda.empty_cache()
    main_path["intersect[training]"] = tuple(train_path["intersect"])
    main_path["intersect_backward"] = tuple(train_path["intersect_backward"])

    # Two runs of one seed: the same loss bits? (reported, not a gate)
    runs = []
    for _ in range(2):
        tr = NGDBTrainer(make_model("betae", cfg, device=dev), kg, tcfg)
        queries, pos, neg = OnlineSampler(kg, seed=8).to_training_arrays(
            batches[0], tcfg.n_negatives)
        plan = tr.executor.prepare(queries)
        _, _, grads = tr.loss_and_grads(plan, pos[plan.order], neg[plan.order])
        losses = [r["loss"] for r in tr.train(3, log_every=0, batches=batches[:3])]
        runs.append((losses, {k: g.clone() for k, g in grads.items()}))
        del tr
    differ = sorted(k for k in runs[0][1] if not torch.equal(runs[0][1][k], runs[1][1][k]))
    print(f"determinism (betae, two runs of seed 0): loss bits "
          f"{'equal' if runs[0][0] == runs[1][0] else 'differ'} over 3 steps "
          f"({runs[0][0]} vs {runs[1][0]}); first-step gradients that differ bitwise: "
          f"{differ or 'none'}")
    del runs

    for family in ("complex", "q2b", "q2p", "fuzzqe"):
        trainer = NGDBTrainer(make_model(family, cfg, device=dev), kg, tcfg)
        t0 = time.perf_counter()
        losses = [r["loss"] for r in trainer.train(3, log_every=0, batches=batches[:3])]
        torch.cuda.synchronize()
        if not np.isfinite(losses).all():
            fail(f"train {family}: a loss is not finite: {losses}")
        print(f"train {family} [pooled]: 3 steps in {time.perf_counter() - t0:.3f} s, "
              f"losses {' '.join(f'{l:.6f}' for l in losses)}")
        del trainer
        torch.cuda.empty_cache()

    # ------------------------------------------------ 5b. semantic training
    sem_cfg = ModelConfig(semantic_dim=SEM_DIM)
    table = np.concatenate([rows for _, rows in store.iter_shards()])
    budget = training_budget_rows(E, tcfg.batch_size, tcfg.n_negatives)
    n_cand = 1 + tcfg.n_negatives

    def fuse_calls(executor, queries) -> tuple:
        """The n of every gather_fuse call a training step on ``queries``
        makes: one per EMBED op of each plan (its pool), and one for each
        plan's loss (its queries × (1 + K) candidates); one plan pooled, one
        per pattern group query-level. Returns (EMBED pools, loss calls)."""
        if isinstance(executor, QueryLevelExecutor):
            groups, _ = executor.prepare_groups(queries)
            plans = [(executor.prepare(g), len(g)) for g in groups.values()]
        else:
            plans = [(executor.prepare(queries), len(queries))]
        return ([pn for p, _ in plans for op, _c, pn in p.meta if op == int(OpType.EMBED)],
                [b * n_cand for _, b in plans])

    def semantic_run(layout: str, mode: str) -> tuple:
        """Semantic GQE, H_sem ``resident`` or behind a ``hot set`` of the
        launcher's budget staged every step: the first step against the CPU
        path (query-level too: its step's gradient, the groups' weighted by
        their size over B, is the whole batch's mean loss's, which the check
        takes through the executor's plan), warm-up, TRAIN_STEPS timed steps
        with the counts zeroed just before and read just after, then
        ``evaluate``. Returns
        the launches and Counters of the gather_fuse calls' n: EMBED pools
        and loss calls."""
        cache = SemanticCache(store, budget, device=dev) if layout == "hot set" else None
        sem = {"semantic_table": table} if cache is None else {"semantic_cache": cache}
        trainer = NGDBTrainer(make_model("gqe", sem_cfg, device=dev), kg,
                              TrainConfig(executor=mode), **sem)
        note = check_first_step("gqe", trainer, sem_cfg, table)
        trainer.train(TRAIN_WARMUP, log_every=0, batches=batches[:TRAIN_WARMUP])
        torch.cuda.synchronize()
        kops.gather_fuse.launches = kops.gather_fuse_backward.launches = 0
        kops.scoring.launches = 0
        t0 = time.perf_counter()
        losses = [trainer.train_step(b)["loss"] for b in batches[TRAIN_WARMUP:]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"gather_fuse": kops.gather_fuse.launches,
                    "gather_fuse_backward": kops.gather_fuse_backward.launches,
                    "scoring": kops.scoring.launches}
        embeds, loss_calls = collections.Counter(), collections.Counter()
        for b in batches[TRAIN_WARMUP:]:
            e, lc = fuse_calls(trainer.executor, [x.query for x in b])
            embeds.update(e)
            loss_calls.update(lc)
        calls = list((embeds + loss_calls).elements())
        name = f"gqe+semantic [{layout}, {mode}]"
        if not np.isfinite(losses).all():
            fail(f"train {name}: a loss is not finite: {losses}")
        if (launches["gather_fuse"], launches["gather_fuse_backward"]) != (len(calls),) * 2:
            fail(f"train {name}: {launches} for {len(calls)} EMBED ops and loss calls in "
                 f"the plans")
        if launches["scoring"]:
            fail(f"train {name}: the loss launched scoring {launches['scoring']} times")
        hot = ""
        if cache is not None:
            cs = cache.stats()
            hot = (f" | hot set of {budget} rows: hit rate {cs['hit_rate']:.2%}, "
                   f"{cs['rows_staged']} rows staged, {cs['evictions']} evictions")
        n_q = TRAIN_STEPS * tcfg.batch_size
        sync_runs[f"gqe+semantic [{layout}]", mode] = ([r["loss"] for r in trainer.history],
                                                       wall)
        print(f"train {name}: {TRAIN_STEPS} steps in {wall:.3f} s (staging included, "
              f"outside queries_per_sec), {TRAIN_STEPS / wall:.2f} steps/s, "
              f"{n_q / wall:.1f} queries/s | losses {losses[0]:.6f} -> {losses[-1]:.6f} "
              f"({' '.join(f'{l:.6f}' for l in losses)}) | launches {launches}{hot} | {note}")
        # evaluate: resident through score_all, the hot set through the
        # chunked scorer with the eval queries' anchors staged.
        fn = None
        if cache is not None:
            stage = cache.plan(np.concatenate([q.anchors for q in eval_queries]))
            if stage is not None:
                cache.apply_to(trainer.params, stage)
            fn = lambda p, q: trainer.model.score_all_chunked(p, q, store.read_rows)  # noqa: E731
        kops.scoring.launches = kops.gather_fuse.launches = 0
        t0 = time.perf_counter()
        metrics = evaluate(trainer.model, trainer.params, trainer.executor, kg, eval_queries,
                           batch_size=64, score_all_fn=fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_batches = -(-EVAL_QUERIES // 64)
        per_batch_scores = 1 if cache is None else -(-E // CHUNK)
        if not all(np.isfinite(v) for v in metrics.values()):
            fail(f"evaluate {name}: {metrics}")
        if kops.scoring.launches != n_batches * per_batch_scores:
            fail(f"evaluate {name}: {kops.scoring.launches} scoring launches for "
                 f"{n_batches} eval batches")
        print(f"evaluate {name}: {EVAL_QUERIES} queries in {wall:.3f} s, mrr "
              f"{metrics['mrr']:.5f}, hits@10 {metrics['hits@10']:.5f} | launches scoring "
              f"{kops.scoring.launches}, gather_fuse {kops.gather_fuse.launches}")
        del trainer, cache
        torch.cuda.empty_cache()
        return launches, embeds, loss_calls

    print(f"semantic training: GQE at ModelConfig(semantic_dim={SEM_DIM}) with "
          f"TrainConfig(); hot-set budget {budget} rows (launcher's rule)")
    fuse_path = {"gather_fuse[training]": [0, collections.Counter()],
                 "gather_fuse_backward": [0, collections.Counter()]}
    anchor_pools = collections.Counter()
    run_calls = {}  # (layout, mode) -> the gather_fuse calls' n over the timed steps
    for layout, mode in (("resident", "pooled"), ("resident", "query_level"),
                         ("hot set", "pooled")):
        launches, embeds, loss_calls = semantic_run(layout, mode)
        run_calls[layout, mode] = embeds + loss_calls
        for key, counted in (("gather_fuse[training]", "gather_fuse"),
                             ("gather_fuse_backward", "gather_fuse_backward")):
            fuse_path[key][0] += launches[counted]
            fuse_path[key][1].update(embeds + loss_calls)
        anchor_pools.update(embeds)
        print(f"  gather_fuse calls (n: count) of [{layout}, {mode}] over {TRAIN_STEPS} "
              f"steps: EMBED pools {dict(sorted(embeds.items()))}, loss calls "
              f"{dict(sorted(loss_calls.items()))}")
    main_path.update({k: tuple(v) for k, v in fuse_path.items()})
    pool = anchor_pools.most_common(1)[0][0]
    show(f"gather_fuse_backward (commonest anchor pool, n={pool})",
         measure_gather_fuse_backward(pool, "resident", E))
    # The backward's device ms a step: each n the timed runs called it at,
    # timed alone (resident, from the forward's zp; median of 10 with the
    # flush), times its calls, over the steps.
    bwd_ms = {}
    for (layout, mode), calls in run_calls.items():
        for n in sorted(set(calls) - set(bwd_ms)):
            bwd_ms[n] = measure_gather_fuse_backward(n, "resident", E, timing_only=True)["ms"]
        per_step = sum(c * bwd_ms[n] for n, c in calls.items()) / TRAIN_STEPS
        print(f"gather_fuse_backward a step of gqe+semantic [{layout}, {mode}]: "
              f"{per_step:.4f} ms over {sum(calls.values()) / TRAIN_STEPS:.1f} calls a step "
              f"({len(calls)} distinct n, each timed alone)")

    # BetaE with H_sem: three pooled steps, twice from one seed.
    runs = []
    for _ in range(2):
        tr = NGDBTrainer(make_model("betae", sem_cfg, device=dev), kg, tcfg,
                         semantic_table=table)
        runs.append([r["loss"] for r in tr.train(3, log_every=0, batches=batches[:3])])
        del tr
        torch.cuda.empty_cache()
    if not np.isfinite(runs).all():
        fail(f"train betae+semantic: a loss is not finite: {runs}")
    print(f"train betae+semantic [resident, pooled]: 3 steps, losses "
          f"{' '.join(f'{l:.6f}' for l in runs[0])}; two runs of one seed: loss bits "
          f"{'equal' if runs[0] == runs[1] else 'differ'} ({runs[0]} vs {runs[1]})")
    del table

    # ------------------------------------------------ 5c. pipelined training
    counted = ("intersect", "intersect_backward", "gather_fuse", "gather_fuse_backward",
               "scoring")

    def sync_losses(family: str, mcfg, cache=None) -> list:
        """A fresh sync run's losses over the same batches (phase 5's warm-up
        and timed steps in one call): whether two sync runs of one seed agree
        bitwise, asked only when the pipelined run does not."""
        sem = {} if cache is None else {"semantic_cache": cache}
        tr = NGDBTrainer(make_model(family, mcfg, device=dev), kg, tcfg, **sem)
        out = [r["loss"] for r in tr.train(len(batches), log_every=0, batches=batches)]
        del tr
        torch.cuda.empty_cache()
        return out

    def pipelined_run(label: str, family: str, mcfg, layout: str = "") -> dict:
        """``TrainConfig(pipeline=True)`` on the sync run's batches (the warm-up
        and the timed steps in one ``train`` call, so the trainer's sampler
        draws the sync run's negatives), with the kernels' counts zeroed just
        before and read just after. Gates: losses bitwise the sync run's,
        all finite; launches equal to the plans' ops; a hot set staged
        entirely in the background; one more dispatch under
        ``set_sync_debug_mode("error")``. Returns the launches and Counters
        of the calls' shapes."""
        cache = SemanticCache(store, budget, device=dev) if layout == "hot set" else None
        sem = {} if cache is None else {"semantic_cache": cache}
        trainer = NGDBTrainer(make_model(family, mcfg, device=dev), kg,
                              TrainConfig(pipeline=True), **sem)
        torch.cuda.synchronize()
        for name in counted:
            getattr(kops, name).launches = 0
        t0 = time.perf_counter()
        losses = [r["loss"] for r in trainer.train(len(batches), log_every=0,
                                                   batches=batches)]
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {name: getattr(kops, name).launches for name in counted}
        sync, sync_wall = sync_runs[label, "pooled"]
        if not np.isfinite(losses).all():
            fail(f"train {label} [pipelined]: a loss is not finite: {losses}")
        note = "losses bitwise the sync run's"
        if losses != sync:
            again = sync_losses(family, mcfg, None if cache is None else
                                SemanticCache(store, budget, device=dev))
            if again == sync:
                fail(f"train {label} [pipelined]: losses {losses} differ from the sync "
                     f"run's {sync}, and two sync runs agree bitwise")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, sync))
            if rel > 1e-6:
                fail(f"train {label} [pipelined]: losses {rel:.3g} relative from sync's")
            note = (f"two sync runs of one seed differ bitwise here, so held to 1e-6 "
                    f"relative: {rel:.3g}")
        # The kernels' calls over every batch of the run, as phases 5 and 5b
        # count them (after the run: its plans are cached).
        pools = collections.Counter()
        embeds, loss_calls = collections.Counter(), collections.Counter()
        for b in batches:
            queries = [x.query for x in b]
            pools.update(attn_calls(trainer.executor, queries))
            if layout:
                e, lc = fuse_calls(trainer.executor, queries)
                embeds.update(e)
                loss_calls.update(lc)
        n_attn = sum(pools.values()) if family == "betae" else 0
        n_fuse = sum((embeds + loss_calls).values())
        want = {"intersect": n_attn, "intersect_backward": n_attn, "gather_fuse": n_fuse,
                "gather_fuse_backward": n_fuse, "scoring": 0}
        if launches != want:
            fail(f"train {label} [pipelined]: launches {launches}, the plans call for {want}")
        hot = ""
        if cache is not None:
            cs = cache.stats()
            if (cs["stages_background"], cs["sync_stages"],
                    cs["prefetch_overlap_frac"]) != (cs["stages"], 0, 1.0):
                fail(f"train {label} [pipelined]: the hot set was not staged in the "
                     f"background alone: {cs}")
            hot = (f" | hot set: {cs['stages']} stages, all in the background "
                   f"(prefetch_overlap_frac {cs['prefetch_overlap_frac']}), "
                   f"{cs['rows_staged']} rows staged")
        phases = trainer.step_phases
        timed = phases[TRAIN_WARMUP:]
        wall = timed[-1]["t_retired"] - phases[TRAIN_WARMUP - 1]["t_retired"]

        def med(key):
            return statistics.median(p.get(key, 0.0) for p in timed) * 1e3

        def mean(key):   # the thread clock may tick in ms: means, not medians
            return statistics.fmean(p[key] for p in timed) * 1e3

        def share(key):
            return sum(p.get(key, 0.0) for p in timed) / wall

        n_q = TRAIN_STEPS * tcfg.batch_size
        sched = ("sample", "negatives", "sem_prefetch", "schedule", "transfer")
        main_ = ("pipeline_wait", "sem_apply", "dispatch", "retire")
        print(f"train {label} [pooled, pipelined]: {TRAIN_STEPS} steps in {wall:.3f} s "
              f"(retire of step {TRAIN_WARMUP} to step {len(batches)}), "
              f"{TRAIN_STEPS / wall:.2f} steps/s, {n_q / wall:.1f} queries/s against sync "
              f"{TRAIN_STEPS / sync_wall:.2f} steps/s, {n_q / sync_wall:.1f} queries/s | "
              f"bubble (pipeline_wait) {share('pipeline_wait_s'):.1%}, retire "
              f"{share('retire_s'):.1%} of wall | scheduler thread medians (ms): "
              + ", ".join(f"{k} {med(k + '_s'):.3f}" for k in sched)
              + " | main thread medians (ms): "
              + ", ".join(f"{k} {med(k + '_s'):.3f}" for k in main_)
              + f" | thread CPU a step (means, ms): scheduler {mean('scheduler_cpu_s'):.3f}, "
              f"dispatch {mean('dispatch_cpu_s'):.3f}, against {wall / TRAIN_STEPS * 1e3:.3f} "
              f"wall | {note} | launches {launches}{hot} | {len(batches)} steps and "
              f"set-up in {total:.3f} s")
        # One more dispatch with any host sync an error (the retire, which
        # reads the loss back, excluded): the scheduler thread runs beside it.
        pf = trainer._prefetcher(batches)
        try:
            item = pf.next(timeout=120)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss, _ = trainer._dispatch(item)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            pf.next(timeout=120)   # raises if the scheduler thread failed meanwhile
        except RuntimeError as e:
            fail(f"train {label} [pipelined]: a dispatch under "
                 f"set_sync_debug_mode('error') raised: {e!r} ({e.__cause__!r})")
        finally:
            pf.close()
            if cache is not None:
                cache.reconcile()
        if not np.isfinite(float(loss)):
            fail(f"train {label} [pipelined]: the checked dispatch's loss is {float(loss)}")
        print(f"  one pipelined dispatch of {label} under set_sync_debug_mode('error'): "
              f"no host sync")
        if family == "gqe" and not layout:
            kops.scoring.launches = 0
            metrics = evaluate(trainer.model, trainer.params, trainer.executor, kg,
                               eval_queries, batch_size=64)
            n_batches = -(-EVAL_QUERIES // 64)
            if kops.scoring.launches != n_batches or not all(
                    np.isfinite(v) for v in metrics.values()):
                fail(f"evaluate {label} after pipelined training: {metrics}, "
                     f"{kops.scoring.launches} scoring launches for {n_batches} batches")
            launches["scoring"] = kops.scoring.launches
            print(f"evaluate {label} after pipelined training: mrr {metrics['mrr']:.5f}, "
                  f"hits@10 {metrics['hits@10']:.5f} | scoring launches "
                  f"{kops.scoring.launches}")
        del trainer, cache
        torch.cuda.empty_cache()
        return {"launches": launches, "pools": pools, "fuse": embeds + loss_calls,
                "losses": losses}

    pipelined_losses = {}   # label -> the run's losses, for phase 8's traced rerun
    print(f"pipelined training: TrainConfig(pipeline=True) (prefetch {tcfg.prefetch}, "
          f"max_inflight {tcfg.max_inflight}, gil_switch_interval "
          f"{tcfg.gil_switch_interval}) on the sync runs' {len(batches)} batches")
    for label, family, mcfg, layout in (("betae", "betae", cfg, ""), ("gqe", "gqe", cfg, ""),
                                        ("gqe+semantic [hot set]", "gqe", sem_cfg,
                                         "hot set")):
        r = pipelined_run(label, family, mcfg, layout)
        pipelined_losses[label] = r["losses"]
        grown = {"intersect[training]": ("intersect", r["pools"]),
                 "intersect_backward": ("intersect_backward", r["pools"]),
                 "gather_fuse[training]": ("gather_fuse", r["fuse"]),
                 "gather_fuse_backward": ("gather_fuse_backward", r["fuse"]),
                 "scoring[l1][evaluate]": ("scoring", None)}
        for key, (name, shapes) in grown.items():
            if r["launches"][name]:
                n, counter = main_path[key]
                main_path[key] = (n + r["launches"][name],
                                  counter + shapes if shapes else counter)

    # --------------------------------------------- 7. the live serving tier
    # On phase 4's graph, which it writes to (nothing after it samples the
    # graph). Its launches are added to the kernels line of 6.
    from repro_torch.core import MaterializedSubqueryCache
    from repro_torch.semantic import SemanticStore, SemanticStoreWriter
    from repro_torch.serving import (LiveNGDB, ReplicaPool, Router, RouterConfig,
                                     StaleVersionError, TenantLoad, TenantSpec,
                                     run_tenant_mix)
    from repro_torch.training import incremental_finetune

    t7 = time.perf_counter()
    live_launches = collections.Counter()   # main-path key -> phase 7 launches
    wrng = np.random.default_rng(70)

    def strip(res) -> dict:
        return {k: v for k, v in res.items() if k not in ("latency_ms", "batch_size")}

    def fresh_triples(n: int, lo: int = 0) -> np.ndarray:
        """``n`` triples absent from the graph, heads drawn from [lo, E)."""
        out = np.empty((0, 3), np.int64)
        while len(out) < n:
            m = 4 * n
            cand = np.stack([wrng.integers(lo, kg.n_entities, m),
                             wrng.integers(0, kg.n_relations, m),
                             wrng.integers(0, kg.n_entities, m)], axis=1)
            out = np.unique(np.concatenate([out, cand[~kg.contains(cand)]]), axis=0)
        return out[wrng.permutation(len(out))[:n]]

    def unique_fresh(n_per_pattern: int, seen: set) -> list:
        """Fresh mixed queries, one per key, none of whose keys is in ``seen``
        (so the materialized cache holds no row for them)."""
        out = []
        for q in mixed(n_per_pattern):
            if q.key() not in seen:
                seen.add(q.key())
                out.append(q)
        return out

    def live_loop(engine, qs, pin_every: int = 4, max_lag: int = 6,
                  concurrency: int = 32):
        """A closed loop of ``concurrency`` in flight; every ``pin_every``-th
        request pinned to a graph version up to ``max_lag`` behind. Each
        request is served or shed with ``StaleVersionError`` (at admission or
        at execute time); anything else raises. Returns (results, sheds,
        wall seconds)."""
        window, results, shed = collections.deque(), [], 0
        t0 = time.perf_counter()

        def settle(f):
            nonlocal shed
            try:
                results.append(f.result(timeout=120))
            except StaleVersionError:
                shed += 1

        for i, q in enumerate(qs):
            while len(window) >= concurrency:
                settle(window.popleft())
            pin = None
            if i % pin_every == pin_every - 1:
                pin = max(0, engine.graph_version - int(wrng.integers(0, max_lag + 1)))
            try:
                window.append(engine.submit(q, pin_version=pin))
            except StaleVersionError:
                shed += 1
        while window:
            settle(window.popleft())
        return results, shed, time.perf_counter() - t0

    def pinned_replay(label, engine, model, mat, version, qs) -> int:
        """Serve ``qs`` (fresh keys) pinned to ``version``: every recorded
        batch must replay bitwise through ``serve_batch`` on the params and
        entity count the engine retained for that version. Every row is a
        cache miss (checked), so each batch encodes exactly its composition."""
        p_v, n_v = engine.params_at(version)
        hits0 = mat.stats()["hits"]
        engine.batch_log = []
        engine.cfg.record_batches = True
        try:
            futs = [engine.submit(q, pin_version=version) for q in qs]
            res = [f.result(timeout=120) for f in futs]
        finally:
            engine.cfg.record_batches = False
        if mat.stats()["hits"] != hits0:
            fail(f"{label}: the pinned replay's fresh queries hit the materialized cache")
        ex_o = PooledExecutor(model, b_max=256, device=dev)
        checked = check_against_offline(
            engine.batch_log,
            lambda b: serve_batch(model, p_v, ex_o, b, top_k=TOP_K, device=dev,
                                  n_entities=n_v)[0])
        if checked != len(qs):
            fail(f"{label}: {checked} of {len(qs)} pinned rows replayed")
        engine.batch_log = []
        return res

    def rows_against_fresh(label, model, params, mat, qs, gv) -> float:
        """The cache's rows for ``qs`` (keyed at graph version ``gv``)
        against one fresh no-cache encode of all of them: the largest
        difference (0.0 = bitwise), held to the encode tolerance."""
        keys = [q.key() + (gv,) for q in qs]
        got = mat.lookup(keys)
        if len(got) != len(qs):
            fail(f"{label}: {len(got)} of {len(qs)} rows resident in the cache")
        rows = torch.stack([got[i] for i in range(len(qs))])
        with torch.no_grad():
            want = PooledExecutor(model, b_max=256, device=dev).encode(params, qs)
        diff = float((rows - want).abs().max())
        if not torch.allclose(rows, want, rtol=2e-4, atol=2e-5):
            fail(f"{label}: cached rows differ from a fresh encode by {diff:.3g}")
        return diff

    def same_params(label, served, sync) -> None:
        for k in sync:
            if not torch.equal(served[k], sync[k]):
                d = float((served[k] - sync[k]).abs().max())
                fail(f"{label}: the background fine-tune's {k} differs from a sync "
                     f"rerun by {d:.3g}")

    def live_engine(model, params, mat):
        return ServingEngine(
            model, params, executor=PooledExecutor(model, b_max=256, device=dev),
            device=dev, kg=kg, mat_cache=mat,
            cfg=ServingConfig(max_batch=16, top_k=TOP_K, max_staleness_versions=4))

    seen = set()
    # (a) GQE, live: 8 bursts of 64 fresh triples from a writer thread under
    # a closed loop of 32; burst 4 adds 16 entities. Burst 8 starts from
    # flushed params, recorded for the sync rerun.
    model = make_model("gqe", cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(71),
                               kg.n_entities, kg.n_relations)
    mat = MaterializedSubqueryCache(2048)
    mat.watch_kg(kg)
    engine = live_engine(model, params, mat)
    live = LiveNGDB(model, kg, engine, finetune_steps=4, n_negatives=8, seed=0)
    warm = mixed(4)
    work = mixed(107)      # 1,498 requests
    seen.update(q.key() for q in warm + work)
    bursts = [fresh_triples(64) for _ in range(8)]
    n0 = kg.n_entities
    new_ids = np.arange(n0, n0 + 16)
    grow = bursts[3]
    grow[:32, 0] = np.repeat(new_ids, 2)            # the new ids as heads
    grow[32:48, 2] = new_ids                        # and as tails
    rec = {}
    with engine:
        run_closed_loop(engine, warm, concurrency=32)
        engine.reset_counters()
        kops.scoring.launches = 0

        def writer():
            for b, triples in enumerate(bursts):
                time.sleep(0.02)
                if b == 7:
                    live.flush()
                    rec["p_in"] = engine.params
                r = live.write(triples, n_new_entities=16 if b == 3 else 0)
                rec[b] = r

        wt = threading.Thread(target=writer, name="chip-smoke-writer")
        wt.start()
        served, shed, wall = live_loop(engine, work)
        wt.join()
        live.flush()
        torch.cuda.synchronize()
        a_scoring = kops.scoring.launches
        st = engine.stats()
        final = engine.params
        if len(served) + shed != len(work) or st["failures"]:
            fail(f"live gqe: {len(served)} served + {shed} shed of {len(work)}, "
                 f"{st['failures']} failures")
        for res in served:
            if len(res["top_entities"]) != TOP_K or not np.isfinite(res["scores"]).all():
                fail(f"live gqe: a result lacks {TOP_K} finite scores: {res}")
        if kg.n_entities != n0 + 16 or model.n_entities != n0 + 16:
            fail(f"live gqe: {kg.n_entities} entities after growing {n0} by 16")
        if a_scoring == 0:
            fail("live gqe: the scoring kernel was never launched")
        live_launches["scoring[l1]"] += a_scoring
        # The version after burst 4, four writes behind: still in bound.
        v4 = rec[3].graph_version
        pinned_qs = unique_fresh(2, seen)
        first = pinned_replay("live gqe", engine, model, mat, v4, pinned_qs)
        again = [engine.submit(q, pin_version=v4).result(timeout=120) for q in pinned_qs]
        if [strip(r) for r in again] != [strip(r) for r in first]:
            fail("live gqe: the pinned replay served from cached rows differs")
        p_v4, _ = engine.params_at(v4)
        row_diff = rows_against_fresh("live gqe", model, p_v4, mat, pinned_qs, v4)
        sync, _ = incremental_finetune(model, rec["p_in"], rec[7].fresh_triples, steps=4,
                                       lr=live.finetune_lr, n_negatives=8,
                                       seed=live.seed + rec[7].graph_version)
        same_params("live gqe", final, sync)
        # Duplicate-heavy replay: 512 requests over 32 distinct queries.
        engine.reset_counters()
        dup = [warm[i] for i in wrng.integers(0, 32, 512)]
        dup_rep = run_closed_loop(engine, dup, concurrency=32)
        dup_hit = engine.stats()["mat_cache"]["hit_rate"]
        live.close()
    lat = latency_summary([r["latency_ms"] for r in served])
    ft = [s * 1e3 for s in live.finetune_s]
    print(f"live gqe: {len(work)} requests through 8 write bursts (64 triples each, "
          f"burst 4 adding 16 entities) in {wall:.3f} s, {len(served) / wall:.1f} q/s "
          f"served, p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms | {len(served)} served, "
          f"{shed} shed as stale (StaleVersionError) | version lag served "
          f"{dict(sorted(st['version_lag_served'].items()))} | graph version "
          f"{st['graph_version']} | background fine-tune ms a burst (4 Adam steps, 8 "
          f"negatives): median {statistics.median(ft):.1f}, each "
          f"{[round(x, 1) for x in ft]} | pinned replay at version {v4} "
          f"({len(pinned_qs)} queries) bitwise through serve_batch on its retained "
          f"params, again from cached rows bitwise | cached rows against a fresh "
          f"encode: max |diff| {row_diff:.3g} | served params after flush bitwise a "
          f"sync rerun of burst 8 | duplicate-heavy replay (512 over 32 queries): "
          f"mat hit rate {dup_hit:.2%}, {dup_rep.qps:.1f} q/s | scoring launches "
          f"{a_scoring}")
    del engine, live, model, params, final, sync, mat
    torch.cuda.empty_cache()

    # (b) BetaE, live: 2 bursts, no growth.
    model = make_model("betae", cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(72),
                               kg.n_entities, kg.n_relations)
    mat = MaterializedSubqueryCache(2048)
    mat.watch_kg(kg)
    engine = live_engine(model, params, mat)
    live = LiveNGDB(model, kg, engine, finetune_steps=4, n_negatives=8, seed=1)
    warm, work = mixed(2), mixed(24)
    seen.update(q.key() for q in warm + work)
    with engine:
        run_closed_loop(engine, warm, concurrency=32)
        engine.reset_counters()
        kops.intersect.launches = 0
        v0 = kg.graph_version
        rb = {}

        def writer_b():
            for b in range(2):
                time.sleep(0.1)
                rb[b] = live.write(fresh_triples(64))

        wt = threading.Thread(target=writer_b, name="chip-smoke-writer")
        wt.start()
        served, shed, wall = live_loop(engine, work)
        wt.join()
        live.flush()
        torch.cuda.synchronize()
        b_intersect = kops.intersect.launches
        st = engine.stats()
        if len(served) + shed != len(work) or st["failures"]:
            fail(f"live betae: {len(served)} served + {shed} shed of {len(work)}")
        if b_intersect == 0:
            fail("live betae: the intersect kernel was never launched")
        live_launches["intersect"] += b_intersect
        pinned_qs = unique_fresh(2, seen)
        pinned_replay("live betae", engine, model, mat, v0 + 1, pinned_qs)
        p_v, _ = engine.params_at(v0 + 1)
        b_diff = rows_against_fresh("live betae", model, p_v, mat, pinned_qs, v0 + 1)
        live.close()
    lat = latency_summary([r["latency_ms"] for r in served])
    print(f"live betae: {len(work)} requests through 2 bursts in {wall:.3f} s, "
          f"{len(served) / wall:.1f} q/s served, p50 {lat['p50']:.2f} ms, p99 "
          f"{lat['p99']:.2f} ms, {shed} shed as stale | version lag served "
          f"{dict(sorted(st['version_lag_served'].items()))} | fine-tune ms "
          f"{[round(s * 1e3, 1) for s in live.finetune_s]} | pinned replay at "
          f"version {v0 + 1} bitwise through serve_batch | cached rows against a "
          f"fresh encode: max |diff| {b_diff:.3g} | intersect launches {b_intersect}")
    del engine, live, model, params, mat
    torch.cuda.empty_cache()

    # (c) Semantic GQE, resident H_sem (d_l 1024, its own store), live: one
    # burst grows 16 entities with their semantic rows (the store appends
    # them), then a second burst checks the fine-tune against a sync rerun.
    live_dir = tempfile.mkdtemp(prefix="chip_smoke_livestore_")
    atexit.register(shutil.rmtree, live_dir, ignore_errors=True)
    n_c = kg.n_entities
    table_c = (wrng.standard_normal((n_c, SEM_DIM), dtype=np.float32)
               / np.float32(np.sqrt(SEM_DIM)))
    writer_c = SemanticStoreWriter(live_dir, dim=SEM_DIM, shard_rows=CHUNK)
    writer_c.append(table_c)
    writer_c.finalize()
    store_c = SemanticStore(live_dir)
    old_rows = store_c.read_rows(np.arange(n_c))
    model = make_model("gqe", sem_cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(73), n_c,
                               kg.n_relations, semantic_table=table_c)
    del table_c
    mat = MaterializedSubqueryCache(2048)
    mat.watch_kg(kg)
    engine = live_engine(model, params, mat)
    live = LiveNGDB(model, kg, engine, store=store_c, finetune_steps=4, n_negatives=8,
                    seed=2)
    warm, work = mixed(1), mixed(8)
    with engine:
        run_closed_loop(engine, warm, concurrency=32)
        kops.gather_fuse.launches = 0
        kops.gather_fuse_backward.launches = 0
        kops.scoring.launches = 0
        g = fresh_triples(64)
        g[:32, 0] = np.repeat(np.arange(n_c, n_c + 16), 2)
        sem_new = wrng.standard_normal((16, SEM_DIM), dtype=np.float32) / np.float32(32.0)
        rc = {}

        def writer_c_():
            time.sleep(0.05)
            rc[0] = live.write(g, n_new_entities=16, sem_rows=sem_new)

        wt = threading.Thread(target=writer_c_, name="chip-smoke-writer")
        wt.start()
        served, shed, wall = live_loop(engine, work)
        wt.join()
        live.flush()
        if (store_c.n_rows, kg.n_entities) != (n_c + 16, n_c + 16):
            fail(f"live gqe+semantic: store {store_c.n_rows} rows, graph "
                 f"{kg.n_entities} entities after growing {n_c} by 16")
        if not np.array_equal(store_c.read_rows(np.arange(n_c)), old_rows):
            fail("live gqe+semantic: rows read before the append changed")
        if not np.array_equal(store_c.read_rows(np.arange(n_c, n_c + 16)), sem_new):
            fail("live gqe+semantic: the appended rows read back differently")
        p_in = engine.params
        r2 = live.write(fresh_triples(64))
        live.flush()
        torch.cuda.synchronize()
        c_fuse, c_bwd = kops.gather_fuse.launches, kops.gather_fuse_backward.launches
        live_launches["scoring[l1][semantic-resident]"] += kops.scoring.launches
        if c_fuse == 0 or c_bwd == 0:
            fail(f"live gqe+semantic: gather_fuse {c_fuse}, gather_fuse_backward "
                 f"{c_bwd} launches during the fine-tunes")
        live_launches["gather_fuse[resident]"] += c_fuse
        live_launches["gather_fuse_backward"] += c_bwd
        sync, _ = incremental_finetune(model, p_in, r2.fresh_triples, steps=4,
                                       lr=live.finetune_lr, n_negatives=8,
                                       seed=live.seed + r2.graph_version)
        same_params("live gqe+semantic", engine.params, sync)
        st = engine.stats()
        if len(served) + shed != len(work) or st["failures"]:
            fail(f"live gqe+semantic: {len(served)} served + {shed} shed of {len(work)}")
        live.close()
    print(f"live gqe+semantic (resident, d_l {SEM_DIM}): {len(work)} requests in "
          f"{wall:.3f} s, {len(served) / wall:.1f} q/s served, {shed} shed as stale, "
          f"through a burst growing 16 entities (store {n_c} -> {store_c.n_rows} rows, "
          f"old rows bitwise) and a second burst | fine-tune ms "
          f"{[round(s * 1e3, 1) for s in live.finetune_s]} | served params bitwise a "
          f"sync rerun | gather_fuse {c_fuse}, gather_fuse_backward {c_bwd}, scoring "
          f"{live_launches['scoring[l1][semantic-resident]']} launches")
    del engine, live, model, params, sync, p_in, mat
    torch.cuda.empty_cache()

    # (d) Two replicas on the card behind a router: a warm replay with no
    # retrace, then a hot swap under a high-priority stream and a
    # low-priority flood.
    model = make_model("gqe", cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(74)
    params_a = model.init_params(gen, kg.n_entities, kg.n_relations)
    params_b = {k: v.clone() for k, v in params_a.items()}
    params_b["entity"] = params_b["entity"] * 1.5
    pool = ReplicaPool(model, params_a, n_replicas=2, mat_budget_rows=1024, device=dev,
                       cfg=ServingConfig(max_batch=16, top_k=TOP_K, record_batches=True))
    router = Router(pool, tenants=[TenantSpec("gold", "high"), TenantSpec("bronze", "low")],
                    cfg=RouterConfig(spill_depth=8, spill_width=1))
    with router:
        warm = mixed(16)
        for _ in range(2):
            pool.reset_counters(clear_log=True)
            for f in router.submit_many(warm, tenant="gold"):
                f.result(timeout=120)
        retraces = pool.retraces()
        if any(retraces.values()):
            fail(f"router: steady-state retraces on a warm replay {retraces}")
        pool.reset_counters(clear_log=True)
        kops.scoring.launches = 0
        gold = unique_fresh(32, seen)
        bronze = unique_fresh(16, seen)
        done0 = {rid: r.stats()["completed"] for rid, r in pool.replicas().items()}
        reports = {}
        bt = threading.Thread(target=lambda: reports.update(run_tenant_mix(
            router, [TenantLoad("bronze", bronze, qps=0.0)])), name="chip-smoke-bronze")
        t0 = time.perf_counter()
        bt.start()
        half = len(gold) // 2
        pre = [router.submit(q, tenant="gold") for q in gold[:half]]
        router.update_params(params_b)
        post = [router.submit(q, tenant="gold") for q in gold[half:]]
        got_pre = [f.result(timeout=120) for f in pre]
        got_post = [f.result(timeout=120) for f in post]
        bt.join()
        wall_d = time.perf_counter() - t0
        torch.cuda.synchronize()
        d_scoring = kops.scoring.launches
        logs = [rec_ for r in pool.replicas().values() for rec_ in r.engine.batch_log]
        version_of = {id(res): rec_.params_version
                      for rec_ in logs for res in rec_.results[: rec_.n_real]}
        if any(version_of.get(id(r)) != 0 for r in got_pre):
            fail("router: a request admitted before the swap was not served on the old params")
        if any(version_of.get(id(r)) != 1 for r in got_post):
            fail("router: a request admitted after the swap was not served on the new params")
        ex_o = PooledExecutor(model, b_max=256, device=dev)
        oracle = {v: (lambda b, p=p: serve_batch(model, p, ex_o, b, top_k=TOP_K,
                                                 device=dev)[0])
                  for v, p in ((0, params_a), (1, params_b))}
        checked = sum(check_against_offline([rec_], oracle[rec_.params_version])
                      for rec_ in logs)
        b_rep = reports.get("bronze")
        st = router.stats()
        if b_rep is None or b_rep.failures or st["tenants"]["bronze"]["shed"]["quota"]:
            fail(f"router: the low-priority flood did not finish cleanly: {b_rep}")
        if b_rep.shed != st["tenants"]["bronze"]["shed"]["backpressure"]:
            fail(f"router: {b_rep.shed} typed sheds seen, {st['tenants']['bronze']['shed']} counted")
        if d_scoring == 0:
            fail("router: the scoring kernel was never launched")
        live_launches["scoring[l1]"] += d_scoring
        per_rep = {rid: r.stats()["completed"] - done0[rid]
                   for rid, r in pool.replicas().items()}
    print(f"router: 2 replicas on one card, warm replay of {len(warm)} with retraces "
          f"{retraces}; hot swap with {half} gold requests admitted before it (all "
          f"served on the old params) and {len(gold) - half} after (on the new), "
          f"{checked} rows replayed bitwise through serve_batch on the params each "
          f"batch ran on | bronze flood: {b_rep.completed} served, {b_rep.shed} shed "
          f"(ShedError, submit p99 {b_rep.submit_ms['p99']:.3f} ms) | per replica "
          + ", ".join(f"{rid}: {n} requests, {n / wall_d:.1f} q/s" for rid, n in per_rep.items())
          + f" | aggregate {sum(per_rep.values()) / wall_d:.1f} q/s over {wall_d:.3f} s "
          f"| spilled {st['spilled']} | scoring launches {d_scoring}")
    del router, pool, model, params_a, params_b
    torch.cuda.empty_cache()
    for key, n in live_launches.items():
        if key in main_path:
            k_n, counter = main_path[key]
            main_path[key] = (k_n + n, counter)
    print(f"live serving tier: launches {dict(live_launches)} added to the kernels "
          f"line | phase 7 in {time.perf_counter() - t7:.1f} s")

    # ------------------------------------------------ 8. telemetry on the card
    phase8(torch, dev, kops, main_path, batches, tcfg, cfg, sem_cfg, store, budget,
           sem_dir, pipelined_losses)

    # ------------------------------------------------- 6. the kernels line
    entries = []
    for key, (launches, shapes) in main_path.items():
        shape = shapes.most_common(1)[0][0]
        if key == "gather_fuse_backward":
            r = measure_gather_fuse_backward(shape, "resident", E)
            # No Pallas counterpart: the reference differentiates its jnp
            # fuse_semantic. This is the gradient of gather_fuse's TPU kernel.
            src, replaces = ("gather_fuse_backward.cu",
                             "src/repro/kernels/gather_fuse.py:77 (its gradient)")
        elif key.startswith("gather_fuse"):
            # Training's calls are counted by n alone, and timed resident: a
            # hot set of E rows only renames the rows' slots.
            layout, n = shape if isinstance(shape, tuple) else ("resident", shape)
            r = measure_gather_fuse(n, cfg.dim, SEM_DIM, cfg.semantic_proj_dim,
                                    "float32", layout, E)
            src, replaces = "gather_fuse.cu", "src/repro/kernels/gather_fuse.py:77"
        elif key in ("intersect", "intersect[training]"):
            n, k = shape
            r = measure_intersect(n, k, 2 * cfg.dim, cfg.dim * cfg.hidden_mult,
                                  "float32", detail=True)
            src, replaces = "intersect.cu", "src/repro/kernels/intersect.py:50"
        elif key == "intersect_backward":
            n, k = shape
            r = measure_intersect_backward(n, k, 2 * cfg.dim, cfg.dim * cfg.hidden_mult)
            # No Pallas counterpart: the reference differentiates its jnp
            # path. This is the gradient of the row above's TPU kernel.
            src, replaces = ("intersect_backward.cu",
                             "src/repro/kernels/intersect.py:50 (its gradient)")
        else:
            mode = key[len("scoring["):].split("]")[0]
            B, N = shape
            r = measure_scoring(mode, B, N, cfg.dim, "float32", detail=True)
            src, replaces = "scoring.cu", "src/repro/kernels/scoring.py:48"
        show(f"{key} (main path)", r)
        entries.append({"name": key, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces, "launches": launches, **r})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def phase8(torch, dev, kops, main_path, batches, tcfg, cfg, sem_cfg, store, budget,
           sem_dir, pipelined_losses) -> None:
    """Telemetry on the card (module docstring, 8): the instrumented training
    and serving CLIs through their ``main(argv)`` in this process, so the
    kernels' launch counters see them; the traced pipelined rerun of phase
    5c's batches; the enabled overhead and the device time under each span
    name. Launches are added to ``main_path``."""
    import contextlib
    import io
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import OpType, PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import make_model
    from repro_torch.obs import TRACER, read_jsonl, validate_trace
    from repro_torch.obs.report import cache_tables, summarize_trace
    from repro_torch.obs.report import main as report_main
    from repro_torch.sampling import OnlineSampler
    from repro_torch.semantic import SemanticCache
    from repro_torch.serving import ServingConfig, ServingEngine
    from repro_torch.training import NGDBTrainer, TrainConfig

    t8 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    atexit.register(shutil.rmtree, str(work), ignore_errors=True)
    counted = ("intersect", "intersect_backward", "gather_fuse", "gather_fuse_backward",
               "scoring")
    added = collections.Counter()   # main-path key -> phase 8 launches

    def counts() -> dict:
        return {name: getattr(kops, name).launches for name in counted}

    def zero() -> None:
        for name in counted:
            getattr(kops, name).launches = 0

    def run(label: str, fn, argv) -> str:
        """One CLI's ``main(argv)``; its standard output kept and echoed."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                fn(argv)
        except Exception as e:
            print(buf.getvalue())
            fail(f"phase 8 {label}: the CLI raised {e!r}")
        print(f"phase 8 {label}: python -m {fn.__module__} {' '.join(argv)} "
              f"({time.perf_counter() - t0:.1f} s)")
        for line in buf.getvalue().splitlines():
            print(f"  | {line}")
        torch.cuda.empty_cache()
        return buf.getvalue()

    def check_trace(label: str, path: str, lanes, names):
        with open(path) as f:
            obj = json.load(f)
        try:
            summary = validate_trace(obj)
        except ValueError as e:
            fail(f"phase 8 {label}: the trace does not validate: {e}")
        missing = (set(lanes) - set(summary["lanes"])) | (set(names) - set(summary["names"]))
        if missing:
            fail(f"phase 8 {label}: the trace lacks {sorted(missing)} (lanes "
                 f"{summary['lanes']}, names {summary['names']})")
        return obj

    def check_metrics(label: str, trace: str, path: str, steps: int) -> None:
        recs = read_jsonl(path)
        step = [r for r in recs if r["kind"] == "step"]
        snaps = [r for r in recs if r["kind"] == "snapshot"]
        if len(step) != steps or len(snaps) != 1 or any(
                r["mode"] != "pipelined" or not r["wall_s"] > 0
                or not 0.0 <= r["bubble_frac"] <= 1.0 for r in step):
            fail(f"phase 8 {label}: {len(step)} step records (want {steps} pipelined, "
                 f"bubble_frac in [0, 1], wall_s > 0) and {len(snaps)} snapshots")
        if cache_tables(snaps[0]["metrics"]).startswith("caches: no"):
            fail(f"phase 8 {label}: the snapshot has no hit/miss pairs")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            report_main(["--trace", trace, "--metrics", path])
        out = buf.getvalue()
        if not all(x in out for x in ("trace: ", f"metrics: {steps} step records", "caches:")):
            fail(f"phase 8 {label}: the report lacks a section:\n{out}")
        print(f"  python -m repro_torch.obs.report --trace {Path(trace).name} --metrics "
              f"{Path(path).name}:")
        for line in out.splitlines():
            print(f"  | {line}")

    # (a) Training: the CLI's pipelined runs, each dispatch's launches held
    # to what its plan calls for (the wrapper reads the counters; it does not
    # synchronize).
    attn_ops = (int(OpType.INTERSECT), int(OpType.UNION))

    def attn_expect(plan) -> dict:
        n = sum(op in attn_ops for op, _c, _n in plan.meta)
        return {"intersect": n, "intersect_backward": n}

    def fuse_expect(plan) -> dict:
        n = sum(op == int(OpType.EMBED) for op, _c, _n in plan.meta) + 1   # + the loss
        return {"gather_fuse": n, "gather_fuse_backward": n}

    expect, per_step = {}, []
    plain_dispatch = NGDBTrainer._dispatch

    def counted_dispatch(self, item):
        before = counts()
        out = plain_dispatch(self, item)
        got = {k: v - before[k] for k, v in counts().items()}
        want = dict.fromkeys(counted, 0)
        want.update(expect["fn"](item.prepared))
        per_step.append((got, want))
        return out

    train_args = ["--dim", str(cfg.dim), "--batch-size", str(tcfg.batch_size),
                  "--negatives", str(tcfg.n_negatives), "--lr", str(tcfg.adam.lr),
                  "--log-every", "0", "--pipeline"]

    def train_run(label, argv, steps, ckpt, fn, trace=None, metrics=None):
        per_step.clear()
        expect["fn"] = fn
        zero()
        obs = [] if trace is None else ["--trace", trace, "--metrics", metrics]
        out = run(label, train_cli.main, argv + train_args + ["--steps", str(steps),
                                                             "--ckpt-dir", ckpt] + obs)
        launches = counts()
        bad = [(g, w) for g, w in per_step if g != w]
        if len(per_step) != steps or bad or not any(sum(w.values()) for _, w in per_step):
            fail(f"phase 8 {label}: {len(per_step)} dispatches for {steps} steps; "
                 f"first mismatch (launched, the plan's) {bad[:1]}")
        print(f"  {steps} dispatches, each launching what its plan calls for; launches "
              f"over the run (evaluate included) {launches}")
        return out, launches

    NGDBTrainer._dispatch = counted_dispatch
    try:
        t1, m1 = str(work / "betae.trace.json"), str(work / "betae.metrics.jsonl")
        ck = str(work / "ckpt_betae")
        _, l1 = train_run("(a) BetaE", ["--model", "betae"], 12, ck, attn_expect, t1, m1)
        check_trace("(a) BetaE", t1, ("main dispatch", "pipeline scheduler"),
                    ("pipeline_wait", "dispatch", "retire", "sample", "schedule",
                     "transfer", "prepared_q_depth"))
        check_metrics("(a) BetaE", t1, m1, 12)
        out, l2 = train_run("(a) BetaE, resumed", ["--model", "betae"], 16, ck, attn_expect)
        if "resumed from checkpoint at step 12" not in out:
            fail("phase 8 (a) BetaE: the second run did not resume at step 12")
        for lc in (l1, l2):
            added["intersect[training]"] += lc["intersect"]
            added["intersect_backward"] += lc["intersect_backward"]
        sem_args = ["--model", "gqe", "--semantic-store", sem_dir,
                    "--semantic-dim", str(store.dim)]
        t3, m3 = str(work / "sem.trace.json"), str(work / "sem.metrics.jsonl")
        ck = str(work / "ckpt_sem")
        out, l3 = train_run("(a) GQE+H_sem [hot set]", sem_args, 8, ck, fuse_expect, t3, m3)
        if "semantic store: reusing" not in out:
            fail("phase 8 (a) GQE+H_sem: the CLI did not reuse phase 4b's store")
        check_trace("(a) GQE+H_sem", t3, ("main dispatch", "pipeline scheduler"),
                    ("pipeline_wait", "sem_apply", "dispatch", "retire", "sample",
                     "sem_prefetch", "schedule", "transfer", "prepared_q_depth"))
        check_metrics("(a) GQE+H_sem", t3, m3, 8)
        out, l4 = train_run("(a) GQE+H_sem, resumed", sem_args, 4, ck, fuse_expect)
        if "resumed from checkpoint at step 8" not in out:
            fail("phase 8 (a) GQE+H_sem: the second run did not resume at step 8")
        for lc in (l3, l4):
            added["gather_fuse[training]"] += lc["gather_fuse"]
            added["gather_fuse_backward"] += lc["gather_fuse_backward"]
            added["scoring[l1][out-of-core]"] += lc["scoring"]   # evaluate, chunked
    finally:
        NGDBTrainer._dispatch = plain_dispatch

    # (b) No perturbation: phase 5c's batches, pipelined, traced (the
    # record_function bridge on), on phase 4's graph generated afresh (phase
    # 7 wrote to the first one).
    kg0 = generate_synthetic_kg(*FB15K, seed=0, name="FB15k-shaped")
    for label, family, mcfg, hot in (("betae", "betae", cfg, False),
                                     ("gqe+semantic [hot set]", "gqe", sem_cfg, True)):
        def fresh():
            sem = {"semantic_cache": SemanticCache(store, budget, device=dev)} if hot else {}
            return NGDBTrainer(make_model(family, mcfg, device=dev), kg0,
                               TrainConfig(pipeline=True), **sem)

        trainer = fresh()
        zero()
        TRACER.enable()
        try:
            losses = [r["loss"] for r in trainer.train(len(batches), log_every=0,
                                                       batches=batches)]
            obj = TRACER.to_json()
        finally:
            TRACER.disable()
        launched = counts()
        validate_trace(obj)
        want = pipelined_losses[label]
        note = "bitwise phase 5c's untraced losses"
        if losses != want:
            again = [r["loss"] for r in fresh().train(len(batches), log_every=0,
                                                      batches=batches)]
            if again == want:
                fail(f"phase 8 (b) {label}: tracing changes the losses: {losses} "
                     f"against {want}, and an untraced rerun gives phase 5c's bits")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
            if rel > 1e-6:
                fail(f"phase 8 (b) {label}: traced losses {rel:.3g} relative from 5c's")
            note = (f"two untraced runs differ bitwise here, so held to 1e-6 relative: "
                    f"{rel:.3g}")
        pf = trainer._prefetcher(batches)
        TRACER.enable()
        try:
            item = pf.next(timeout=120)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss, _ = trainer._dispatch(item)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            pf.next(timeout=120)
        except RuntimeError as e:
            fail(f"phase 8 (b) {label}: a traced dispatch under "
                 f"set_sync_debug_mode('error') raised: {e!r} ({e.__cause__!r})")
        finally:
            TRACER.disable()
            pf.close()
            if trainer.sem_cache is not None:
                trainer.sem_cache.reconcile()
        if not np.isfinite(float(loss)):
            fail(f"phase 8 (b) {label}: the traced dispatch's loss is {float(loss)}")
        for name in counted:
            key = {"intersect": "intersect[training]",
                   "gather_fuse": "gather_fuse[training]"}.get(name, name)
            if name != "scoring":
                added[key] += launched[name]
        print(f"phase 8 (b) {label}: {len(losses)} pipelined steps traced "
              f"({len(obj['traceEvents'])} events), {note}; one traced dispatch under "
              f"set_sync_debug_mode('error'): no host sync")
        del trainer, pf
        torch.cuda.empty_cache()
    TRACER.disable()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with TRACER.span("probe"):
            pass
    ns = (time.perf_counter() - t0) / n * 1e9
    if ns > 2000:
        fail(f"phase 8 (b): a disabled span costs {ns:.0f} ns a call (gate 2 us)")
    print(f"phase 8 (b): a disabled TRACER.span() costs {ns:.1f} ns a call "
          f"(mean over one pass of {n} calls; gate 2,000 ns)")

    # (c) Serving, out of core through the store, then two replicas behind the
    # router, each with its own trace. The hot set holds 256 rows, fewer than
    # the workload's anchors, so the traced replay reads the store too (the
    # default 2,048 would keep every anchor of the warm-up resident).
    t2, m2 = str(work / "serve.trace.json"), str(work / "serve.metrics.jsonl")
    zero()
    run("(c) GQE+H_sem out of core", serve_cli.main,
        ["--model", "gqe", "--semantic-store", sem_dir, "--semantic-budget-rows", "256",
         "--requests", "448", "--trace", t2, "--metrics", m2])
    launched = counts()
    obj = check_trace("(c) out of core", t2, ("client 0", "serving batcher"),
                      ("request", "batch", "sem_prefetch", "store_io", "encode", "score",
                       "select", "serving_queue_depth"))
    begins = sum(e["ph"] == "b" and e["name"] == "request" for e in obj["traceEvents"])
    if begins != 448:
        fail(f"phase 8 (c) out of core: {begins} request spans for 448 requests")
    if not launched["scoring"] or not launched["gather_fuse"]:
        fail(f"phase 8 (c) out of core: launches {launched}")
    snap = read_jsonl(m2)
    if [r["kind"] for r in snap] != ["snapshot"]:
        fail(f"phase 8 (c) out of core: the metrics file holds {len(snap)} records")
    added["gather_fuse[out-of-core]"] += launched["gather_fuse"]
    added["scoring[l1][out-of-core]"] += launched["scoring"]
    print(f"  448 request spans balanced; launches {launched}")
    for line in summarize_trace(obj, top=10).splitlines():
        print(f"  | {line}")
    t4, m4 = str(work / "tier.trace.json"), str(work / "tier.metrics.jsonl")
    zero()
    out = run("(c) two replicas", serve_cli.main,
              ["--model", "gqe", "--requests", "448", "--replicas", "2",
               "--tenants", "gold:high,bronze:low", "--priority-mix", "gold=0.25,bronze=0.75",
               "--trace", t4, "--metrics", m4])
    launched = counts()
    obj = check_trace("(c) two replicas", t4,
                      ("tenant gold", "tenant bronze", "replica 0 batcher", "replica 1 batcher"),
                      ("route", "request", "batch", "encode", "score", "select"))
    tenants = re.findall(r"\[tenant (\w+)\] offered (\d+) .*?completed (\d+), shed (\d+), "
                         r"failed (\d+)", out)
    if len(tenants) != 2:
        fail(f"phase 8 (c) two replicas: tenant reports {tenants}")
    offered = sum(int(t[1]) for t in tenants)
    served = sum(int(t[2]) + int(t[4]) for t in tenants)
    ev = obj["traceEvents"]
    routes = sum(e["ph"] == "X" and e["name"] == "route" for e in ev)
    begins = sum(e["ph"] == "b" and e["name"] == "request" for e in ev)
    rejected = sum(e["ph"] == "e" and e.get("args", {}).get("rejected", False) for e in ev)
    if routes != offered or begins != served + rejected:
        fail(f"phase 8 (c) two replicas: {routes} route spans for {offered} offered, "
             f"{begins} request spans for {served} served or failed and {rejected} "
             f"rejected at a full queue")
    if not launched["scoring"]:
        fail(f"phase 8 (c) two replicas: launches {launched}")
    added["scoring[l1]"] += launched["scoring"]
    print(f"  {routes} route spans ({offered} offered), {begins} request spans "
          f"({served} served or failed + {rejected} rejected at a full queue; the rest "
          f"shed by the router before admission); launches {launched}")

    # (d) Printed, not gated: the enabled overhead (annotations off, paired
    # passes through one warmed trainer, the median of the on/off ratios) ...
    trainer = NGDBTrainer(make_model("betae", cfg, device=dev), kg0, TrainConfig(pipeline=True))
    zero()
    trainer.train(len(batches), log_every=0, batches=batches)
    ratios, per = [], {False: [], True: []}
    steps = 10
    for trial in range(6):
        pair = {}
        for on in ((False, True) if trial % 2 == 0 else (True, False)):
            if on:
                TRACER.enable(profiler_annotations=False)
            else:
                TRACER.disable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(steps, log_every=0, batches=batches)
            torch.cuda.synchronize()
            pair[on] = time.perf_counter() - t0
            per[on].append(pair[on] / steps * 1e3)
        ratios.append(pair[True] / pair[False])
    TRACER.disable()
    l_over = counts()
    added["intersect[training]"] += l_over["intersect"]
    added["intersect_backward"] += l_over["intersect_backward"]
    print(f"phase 8 (d) enabled tracing overhead, pipelined BetaE (TrainConfig(), one "
          f"warmed trainer, {steps}-step passes, annotations off): on/off ratios "
          + ", ".join(f"{r:.4f}" for r in ratios)
          + f" | median {statistics.median(ratios):.4f} | ms a step off "
          + ", ".join(f"{x:.2f}" for x in per[False]) + " | on "
          + ", ".join(f"{x:.2f}" for x in per[True]))
    del trainer
    torch.cuda.empty_cache()

    # ... and the device time under each span name, from torch.profiler with
    # the bridge on. Spans are attributed the kernels whose launching op
    # starts inside them, on any thread (autograd runs the backward on its
    # own), so nested spans each hold their children's kernels.
    def split(label: str, prof, names) -> None:
        events = prof.events()
        spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
                 if e.name in names and e.device_type == DeviceType.CPU]
        missing = set(names) - {n for n, _, _ in spans}
        if missing:
            fail(f"phase 8 (d) {label}: the profile's user annotations lack "
                 f"{sorted(missing)}")
        by, total = dict.fromkeys(names, 0.0), 0.0
        for e in events:
            us = sum(k.duration for k in e.kernels)
            if not us:
                continue
            total += us
            for name, a, b in spans:
                if a <= e.time_range.start <= b:
                    by[name] += us
        host = {name: sum(b - a for n_, a, b in spans if n_ == name) for name in names}
        if total == 0:
            print(f"phase 8 (d) {label}: spans {sorted(names)} in the profile; device "
                  f"time not measured (the profiler recorded no device activity)")
            return
        print(f"phase 8 (d) {label}: device ms under each span (host ms of the span) | "
              + ", ".join(f"{n_} {by[n_] / 1e3:.3f} ({host[n_] / 1e3:.3f})" for n_ in names)
              + f" | all device activity {total / 1e3:.3f} ms")

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    trainer = NGDBTrainer(make_model("betae", cfg, device=dev), kg0, TrainConfig())
    for b in batches[:2]:
        trainer.train_step(b)
    zero()
    TRACER.enable()
    TRACER.set_lane("main dispatch")
    try:
        with profile(activities=activities) as prof:
            trainer.train_step(batches[2])
            torch.cuda.synchronize()
    finally:
        TRACER.disable()
    launched = counts()
    added["intersect[training]"] += launched["intersect"]
    added["intersect_backward"] += launched["intersect_backward"]
    split("one pooled BetaE step (sync, batch 512)", prof, ("schedule", "dispatch", "retire"))
    del trainer
    model = make_model("gqe", cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(80), kg0.n_entities,
                               kg0.n_relations)
    engine = ServingEngine(model, params, executor=PooledExecutor(model, b_max=256, device=dev),
                           cfg=ServingConfig(max_batch=16, top_k=TOP_K), device=dev,
                           started=False)
    queries = [q.query for q in OnlineSampler(kg0, seed=81).sample_batch(16)]

    def one_batch() -> None:
        """The batcher loop on this thread (the profiler records this
        thread's annotations): one size flush of 16, then it returns."""
        engine._stop.clear()
        futures = engine.submit_many(queries)
        engine._stop.set()
        engine._run()
        for f in futures:
            f.result(timeout=120)

    one_batch()
    zero()
    TRACER.enable()
    try:
        with profile(activities=activities) as prof:
            one_batch()
            torch.cuda.synchronize()
    finally:
        TRACER.disable()
    added["scoring[l1]"] += counts()["scoring"]
    split("one GQE micro-batch of 16", prof, ("batch", "encode", "score", "select"))
    engine.close()
    del engine, model, params
    torch.cuda.empty_cache()

    unknown = set(added) - set(main_path)
    if unknown:
        fail(f"phase 8: launches for keys the kernels line does not have: {sorted(unknown)}")
    for key, n in added.items():
        k_n, counter = main_path[key]
        main_path[key] = (k_n + n, counter)
    print(f"telemetry: launches {dict(added)} added to the kernels line | phase 8 in "
          f"{time.perf_counter() - t8:.1f} s")


if __name__ == "__main__":
    main()
